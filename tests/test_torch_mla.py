"""deepseek-v3-671b in the port against the reference on its ``.smoke()``
config (MLA at ranks 64/64 and head dims 32 + 16 and 32, one dense prefix
block, 2 MoE layers of 8 experts, top-2, and a shared expert; the MTP
head) in float32 on the CPU: the same numpy params in both packages
(``convert.from_jax_params``), the same inputs (numpy, from seeds).

The router's steps are set for its pinned 8 bits in both packages (its
weights' range over 127, and ROUTER_SA for its input), as in
``tests/test_torch_moe_method.py``: at the raw init the router reads its
input on a handful of 4-bit levels and two experts tie often, and a tie
is broken by the float summation order, which differs between XLA and
PyTorch.  The whole-model comparisons record the smallest top-k margin of
every routing in the port (``router_margins``) and assert it above
MIN_MARGIN, so that they test the port and not a tie.

Tolerances, each with its reason:
  - the config's fields, the policy's units (names, tensors, params, MACs,
    pinned bits) and cache units (MLA's pinned at 16 bits, 64 + 16
    elements a token) exactly;
  - ``mla_apply`` in train and prefill, and prefill plus two absorbed
    decode steps over a float32 cache, within 1e-5 * max|ref| (float32
    sums in other orders; the decode logits are float32 einsums in both);
  - the whole model's prefill logits within 1e-5 * max|ref|;
  - packed params and the fake-quant layout byte-equal, resident bytes
    exact;
  - 16 greedy tokens equal to the JAX packed engine's;
  - ``loss_fn``'s loss and ``mtp_loss`` within 1e-5 relative, and the
    gradients of MLA's projections, the shared expert and the MTP
    projection within ||dg|| / ||g|| <= 1e-3 (``tests/test_torch_train.py``).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.core.metrics import eagl as jeagl  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import EngineSpec as JSpec  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import quantize_for_serving as jquantize  # noqa: E402
from repro.serve import residency as jres  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core.metrics import eagl as teagl  # noqa: E402
from repro_torch.core.policy import CACHE_FULL_BITS  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (EngineSpec, ServeEngine,  # noqa: E402
                               kv_cache, pack_params, quantize_for_serving,
                               residency)
from test_torch_serve import _compare_packed  # noqa: E402
from test_torch_zoo_serve import BF16, cpu_card  # noqa: E402,F401

NAME = "deepseek-v3-671b"
ROUTER_SA = 1.0 / 32
MIN_MARGIN = 1e-5
MAX_SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def router_margins():
    """The smallest non-zero top-k margin of each routing the port makes,
    appended to a list (``tests/test_torch_moe_method.py``'s)."""
    margins, real = [], tmlp.route

    def spy(logits, k):
        out = real(logits, k)
        top = torch.topk(out[0].detach(), k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        margins.append(float(torch.where(gap > 0, gap, 1.0).min()))
        return out
    tmlp.route = spy
    try:
        yield margins
    finally:
        tmlp.route = real


@pytest.fixture(scope="module")
def mla():
    """Both packages' smoke config, params from JAX's jitted init at
    PRNGKey(0) with the router's steps at its pinned 8 bits carried
    across, the uniform policy and a mixed one (knapsack at 0.6 on
    synthetic gains)."""
    jcfg = configs.get_config(NAME).smoke()
    cfg = get_config(NAME).smoke()
    # jitted: the same init formulas, a tenth of the eager init's time
    jparams = jax.jit(jtf.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    moe_p = jparams["pat"]["p0"]["moe"]
    w = moe_p["router"]["w"]
    router = dict(moe_p["router"],
                  sw=jnp.max(jnp.abs(w), axis=(1, 2)) / 127.0,
                  sa=jnp.full_like(moe_p["router"]["sa"], ROUTER_SA))
    jparams = dict(jparams, pat={"p0": dict(jparams["pat"]["p0"],
                                            moe=dict(moe_p, router=router))})
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jpol, tpol = jtf.build_policy(jcfg), ttf.build_policy(cfg)
    jtake = jk.select_for_budget(jpol, jk.synthetic_gains(jpol), 0.6).take
    ttake = tk.select_for_budget(tpol, tk.synthetic_gains(tpol), 0.6).take
    assert ttake == jtake
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "tparams": tparams,
            "jpol": jpol, "tpol": tpol,
            "arrays": {"uniform": (jpol.as_arrays(), tpol.as_arrays()),
                       "mixed": (jpol.apply_selection(jtake).as_arrays(),
                                 tpol.apply_selection(ttake).as_arrays())}}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_config_and_policy_match_jax(mla):
    """The published config's and ``.smoke()``'s fields (MLA, the prefix,
    the shared expert, MTP) are the reference's; every unit and cache unit
    of the policy, and the mixed policy's arrays, are the reference's."""
    for want, got in ((configs.get_config(NAME), get_config(NAME)),
                      (mla["jcfg"], mla["cfg"])):
        for f in ("name", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "n_repeats", "norm", "activation", "rope",
                  "n_experts", "top_k", "n_shared_experts", "q_lora_rank",
                  "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim",
                  "mtp", "mtp_weight"):
            assert getattr(got, f) == getattr(want, f), f
        for blocks in ("prefix", "pattern"):
            assert [(b.mixer, b.ffn, b.d_ff) for b in getattr(got, blocks)] \
                == [(b.mixer, b.ffn, b.d_ff) for b in getattr(want, blocks)]
    jp, tp = mla["jpol"], mla["tpol"]
    assert [(u.name, u.tensors, u.n_params, u.macs_per_token, u.in_features,
             u.sub, u.pinned_bits) for u in tp.units] == [
        (u.name, tuple(u.tensors), u.n_params, u.macs_per_token,
         u.in_features, u.sub, u.pinned_bits) for u in jp.units]
    assert [(c.name, c.group, c.layer, c.kv_elems_per_token, c.pinned_bits)
            for c in tp.cache_units] == [
        (c.name, c.group, c.layer, c.kv_elems_per_token, c.pinned_bits)
        for c in jp.cache_units]
    cfg = mla["cfg"]
    assert {c.name for c in tp.cache_units} == {
        "prefix0.cache.L0", "pat0.cache.L0", "pat0.cache.L1"}
    assert all(c.pinned_bits == CACHE_FULL_BITS and c.kv_elems_per_token
               == cfg.kv_lora_rank + cfg.qk_rope_dim
               for c in tp.cache_units)
    assert {"prefix0.attn_q_a.L0", "prefix0.attn_kv_b.L0",
            "pat0.mlp_gateup.L1"} <= {u.name for u in tp.units}
    ja, ta = mla["arrays"]["mixed"]
    assert set(ta) == set(ja)
    for group in ja:
        assert set(ta[group]) == set(ja[group])
        for slot in ja[group]:
            np.testing.assert_array_equal(ta[group][slot], ja[group][slot])
    jc, tc = jp.cache_bits_arrays(), tp.cache_bits_arrays()
    assert set(tc) == set(jc)
    for group in jc:
        np.testing.assert_array_equal(tc[group], jc[group])


def _mla_pair(mla, layer):
    """Block ``layer``'s MLA params of both packages and its bits (the
    mixed policy): "prefix0", or a pattern layer index."""
    ja, ta = mla["arrays"]["mixed"]
    if layer == "prefix0":
        jp = mla["jparams"]["prefix0"]["attn"]
        tp = mla["tparams"]["prefix0"]["attn"]
        jb = {k: jnp.asarray(v[0]) for k, v in ja["prefix0"].items()}
        return jp, tp, jb, ttf.prefix_bits(ta, 0)
    jp = jax.tree.map(lambda a: a[layer], mla["jparams"]["pat"]["p0"]["attn"])
    tp = mla["tparams"]["pat"][layer]["p0"]["attn"]
    jb = {k: jnp.asarray(v[layer]) for k, v in ja["pat0"].items()}
    return jp, tp, jb, ttf.layer_bits(ta, mla["cfg"], layer)[0]


def _x(cfg, seed, b=2, s=12):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("layer", ["prefix0", 1])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_apply_matches_jax(mla, mode, layer):
    """``mla_apply`` in train and prefill mode, on the prefix block's
    weights and a pattern layer's: the output, and in prefill the latent
    cache (c_kv and k_rope, in the cache dtype)."""
    jcfg = mla["jcfg"].replace(cache_dtype=jnp.float32)
    cfg = mla["cfg"].replace(cache_dtype=torch.float32)
    jp, tp, jb, tb = _mla_pair(mla, layer)
    x = _x(cfg, 7)
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape[:2]).astype(np.int32)
    want_y, want_c = jattn.mla_apply(jp, jnp.asarray(x), jb, jcfg, mode, None,
                                     jnp.asarray(pos))
    with torch.no_grad():
        got_y, got_c = tattn.mla_apply(tp, torch.from_numpy(x), tb, cfg, mode,
                                       None, torch.from_numpy(pos).long())
    _close(got_y.numpy(), want_y)
    if mode == "train":
        assert got_c is None and want_c is None
        return
    assert set(got_c) == set(want_c) == {"c_kv", "k_rope"}
    for k in got_c:
        _close(got_c[k].numpy(), want_c[k])


def test_mla_absorbed_decode_matches_jax(mla):
    """A prefill of 10 of 12 rows spliced into float32 (B, MAX_SEQ)
    latent buffers, then two absorbed decode steps at positions 10 and 11
    (and a third request's slot idle at MAX_SEQ, which writes nothing):
    each step's output and the updated cache against the reference's."""
    jcfg = mla["jcfg"].replace(cache_dtype=jnp.float32)
    cfg = mla["cfg"].replace(cache_dtype=torch.float32)
    jp, tp, jb, tb = _mla_pair(mla, 0)
    x = _x(cfg, 8, b=3)
    s_pre = 10
    pos = np.broadcast_to(np.arange(s_pre), (3, s_pre)).astype(np.int32)
    _, jpre = jattn.mla_apply(jp, jnp.asarray(x[:, :s_pre]), jb, jcfg,
                              "prefill", None, jnp.asarray(pos))
    jcache = jattn.init_mla_cache(jcfg, 3, MAX_SEQ)
    jcache = {k: jcache[k].at[:, :s_pre].set(jpre[k]) for k in jcache}
    tcache = tattn.init_mla_cache(cfg, 3, MAX_SEQ, torch.float32, "cpu")
    with torch.no_grad():
        _, tpre = tattn.mla_apply(tp, torch.from_numpy(x[:, :s_pre]), tb, cfg,
                                  "prefill", None,
                                  torch.from_numpy(pos).long())
        for k in tcache:
            tcache[k][:, :s_pre] = tpre[k]
        for i in range(2):
            p = np.array([[s_pre + i], [s_pre + i], [MAX_SEQ]], np.int32)
            xi = x[:, s_pre + i:s_pre + i + 1]
            want_y, jcache = jattn.mla_apply(jp, jnp.asarray(xi), jb, jcfg,
                                             "decode", jcache, jnp.asarray(p))
            got_y, tcache = tattn.mla_apply(tp, torch.from_numpy(xi), tb, cfg,
                                            "decode", tcache,
                                            torch.from_numpy(p).long())
            _close(got_y.numpy(), want_y)
            for k in tcache:
                _close(tcache[k].numpy(), jcache[k])
    assert float(tcache["c_kv"][2, s_pre:].abs().max()) == 0


def _tokens(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def test_model_prefill_matches_jax(mla):
    """The whole model (the MLA prefix block with its SwiGLU, then two MLA
    blocks of routed experts and the shared expert) in prefill mode on raw
    params under the mixed policy: every position's logits, and each
    layer's latent cache; every routing clear of a tie."""
    ja, ta = mla["arrays"]["mixed"]
    tok = _tokens(3)
    want, jc, _ = jax.jit(lambda p, pa, t: jtf.apply(
        p, pa, {"tokens": t}, mla["jcfg"], local_context(),
        mode="prefill"))(mla["jparams"], jax.tree.map(jnp.asarray, ja),
                         jnp.asarray(tok))
    with router_margins() as margins, torch.no_grad():
        got, tc = ttf.apply(mla["tparams"], ta, torch.from_numpy(tok).long(),
                            mla["cfg"], mode="prefill")
    assert len(margins) == mla["cfg"].n_repeats
    assert min(margins) > MIN_MARGIN, margins
    _close(got.numpy(), want)
    assert set(tc) == {"prefix0", "pat"}
    for mine, ref in ((tc["prefix0"], jc["prefix0"]),
                      (tc["pat"][1]["p0"],
                       jax.tree.map(lambda a: a[1], jc["pat"]["p0"]))):
        for k in ("c_kv", "k_rope"):
            _close(mine[k].float().numpy(),
                   np.asarray(ref[k]).astype(np.float32), 1e-2)


def test_pack_and_fake_quant_layouts_byte_equal(mla):
    """The mixed policy's packed tree (MLA's projections, the prefix, the
    shared expert and the MTP projection at 4 bits) equals the reference's
    ``pack_params(..., layout="unrolled")`` leaf for leaf, resident bytes
    too; the fake-quant layout equals ``quantize_for_serving``'s; EAGL's
    gains over the prefix, MLA and expert units equal the reference's."""
    ja, ta = mla["arrays"]["mixed"]
    want = jpack(mla["jparams"], ja, mla["jcfg"], layout="unrolled")
    got = pack_params(mla["tparams"], ta, mla["cfg"], device="cpu")
    assert _compare_packed(want, got) > 0
    assert residency.resident_bytes(got) == jres.resident_bytes(want)
    assert got["mtp"]["proj"].bits == 4
    assert got["prefix0"]["attn"]["wkv_a"].bits == int(
        ta["prefix0"]["attn_q_a"][0])
    shared = got["pat"][1]["p0"]["moe"]["shared"]["down"]
    assert shared.bits == int(ta["pat0"]["mlp_down"][1])
    fq_want = from_jax_params(jax.tree.map(np.asarray, jquantize(
        mla["jparams"], jax.tree.map(jnp.asarray, ja), mla["jcfg"])),
        device="cpu")
    fq_got = quantize_for_serving(mla["tparams"], ta, mla["cfg"],
                                  device="cpu")
    assert _compare_packed(fq_want, fq_got) > 0
    jg = jeagl.eagl_gains(mla["jpol"], lambda u, t: jtf.fetch_unit_tensor(
        mla["jparams"], u, t), impl="ref")
    tg = teagl.eagl_gains(mla["tpol"], lambda u, t: ttf.fetch_unit_tensor(
        mla["tparams"], u, t))
    assert set(tg) == set(jg) and any(k.startswith("prefix0.") for k in tg)
    for k in jg:
        assert abs(tg[k] - jg[k]) <= 1e-6 * abs(jg[k]), k


def test_greedy_matches_jax(mla):
    """16 greedy tokens of two prompts of 12 and 7 tokens under the mixed
    policy: the port's packed engine over the full cache gives the JAX
    packed engine's; over an int8 ``cache_bits`` the latent stays full
    precision (the policy pins it), so it gives the same tokens, and the
    cache holds (64 + 16) elements a token a layer in the compute dtype."""
    ja, ta = mla["arrays"]["mixed"]
    cfg = mla["cfg"]
    prompt = _tokens(20, s=12)
    lengths = np.array([12, 7], np.int32)
    jeng = JEngine(cfg=mla["jcfg"], params=jpack(mla["jparams"], ja,
                                                 mla["jcfg"]),
                   policy_arrays=jax.tree.map(jnp.asarray, ja),
                   ctx=local_context(), max_seq=MAX_SEQ,
                   spec=JSpec(weights="packed", cache="full"))
    want = np.asarray(jeng.generate(jnp.asarray(prompt), n_new=16,
                                    lengths=jnp.asarray(lengths)))
    packed = pack_params(mla["tparams"], ta, cfg, device="cpu")
    for cache in ("full", "quantized"):
        eng = ServeEngine(cfg, packed, ta, MAX_SEQ,
                          EngineSpec(cache=cache, cache_bits=8),
                          device="cpu")
        with router_margins() as margins:
            got = eng.generate(prompt, 16, lengths=lengths)
        assert min(margins) > MIN_MARGIN, (cache, min(margins))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=cache)
    c = eng.new_cache(2)
    n_layers = len(cfg.prefix) + cfg.n_repeats
    assert residency.resident_kv_bytes(c) == (
        n_layers * 2 * MAX_SEQ * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4)
    assert all(leaf.dtype == torch.float32 for leaf in (
        c.layers["prefix0"]["c_kv"], c.layers["pat"][1]["p0"]["k_rope"]))
    spliced = kv_cache.write_slot(c, {"prefix0": {
        "c_kv": torch.ones((1, 3, cfg.kv_lora_rank)),
        "k_rope": torch.ones((1, 3, cfg.qk_rope_dim))}, "pat": [
            {"p0": {"c_kv": torch.ones((1, 3, cfg.kv_lora_rank)),
                    "k_rope": torch.ones((1, 3, cfg.qk_rope_dim))}}] * 2},
        slot=1, length=3)
    assert int(spliced.lengths[1]) == 3
    assert float(spliced.layers["prefix0"]["c_kv"][1, :3].min()) == 1.0
    assert float(spliced.layers["prefix0"]["c_kv"][0].abs().max()) == 0.0


def _flat_grads(tree, paths):
    out = []
    for path in paths:
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


GRAD_PATHS = (
    [("prefix0", "attn", w, "w") for w in ("wq_a", "wkv_a", "wq_b", "wk_b",
                                           "wv_b", "wo")]
    + [("prefix0", "attn", "wq_a", "sw"), ("prefix0", "attn", "wkv_a", "sa"),
       ("prefix0", "mlp", "down", "w")]
    + [("pat", 1, "p0", "attn", w, "w") for w in ("wq_a", "wk_b", "wv_b")]
    + [("pat", 1, "p0", "moe", "shared", w, k) for w in ("gate", "up",
                                                          "down")
       for k in ("w", "sw", "sa")]
    + [("mtp", "proj", k) for k in ("w", "sw", "sa")]
    + [("mtp", "norm", "scale"), ("embed", "w")])


def _jax_path(path):
    """A port path -> the reference's (a pattern layer is an index into
    the stacked leaf)."""
    if path[0] == "pat":
        return ("pat",) + path[2:], path[1]
    return path, None


def test_loss_mtp_and_grads_match_jax(mla):
    """``loss_fn`` under the mixed policy: the loss (cross entropy, aux and
    0.3 x the MTP loss) and ``mtp_loss`` against the reference's, and the
    gradients of MLA's projections (weights and steps), the shared
    expert's, the MTP head's and the embedding's against ``jax.grad``."""
    cfg, jcfg = mla["cfg"], mla["jcfg"]
    ja, ta = mla["arrays"]["mixed"]
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    jpa = jax.tree.map(jnp.asarray, ja)
    jb = jax.tree.map(jnp.asarray, batch)
    (want, wm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jpa, jb, jcfg, local_context()),
        has_aux=True))(mla["jparams"])
    tparams = from_jax_params(jax.tree.map(np.asarray, mla["jparams"]),
                              device="cpu")
    leaves = _flat_grads(tparams, GRAD_PATHS)
    for leaf in leaves:
        leaf.requires_grad_(True)
    with router_margins() as margins:
        got, gm = ttf.loss_fn(tparams, ta, {
            k: torch.from_numpy(v).long() for k, v in batch.items()}, cfg)
    assert min(margins) > MIN_MARGIN, margins
    assert float(gm["mtp_loss"]) > 0
    for a, b in ((got.detach(), want), (gm["mtp_loss"], wm["mtp_loss"]),
                 (gm["aux_loss"].detach(), wm["aux_loss"])):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    grads = torch.autograd.grad(got, leaves)
    for path, g in zip(GRAD_PATHS, grads):
        jpath, layer = _jax_path(path)
        w = jgrads
        for k in jpath:
            w = w[k]
        w = np.asarray(w if layer is None else w[layer], np.float64)
        g = g.double().numpy()
        assert g.shape == w.shape, path
        assert np.linalg.norm(w) > 0, path
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), path


def test_convert_round_trip_and_cache(mla):
    """``to_jax_tree`` gives back the reference's tree (the prefix block,
    the stacked pattern with its shared expert, the MTP head) leaf for
    leaf; ``from_jax_cache`` turns the reference's latent caches into the
    port's layout (``init_caches``' keys and shapes)."""
    from repro_torch.convert import from_jax_cache, to_jax_tree
    back = to_jax_tree(mla["tparams"])
    want = jax.tree.map(np.asarray, mla["jparams"])
    assert {"prefix0", "mtp"} <= set(back)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)
    jcfg = mla["jcfg"].replace(cache_dtype=jnp.float32)
    jc = jax.tree.map(np.asarray, jtf.init_caches(jcfg, 2, MAX_SEQ))
    jc["prefix0"]["c_kv"] = np.ones_like(jc["prefix0"]["c_kv"])
    got = from_jax_cache(jc, [3, 5], device="cpu")
    mine = ttf.init_caches(mla["cfg"], 2, MAX_SEQ, torch.float32, "cpu")
    assert set(got.layers) == set(mine) == {"prefix0", "pat"}
    for a, b in ((got.layers["prefix0"], mine["prefix0"]),
                 (got.layers["pat"][1]["p0"], mine["pat"][1]["p0"])):
        assert {k: v.shape for k, v in a.items()} == {
            k: v.shape for k, v in b.items()}
    assert float(got.layers["prefix0"]["c_kv"].min()) == 1.0
    assert got.lengths.tolist() == [3, 5]


def test_paged_and_quantized_latent_refused(mla):
    """A paged layout refuses MLA (the reference's ValueError) at the
    spec, the engine and ``init_caches``; int4 cache bits leave the latent
    at full precision, as the policy pins it."""
    cfg = mla["cfg"]
    with pytest.raises(ValueError, match="paged"):
        EngineSpec(cache_layout="paged").validate(cfg)
    with pytest.raises(ValueError, match="paged"):
        JSpec(cache_layout="paged").validate(mla["jcfg"])
    packed = pack_params(mla["tparams"], mla["arrays"]["mixed"][1], cfg,
                         device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        ServeEngine(cfg, packed, mla["arrays"]["mixed"][1], MAX_SEQ,
                    EngineSpec(cache_layout="paged"), device="cpu")
    with pytest.raises(ValueError, match="page structure"):
        ttf.init_caches(cfg, 2, MAX_SEQ, torch.float32, "cpu",
                        page_geom=(8, 16))
    latent = ttf.init_caches(cfg, 2, MAX_SEQ, torch.float32, "cpu",
                             cache_bits=4)["pat"][0]["p0"]
    assert set(latent) == {"c_kv", "k_rope"}
    assert latent["c_kv"].dtype == torch.float32


def test_chip_smoke_dsv3_phase_runs_on_cpu(cpu_card):
    """``chip_smoke.py``'s deepseek-v3 phase at smoke size in bf16, as on
    the card (the MLA prefix block, 2 MoE layers of 8 experts with the
    shared expert): Z1-Z4 hold; one contiguous full-cache run, whose decode
    step and prefill launch ``step_launches``' quant_matmul (7 a prefix
    block, 4 + 3 E + 3 a MoE layer) and lsq_fakequant (5, and 3 + 1 + 2 E
    + 2, one more for the head), no decode attention, and a flash
    attention a layer in a prefill (796, 534 and 4 at the card's 3 prefix
    layers and one MoE layer of 256 experts); the check reads 0 over the
    prefill and 8 decode steps, its first block the prefix block; the
    schedule's contiguous full run holds gate A over the experts (24 of 24
    requests equal to their serial run, no slot dropped in decode) and
    launches quant_matmul, flash_attention and lsq_fakequant and neither
    decode attention."""
    full = get_config(NAME).replace(n_repeats=cpu_card.DSV3_DEPTH)
    assert cpu_card.step_launches(full) == {
        "quant_matmul": 796, "lsq_fakequant": 534, "attention": 4}
    cfg = get_config(NAME).smoke().replace(**BF16)
    rec = cpu_card.phase_zoo(cfg, torch.device("cpu"), "cpu rehearsal")
    e, layers = cfg.n_experts, 1 + cfg.n_repeats
    assert rec["select"]["take_equal"] and rec["select"]["n2"]
    assert rec["select"]["launches"]["histogram"] == rec["select"]["tensors"]
    assert set(rec["raw_bytes_of"]) == {"embed", "head", "mtp", "attn",
                                        "mlp", "moe", "norms"}
    assert sum(rec["raw_bytes_of"].values()) == rec["raw_weight_bytes"]
    assert set(rec["serve"]) == {"contiguous-full"}
    run = rec["serve"]["contiguous-full"]
    for launches in (run["launches_per_decode_step"],
                     run["launches_per_prefill"]):
        assert (launches["quant_matmul"], launches["lsq_fakequant"]) == (
            7 + (4 + 3 * e + 3) * cfg.n_repeats,
            5 + (4 + 2 * e + 2) * cfg.n_repeats + 1)
    assert run["launches_per_decode_step"]["kv_decode_attention"] == 0
    assert run["launches_per_prefill"]["flash_attention"] == layers
    assert run["dtoh_copies_8_steps"] == 0
    assert run["residency"]["resident_kv_bytes"] == (
        layers * 8 * 1024 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2)
    check = rec["check"][8]
    assert len(check["rel_logit_err"]) == cpu_card.ZOO_CHECK_DECODE + 1
    assert max(check["rel_logit_err"]) == 0.0
    assert len(check["block_rel_rms_err"][0]) == layers
    assert rec["peak_bytes"] == 0 and rec["packed_weight_bytes"] > 0
    # the scheduler at the served depth over the contiguous latent: every
    # request equal to its serial run (each admission prefills alone, the
    # decode steps drop no slot), the path's kernels and no decode attention
    assert set(rec["schedule"]) == {"contiguous-full"}
    sched = rec["schedule"]["contiguous-full"]
    assert sched["gate_a"]["matched"] == sched["admissions"] == 24
    assert not sched["gate_a"]["differs"]
    assert sched["gate_a"]["decode_dropped_slots"] == [0, 0]
    assert set(sched["gate_a"]["dropped_slots"]) == set(sched["plans"])
    assert {k for k, v in sched["launches"].items() if v} == {
        "quant_matmul", "flash_attention", "lsq_fakequant"}
    assert sched["profiled"]["dtoh_copies"] == 0
    assert sched["pool_bytes"] == (
        layers * cpu_card.SCHED_SLOTS * cpu_card.SCHED_MAX_SEQ
        * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2)
