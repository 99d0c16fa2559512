"""dbrx-132b's mixture of experts in the port against the reference on its
``.smoke()`` config (4 experts, top-2, one KV head) in float32 on the CPU:
the same numpy params in both packages (``convert.from_jax_params``), the
same inputs (numpy, from a seed).

Tolerances, each with its reason:
  - the registry's fields and the policy's units exactly;
  - ``moe_apply``'s output within 1e-5 * max|y| and its aux loss within
    1e-6 relative of the reference's (the same routing and drops, float32
    sums in other orders);
  - packed params and the fake-quant layout's codes byte-equal, resident
    bytes exact;
  - EAGL's gains within 1e-6 relative (exact counts; the float32 entropy
    sum), the knapsack takes equal;
  - 16 greedy tokens of two prompts of unequal length (the pads take
    capacity as in the reference) equal to the JAX packed engine's: the
    port's packed engine over full and int8 caches, contiguous and paged,
    and its fake-quant engine;
  - ``loss_fn``'s loss and aux within 1e-5 relative.

The selection mixes 4 and 2 bits inside one expert bank
(``synthetic_gains`` at 0.6, as the reference's own MoE engine test).
The JAX engines are built once, in the module's fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.core.metrics import eagl as jeagl  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import quantize_for_serving as jquantize  # noqa: E402
from repro.serve import residency as jres  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core.metrics import eagl as teagl  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (EngineSpec, ServeEngine,  # noqa: E402
                               pack_params, quantize_for_serving, residency)
from test_torch_serve import _compare_packed, _jax_engine  # noqa: E402

NAME = "dbrx-132b"
MAX_SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moe():
    """Both packages' smoke config, params from JAX's PRNGKey(1) carried
    across, the uniform policy and the mixed one (knapsack at 0.6 on
    synthetic gains), in ``test_torch_serve``'s setup layout."""
    jcfg = configs.get_config(NAME).smoke()
    cfg = get_config(NAME).smoke()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(1))
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
                                 tpol.apply_selection(ttake).as_arrays())},
            "jengines": {}}


def _prompt():
    """Two 12-token prompts, the second of 7 valid tokens."""
    return (np.random.default_rng(20).integers(0, 512, (2, 12)).astype(
        np.int32), np.array([12, 7], np.int32))


def test_config_registry():
    """Every field of the published config and of its ``.smoke()`` is the
    reference's (dtypes by name); the registry builds dbrx-132b and
    deepseek-v3-671b (item 13.3, with its shared expert) and still refuses
    the other pending architectures, each naming its item."""
    for want, got in ((configs.get_config(NAME), get_config(NAME)),
                      (configs.get_config(NAME).smoke(),
                       get_config(NAME).smoke())):
        for f in ("name", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "n_repeats", "norm", "activation", "rope",
                  "rope_base", "causal", "embed_input", "tie_embeddings",
                  "n_experts", "top_k", "n_shared_experts",
                  "capacity_factor", "moe_aux_weight"):
            assert getattr(got, f) == getattr(want, f), f
        assert [(b.mixer, b.ffn, b.d_ff) for b in got.pattern] == [
            (b.mixer, b.ffn, b.d_ff) for b in want.pattern]
        for f in ("param_dtype", "compute_dtype", "cache_dtype"):
            assert (str(getattr(got, f)).replace("torch.", "")
                    == jnp.dtype(getattr(want, f)).name), f
    smoke = get_config(NAME).smoke()
    assert (smoke.n_experts, smoke.top_k) == (4, 2)
    for name, item in (("jamba-1.5-large-398b", "13.4"),
                       ("xlstm-1.3b", "13.4")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            get_config(name)
    assert get_config("qwen2-vl-7b").rope == "mrope"     # item 13.2, ported
    dsv3 = get_config("deepseek-v3-671b")                # item 13.3, ported
    assert (dsv3.n_shared_experts, dsv3.pattern[0].mixer) == (1, "mla")
    shared = ttf.init_params(smoke.replace(n_shared_experts=1),
                             device="cpu")["pat"][0]["p0"]["moe"]["shared"]
    assert shared["gate"]["w"].shape == (smoke.d_model, smoke.d_ff)
    assert shared["down"]["w"].shape == (smoke.d_ff, smoke.d_model)


def test_policy_units_match_jax(moe):
    """Every unit (names, ``sub``, params, MACs k / E of an expert's, the
    pinned 8-bit router) and cache unit is the reference's; the mixed
    policy's arrays equal the reference's, per-expert slots (n_repeats,
    n_experts) with 4 and 2 bits inside one bank."""
    jp, tp, cfg = moe["jpol"], moe["tpol"], moe["cfg"]
    assert [(u.name, u.tensors, u.n_params, u.macs_per_token, u.in_features,
             u.sub, u.pinned_bits) for u in tp.units] == [
        (u.name, tuple(u.tensors), u.n_params, u.macs_per_token,
         u.in_features, u.sub, u.pinned_bits) for u in jp.units]
    assert [(c.name, c.kv_elems_per_token) for c in tp.cache_units] == [
        (c.name, c.kv_elems_per_token) for c in jp.cache_units]
    router = [u for u in tp.units if u.slot == "moe_router"]
    assert len(router) == cfg.n_repeats
    assert all(u.pinned_bits == 8.0 and u.sub is None for u in router)
    up = next(u for u in tp.units if u.name == "pat0.moe_gateup.e1.L0")
    assert up.sub == 1 and up.macs_per_token == (
        2 * cfg.d_model * cfg.d_ff * cfg.top_k / cfg.n_experts)
    ja, ta = moe["arrays"]["mixed"]
    for group in ja:
        assert set(ta[group]) == set(ja[group])
        for slot in ja[group]:
            np.testing.assert_array_equal(ta[group][slot], ja[group][slot])
    assert ta["pat0"]["moe_gateup"].shape == (cfg.n_repeats, cfg.n_experts)
    assert ta["pat0"]["moe_down"].shape == (cfg.n_repeats, cfg.n_experts)
    assert any(len(set(row.tolist())) > 1
               for slot in ("moe_gateup", "moe_down")
               for row in ta["pat0"][slot])
    bits = ttf.layer_bits(ta, cfg, 0)[0]
    assert isinstance(bits["moe_router"], float)
    assert bits["moe_gateup"] == tuple(float(b)
                                       for b in ta["pat0"]["moe_gateup"][0])


def _layer_moe(moe, layer=0, params=None):
    """Layer ``layer``'s MoE params of both packages (raw by default)."""
    jparams, tparams = params or (moe["jparams"], moe["tparams"])
    jp = jax.tree.map(lambda a: a[layer], jparams["pat"]["p0"]["moe"])
    return jp, tparams["pat"][layer]["p0"]["moe"]


def _bits(moe, layer=0):
    ja, ta = moe["arrays"]["mixed"]
    jb = {k: jnp.asarray(v[layer]) for k, v in ja["pat0"].items()}
    return jb, ttf.layer_bits(ta, moe["cfg"], layer)[0]


def _moe_pair(moe, jp, tp, x, over=None):
    """The reference's ``moe_apply`` and the port's on the same x, the
    mixed policy's bits of layer 0; ``over`` replaces config fields."""
    jcfg, cfg = moe["jcfg"], moe["cfg"]
    if over:
        jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
    jb, tb = _bits(moe)
    want_y, want_aux = jmlp.moe_apply(jp, jnp.asarray(x), jb, jcfg,
                                      local_context())
    with torch.no_grad():
        got_y, got_aux = tmlp.moe_apply(tp, torch.from_numpy(x), tb, cfg)
    return ((np.asarray(want_y), float(want_aux)),
            (got_y.numpy(), float(got_aux)))


def _assert_close(want, got):
    (wy, waux), (gy, gaux) = want, got
    assert gy.shape == wy.shape
    assert np.abs(gy - wy).max() <= 1e-5 * np.abs(wy).max()
    assert abs(gaux - waux) <= 1e-6 * abs(waux)


def _x(moe, seed, s=12):
    return np.random.default_rng(seed).normal(
        size=(2, s, moe["cfg"].d_model)).astype(np.float32)


def _drops(tp, x, cfg, bits):
    """(capacity, the most slots any expert got) of the port's routing."""
    with torch.no_grad():
        h = torch.from_numpy(x).reshape(-1, cfg.d_model)
        logits = tmlp.qproj(h, tp["router"], bits["moe_router"]).float()
        _, _, ids = tmlp.route(logits, cfg.top_k)
    counts = np.bincount(ids.reshape(-1).numpy(), minlength=cfg.n_experts)
    return tmlp.capacity_of(cfg, h.shape[0]), int(counts.max()), ids


@pytest.mark.parametrize("case", ["mixed", "dropped", "ties"])
def test_moe_apply_matches_jax(moe, case):
    """``moe_apply`` on raw params at the mixed per-expert bits: as it is;
    with a capacity factor of 0.5, so that slots are dropped; and with a
    zero router weight, every probability equal, where the top-k ties go
    to experts 0..k-1 as ``jax.lax.top_k`` sends them (and overflow)."""
    jp, tp = _layer_moe(moe)
    x, over = _x(moe, 3), None
    cfg = moe["cfg"]
    if case == "dropped":
        over = {"capacity_factor": 0.5}
        cfg = cfg.replace(**over)
    if case == "ties":
        jp = dict(jp, router=dict(jp["router"],
                                  w=jnp.zeros_like(jp["router"]["w"])))
        tp = dict(tp, router=dict(tp["router"],
                                  w=torch.zeros_like(tp["router"]["w"])))
    cap, most, ids = _drops(tp, x, cfg, _bits(moe)[1])
    if case == "ties":
        assert (ids.numpy() == np.arange(cfg.top_k)).all()
    assert (most > cap) == (case != "mixed"), (most, cap)
    _assert_close(*_moe_pair(moe, jp, tp, x, over))


@pytest.mark.parametrize("perturb", [False, True])
def test_packed_moe_apply_matches_jax(moe, perturb):
    """The packed layout (a PackedLinear an expert, each at its own bits)
    against the reference's packed ``moe_apply``; perturbed, every up
    expert's activation step is 1.7 x the gate's: gate and up share the
    gate's fake-quant of the buffer, so the result must not move, and it
    stays the reference's."""
    jparams, tparams = moe["jparams"], moe["tparams"]
    if perturb:
        jparams = dict(jparams, pat=jax.tree.map(lambda a: a, jparams["pat"]))
        jup = jparams["pat"]["p0"]["moe"]["up"]
        jparams["pat"]["p0"]["moe"]["up"] = dict(jup, sa=jup["sa"] * 1.7)
        tparams = dict(tparams, pat=[
            {"p0": dict(layer["p0"], moe=dict(layer["p0"]["moe"], up=dict(
                layer["p0"]["moe"]["up"],
                sa=layer["p0"]["moe"]["up"]["sa"] * 1.7)))}
            for layer in tparams["pat"]])
    ja, ta = moe["arrays"]["mixed"]
    jpk = jpack(jparams, ja, moe["jcfg"], layout="unrolled")
    tpk = pack_params(tparams, ta, moe["cfg"], device="cpu")
    jp = jpk["pat"][0]["p0"]["moe"]
    tp = tpk["pat"][0]["p0"]["moe"]
    assert isinstance(tp["gate"], list)
    up_sa = [float(q.sa) for q in tp["up"]]
    gate_sa = [float(q.sa) for q in tp["gate"]]
    assert (up_sa != gate_sa) == perturb
    x = _x(moe, 4)
    want, got = _moe_pair(moe, jp, tp, x)
    _assert_close(want, got)
    if perturb:
        _, same = _moe_pair(moe, jp, pack_params(
            moe["tparams"], ta, moe["cfg"], device="cpu")["pat"][0]["p0"][
                "moe"], x)
        np.testing.assert_array_equal(got[0], same[0])


def test_eagl_matches_jax(moe):
    """EAGL's gains of every selectable unit (one entropy an expert tensor)
    within 1e-6 relative; the knapsack takes at 0.6 equal."""
    jp, tp = moe["jpol"], moe["tpol"]
    want = jeagl.eagl_gains(jp, lambda u, t: jtf.fetch_unit_tensor(
        moe["jparams"], u, t), impl="ref")
    got = teagl.eagl_gains(tp, lambda u, t: ttf.fetch_unit_tensor(
        moe["tparams"], u, t))
    assert set(got) == set(want)
    assert sum(".moe_" in k for k in got) == 4 * moe["cfg"].n_experts
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k
    assert (tk.select_for_budget(tp, got, 0.6).take
            == jk.select_for_budget(jp, want, 0.6).take)


def test_pack_params_byte_equal(moe):
    """The mixed policy's packed tree, leaf for leaf (a list of E
    PackedLinear a bank, the router an int8 PackedLinear), and its resident
    bytes equal the reference's ``layout="unrolled"`` packing."""
    ja, ta = moe["arrays"]["mixed"]
    want = jpack(moe["jparams"], ja, moe["jcfg"], layout="unrolled")
    got = pack_params(moe["tparams"], ta, moe["cfg"], device="cpu")
    assert _compare_packed(want, got) > 0
    assert residency.resident_bytes(got) == jres.resident_bytes(want)
    for layer, row in zip(got["pat"], ta["pat0"]["moe_gateup"]):
        bank = layer["p0"]["moe"]
        assert [q.bits for q in bank["gate"]] == [int(b) for b in row]
        assert [q.bits for q in bank["up"]] == [int(b) for b in row]
        assert bank["router"].bits == 8


def test_fake_quant_layout_codes_match_jax(moe):
    """The fake-quant serve layout: every code, scale and step equal to the
    reference's ``quantize_for_serving`` (its int4 codes carried as int8),
    per-expert scales (E,) in each bank."""
    ja, ta = moe["arrays"]["mixed"]
    want = from_jax_params(jax.tree.map(np.asarray, jquantize(
        moe["jparams"], jax.tree.map(jnp.asarray, ja), moe["jcfg"])),
        device="cpu")
    got = quantize_for_serving(moe["tparams"], ta, moe["cfg"], device="cpu")
    assert _compare_packed(want, got) > 0
    bank = got["pat"][0]["p0"]["moe"]["down"]
    assert bank["wq"].dtype == torch.int8 and bank["scale"].shape == (
        moe["cfg"].n_experts,)


def _port_engine(moe, cache, layout="contiguous", weights="packed"):
    ta = moe["arrays"]["mixed"][1]
    convert = pack_params if weights == "packed" else quantize_for_serving
    return ServeEngine(moe["cfg"], convert(moe["tparams"], ta, moe["cfg"],
                                           device="cpu"), ta, MAX_SEQ,
                       EngineSpec(weights=weights, cache=cache, cache_bits=8,
                                  cache_layout=layout),
                       device="cpu")


@pytest.mark.parametrize("cache", ["full", "quantized"])
def test_greedy_matches_jax(moe, cache):
    """16 greedy tokens of two prompts of 12 and 7 tokens under the mixed
    per-expert policy: the port's packed engine, contiguous and paged, and
    its fake-quant engine give the JAX packed engine's, over the full cache
    and over int8."""
    prompt, lengths = _prompt()
    want = np.asarray(_jax_engine(moe, "mixed", cache, 8).generate(
        jnp.asarray(prompt), n_new=16, lengths=jnp.asarray(lengths)))
    for layout, weights in (("contiguous", "packed"), ("paged", "packed"),
                            ("contiguous", "fake_quant")):
        got = _port_engine(moe, cache, layout, weights).generate(
            prompt, 16, lengths=lengths)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{layout} {weights}")


def test_loss_matches_jax(moe):
    """The QAT loss with the load-balance aux (summed over the layers) and
    the aux alone, within 1e-5 relative of the reference's, the mixed
    policy on raw params."""
    cfg, jcfg = moe["cfg"], moe["jcfg"]
    ja, ta = moe["arrays"]["mixed"]
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    want, wm = jax.jit(lambda p, pa, b: jtf.loss_fn(
        p, pa, b, jcfg, local_context()))(
            moe["jparams"], jax.tree.map(jnp.asarray, ja),
            jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, gm = ttf.loss_fn(moe["tparams"], ta, {
            k: torch.from_numpy(v).long() for k, v in batch.items()}, cfg)
    assert float(gm["aux_loss"]) > 0
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(gm["aux_loss"]) - float(wm["aux_loss"])) \
        <= 1e-5 * abs(float(wm["aux_loss"]))


def test_convert_round_trip(moe):
    """``to_jax_tree`` stacks the port's per-layer banks back into the
    reference's (L, E, K, N) weights and (L, E) steps, leaf for leaf."""
    from repro_torch.convert import to_jax_tree
    back = to_jax_tree(moe["tparams"])
    want = jax.tree.map(np.asarray, moe["jparams"])
    bank = back["pat"]["p0"]["moe"]["gate"]
    cfg = moe["cfg"]
    assert bank["w"].shape == (cfg.n_repeats, cfg.n_experts, cfg.d_model,
                               cfg.d_ff)
    assert bank["sw"].shape == bank["sa"].shape == (cfg.n_repeats,
                                                    cfg.n_experts)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, ref)


def test_packed_views_and_bytes(moe):
    """The packed tree's expert lists: ``params_are_packed`` sees them,
    the CPU decode view dequantizes each expert to its fake-quant weight,
    and the bf16 count takes 2 bytes a logical weight of every expert."""
    from repro_torch.core import quant as tquant
    from repro_torch.serve import packing
    ta = moe["arrays"]["mixed"][1]
    packed = pack_params(moe["tparams"], ta, moe["cfg"], device="cpu")
    assert packing.params_are_packed(packed)
    view = packing.decode_weight_view(packed)
    raw = moe["tparams"]["pat"][0]["p0"]["moe"]["down"]
    for e, node in enumerate(view["pat"][0]["p0"]["moe"]["down"]):
        want = tquant.lsq_fake_quant(raw["w"][e], raw["sw"][e],
                                     ta["pat0"]["moe_down"][0][e])
        torch.testing.assert_close(node["wpre"], want, rtol=0, atol=0)
    cfg = moe["cfg"]
    experts = cfg.n_repeats * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    dense = sum(2 * q.k_dim * q.n_dim for layer in packed["pat"]
                for q in layer["p0"]["attn"].values())
    router = cfg.n_repeats * cfg.d_model * cfg.n_experts
    edges = 2 * packed["embed"]["wq"].numel() + 2 * packed["head"][
        "wq"].numel()
    assert packing.bf16_weight_bytes(packed) == (2 * experts + dense
                                                 + 2 * router + edges)
