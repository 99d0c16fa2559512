"""bert-base's encoder in the port (bidirectional GQA, GeLU FFN,
parametric LayerNorm, untied head) against the reference, on bert-base's
``.smoke()`` config in float32 on the CPU: the same numpy params (through
``convert.from_jax_params``), batches (JAX's ``make_batch``) and probes in
both packages; ``build_policy`` at full size.

Tolerances, each with its reason:
  - tanh GeLU within 1e-6 of max(1, |y|): the same formula, evaluated with
    other roundings of tanh and the cube (measured 5.8e-7);
  - logits within 1e-5 of max|logit|, relative (summation order in the
    matmuls and attention; measured 0 in train mode and in prefill);
  - the loss within 1e-5 relative and every leaf's gradient within
    ||dg|| / ||g|| <= 1e-3 (as ``test_torch_train.py``; measured at most
    1.3e-5), under a 4/2 mix whose layers of a slot differ in bits (a
    weight step's gradient scaled by rsqrt(n mean(qmax)) over the slot's
    layers in both);
  - one AdamW step with weight decay 0.1: the params as in
    ``test_torch_train.py`` (an element whose update flips sign may move
    2 lr, at most 1e-4 of them; every other within 5e-2 lr), which a
    LayerNorm scale decayed in one package and not in the other misses by
    2 lr x 0.1 = 4e-4 > 1e-4;
  - the policy, the packed bytes, the resident bytes and the convert round
    trip exactly;
  - EAGL's gains within 1e-6 relative (counts are exact; the entropy's
    float32 sum; measured 8.5e-8), and the knapsack takes equal;
  - HAWQ's per-layer traces within 1e-5 of the largest trace (as
    ``test_torch_hawq.py``; measured 5.3e-6).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jknapsack  # noqa: E402
from repro.core.metrics import eagl as jeagl  # noqa: E402
from repro.core.metrics import hawq as jhawq  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import residency as jres  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import knapsack  # noqa: E402
from repro_torch.core.metrics import eagl, hawq  # noqa: E402
from repro_torch.core.quant import PackedLinear  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serve import EngineSpec, pack_params, residency  # noqa: E402
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    train_state_from_params)

B, S = 2, 32
LR = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.fixture(scope="module")
def setup():
    cfg_j = configs.get_config("bert-base").smoke()
    cfg = get_config("bert-base").smoke()
    policy_j = jtf.build_policy(cfg_j)
    params = jtf.init_params(cfg_j, jax.random.PRNGKey(0))
    take = jknapsack.select_for_budget(
        policy_j, jknapsack.synthetic_gains(policy_j), 0.7).take
    mixed = policy_j.apply_selection(take).as_arrays()
    batch = make_batch(0, 0, B, S, cfg_j.vocab)
    return {"cfg_j": cfg_j, "cfg": cfg, "policy_j": policy_j,
            "params": params, "pt": convert.from_jax_params(_np(params),
                                                            device="cpu"),
            "arrays": {"uniform4": policy_j.as_arrays(), "mixed42": mixed},
            "batch": batch,
            "tbatch": {k: torch.from_numpy(np.array(v))
                       for k, v in batch.items()}}


def test_config_registry():
    """bert-base's fields are the reference's; the registry names item 13
    for the architectures still to port."""
    want, got = configs.get_config("bert-base"), get_config("bert-base")
    for f in ("name", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "n_repeats", "norm", "activation", "rope",
              "rope_base", "causal", "tie_embeddings"):
        assert getattr(got, f) == getattr(want, f), f
    assert [(b.mixer, b.ffn, b.d_ff) for b in got.pattern] == [
        (b.mixer, b.ffn, b.d_ff) for b in want.pattern]
    assert got.param_dtype == got.compute_dtype == torch.float32
    assert want.param_dtype == want.compute_dtype == jnp.float32
    assert get_config("olmo-1b").name == "olmo-1b"
    with pytest.raises(NotImplementedError, match="item 13"):
        get_config("xlstm-1.3b")
    with pytest.raises(KeyError):
        get_config("bert-huge")


def test_gelu_is_jax_tanh_gelu():
    x = (np.random.default_rng(0).normal(size=4096) * 4).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)), np.float64)
    got = mlp.act_fn("gelu", torch.from_numpy(x)).double().numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_logits_match_jax(setup, mode):
    s = setup
    pa = s["arrays"]["mixed42"]
    want, _, _ = jtf.apply(s["params"], jax.tree.map(jnp.asarray, pa),
                           {"tokens": s["batch"]["tokens"]}, s["cfg_j"],
                           local_context(), mode=mode)
    with torch.no_grad():
        got, caches = tf.apply(s["pt"], pa, s["tbatch"]["tokens"], s["cfg"],
                               mode=mode)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (B, S, s["cfg"].vocab)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    if mode == "prefill":      # the prefill K/V, as the reference returns
        assert caches["pat"][0]["p0"]["k"].shape == (
            B, S, s["cfg"].n_kv_heads, s["cfg"].head_dim)


def test_loss_and_every_gradient_match_jax(setup):
    s = setup
    pa = s["arrays"]["mixed42"]
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jax.tree.map(jnp.asarray, pa), s["batch"],
                              s["cfg_j"], local_context()),
        has_aux=True))(s["params"])
    pt = convert.from_jax_params(_np(s["params"]), device="cpu")
    leaves = tree.leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lt, _ = tf.loss_fn(pt, pa, s["tbatch"], s["cfg"])
    grads = torch.autograd.grad(lt, leaves)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    want = tree.flatten(convert.from_jax_params(_np(gj), device="cpu"))
    paths = [p for p, _ in want]
    # the new leaves: the untied head's three, the LayerNorms' biases, an
    # MLP without a gate
    assert ("head", "sa") in paths and ("final_norm", "bias") in paths
    assert ("pat", 0, "p0", "norm1", "bias") in paths
    assert not any("gate" in p for p in paths)
    assert len(want) == len(grads) == len(leaves)
    slot_of = tf.slot_index(s["cfg"])
    mixed = 0
    for (path, w), g in zip(want, grads):
        assert torch.isfinite(g).all() and float(w.abs().max()) > 0, path
        key = slot_of.get(path[:1] + path[2:-1])
        if path[-1] == "sw" and key is not None:
            mixed += len(set(pa[key[0]][key[1]].tolist())) > 1
        assert _rel(g, w) <= 1e-3, (path, _rel(g, w))
    assert mixed == 4               # mlp_gateup and mlp_down, both layers


@pytest.fixture(scope="module")
def one_step(setup):
    """One train step of each package from the same state, int8 moments
    and weight decay on."""
    s = setup
    state_dtype = "int8"
    policy = s["policy_j"]
    jopt = JAdamW(learning_rate=LR, grad_clip=1.0, weight_decay=0.1,
                  state_dtype=state_dtype)
    js = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=s["params"],
                          opt_state=jopt.init(s["params"]),
                          policy=jax.tree.map(jnp.asarray,
                                              policy.as_arrays()))
    js2, jm = jax.jit(jstep.make_train_step(s["cfg_j"], local_context(),
                                            jopt))(js, s["batch"])
    st = train_state_from_params(
        convert.from_jax_params(_np(s["params"]), device="cpu"),
        functools.partial(AdamW, learning_rate=LR, grad_clip=1.0,
                          weight_decay=0.1, state_dtype=state_dtype),
        policy)
    st, m = make_train_step(s["cfg"])(st, s["tbatch"])
    return js2, jm, st, m


def test_one_adamw_step_matches_jax(setup, one_step):
    """The reference decays its stacked (L, d) LayerNorm leaves (ndim 2)
    and not the final norm's (d,); the port's per-layer leaves decay as
    the stacked leaf does (``AdamW.stack_layers``), and their int8 moments
    take the reference's stacked layout."""
    s = setup
    js2, jm, st, m = one_step
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    before = tree.leaves(s["pt"])
    want = tree.flatten(convert.from_jax_params(_np(js2.params),
                                                device="cpu"))
    flips = total = 0
    for (path, w), p, p0 in zip(want, tree.leaves(st.params), before):
        d_port = p.detach().double() - p0.double()
        d_ref = w.double() - p0.double()
        flip = (d_port * d_ref) < 0
        flips += int(flip.sum())
        total += p.numel()
        err = (p.detach().double() - w.double()).abs()[~flip]
        assert err.numel() == 0 or float(err.max()) <= 5e-2 * LR, (
            path, float(err.max()))
    assert flips <= 1e-4 * total, (flips, total)
    # the reference's stacked layout: the same keys, shapes and dtypes
    mine = st.to_tree()["opt_state"]
    for name in ("m", "v"):
        ref_m = dict(tree.flatten(_np(getattr(js2.opt_state, name))))
        got = dict(tree.flatten(mine[name]))
        assert got.keys() == ref_m.keys()
        for path, w in ref_m.items():
            g = np.asarray(got[path])
            assert g.shape == w.shape and g.dtype == w.dtype, path


def test_build_policy_full_size_matches_jax():
    """bert-base at full size: 48 selectable units (one-tensor mlp_gateup
    units), the pinned 8-bit embedding and head, and no cache unit; the
    accounting of a policy without cache units as the reference's."""
    pj = jtf.build_policy(configs.get_config("bert-base"))
    pt = tf.build_policy(get_config("bert-base"))
    assert len(pt.units) == len(pj.units) == 50
    for a, b in zip(pt.units, pj.units):
        assert (a.name, a.group, a.layer, a.slot, a.tensors, a.n_params,
                a.macs_per_token, a.in_features, a.pinned_bits) == (
            b.name, b.group, b.layer, b.slot, b.tensors, b.n_params,
            b.macs_per_token, b.in_features, b.pinned_bits)
    assert len(pt.selectable_units()) == 48
    assert pt.units[-1].name == "head.head.L0" and pt.units[-1].pinned_bits
    assert pt.by_name["pat0.mlp_gateup.L3"].tensors == (
        ("pat", "p0", "mlp", "up", "w"),)
    assert pt.cache_units == pj.cache_units == []
    assert pt.cache_bits_arrays() == pj.cache_bits_arrays() == {}
    assert pt.kv_bytes_per_token() == pj.kv_bytes_per_token() == 0.0
    for k, v in pj.as_arrays().items():
        for slot, bits in v.items():
            np.testing.assert_array_equal(pt.as_arrays()[k][slot], bits)
    gains = knapsack.synthetic_gains(pt)
    for frac in (0.9, 0.7):
        got = knapsack.select_weights_and_cache(pt, gains, {}, frac, 1024)
        want = jknapsack.select_weights_and_cache(
            pj, jknapsack.synthetic_gains(pj), {}, frac, 1024)
        assert got.take == want.take and set(got.take) == {
            u.name for u in pt.selectable_units()}
        assert pt.apply_cache_selection(got.take).cache_bits_arrays() == {}


def _compare_packed(j, t, path=""):
    if isinstance(t, PackedLinear):
        assert (t.bits, t.k_dim) == (j.bits, j.k_dim), path
        for f in ("wp", "scale", "sa"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), path)
        return 1
    if isinstance(t, dict):
        assert set(t) == set(j), path
        return sum(_compare_packed(j[k], t[k], f"{path}/{k}") for k in t)
    if isinstance(t, list):
        assert len(t) == len(j), path
        return sum(_compare_packed(a, b, f"{path}[{i}]")
                   for i, (a, b) in enumerate(zip(j, t)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), path)
    return 1


def test_pack_params_bytes_and_residency_match_jax(setup):
    """A mixed 4/2 take packed in both packages: every projection's codes,
    scales and steps, the int8 embedding and the int8 head (codes, scale
    and its trained activation step) byte for byte; the resident bytes
    equal; and the packed forward is the fake-quant one within float32
    rounding."""
    s = setup
    pa = s["arrays"]["mixed42"]
    want = jpack(s["params"], pa, s["cfg_j"], layout="unrolled")
    got = pack_params(s["pt"], pa, s["cfg"], device="cpu")
    assert _compare_packed(want, got) > 0
    assert set(got["head"]) == {"wq", "scale", "sa"}
    assert got["head"]["wq"].dtype == torch.int8
    assert {p.bits for layer in got["pat"] for blk in layer.values()
            for grp in (blk["attn"], blk["mlp"])
            for p in grp.values()} == {2, 4}
    assert residency.report(got) == jres.report(want)
    with torch.no_grad():
        packed, _ = tf.apply(got, pa, s["tbatch"]["tokens"], s["cfg"],
                             mode="prefill")
        raw, _ = tf.apply(s["pt"], pa, s["tbatch"]["tokens"], s["cfg"],
                          mode="prefill")
    assert _rel(packed, raw) <= 1e-5


def test_engine_spec_refuses_an_encoder(setup):
    with pytest.raises(ValueError, match="autoregressive"):
        EngineSpec().validate(setup["cfg"])


def test_eagl_gains_and_take_match_jax(setup):
    s = setup
    pj = s["policy_j"]
    pt = tf.build_policy(s["cfg"])
    gj = jeagl.eagl_gains(pj, lambda u, t: jtf.fetch_unit_tensor(
        s["params"], u, t), impl="ref")
    gt = eagl.eagl_gains(pt, lambda u, t: tf.fetch_unit_tensor(
        s["pt"], u, t))
    assert gt.keys() == gj.keys() and len(gt) == 8
    for k, want in gj.items():
        assert abs(gt[k] - float(want)) <= 1e-6 * abs(float(want)), k
    assert (knapsack.select_for_budget(pt, gt, 0.7).take
            == jknapsack.select_for_budget(pj, gj, 0.7).take)


def jax_probes(params, n: int, seed: int = 0) -> list:
    """The reference's probe trees, drawn as its ``hutchinson_traces``
    draws them (as in ``test_torch_hawq.py``)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subkeys = jax.random.split(sub, len(leaves))
        out.append(jax.tree_util.tree_unflatten(treedef, [
            jax.random.rademacher(k, leaf.shape, jnp.float32).astype(
                leaf.dtype) for k, leaf in zip(subkeys, leaves)]))
    return out


def test_hawq_per_layer_traces_match_jax(setup):
    """One injected probe (the reference's Rademacher draw), per-layer
    paths in both packages (``t + (u.layer,)`` in the reference's): every
    member tensor of the 8 units, 12 traces."""
    s = setup
    pj = s["policy_j"]
    pa = jax.tree.map(jnp.asarray, pj.as_arrays())
    paths = {f"{u.name}/{t}": t + (u.layer,)
             for u in pj.selectable_units() for t in u.tensors}
    # the loss jitted: the reference differentiates it as it is (11 s here
    # against 25 s unjitted; traces within 3e-6 relative of each other)
    want = jhawq.hutchinson_traces(jax.jit(
        lambda p, b: jtf.loss_fn(p, pa, b, s["cfg_j"], local_context())[0]),
        s["params"], paths, jhawq.HawqConfig(n_probes=1), s["batch"])
    policy = tf.build_policy(s["cfg"])
    probes = [convert.from_jax_params(_np(v), device="cpu")
              for v in jax_probes(s["params"], 1)]
    got = hawq.hutchinson_traces(hawq.hvp_loss(s["cfg"], pj.as_arrays()),
                                 s["pt"], hawq.unit_tensor_paths(policy),
                                 hawq.HawqConfig(n_probes=1), s["tbatch"],
                                 probes=probes)
    assert got.keys() == want.keys() and len(got) == 12
    top = max(abs(v) for v in want.values())
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * top, (k, got[k], w)


def test_convert_round_trip(setup):
    """The head, the LayerNorms' biases and a gateless MLP go to the port
    and back unchanged."""
    s = setup
    want = _np(s["params"])
    back = convert.to_jax_tree(s["pt"])
    assert set(back) == set(want) == {"embed", "pat", "final_norm", "head"}
    flat_w, flat_b = tree.flatten(want), tree.flatten(back)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_b]
    for (path, w), (_, b) in zip(flat_w, flat_b):
        assert b.dtype == w.dtype, path
        np.testing.assert_array_equal(b, w, str(path))


# ----------------------------------------------------- chip_smoke's bert phase
@pytest.fixture
def cpu_card(monkeypatch):
    """The "auto" path on CPU tensors: every kernel wrapper runs its plain
    version, each call counted in cuda.LAUNCHES (a packed 4/2-bit matmul
    as quant_matmul, a float32 flash call as flash_attention_f32, which is
    what they launch on the card); the card's clocks and memory calls are
    no-ops."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import cuda, ops, ref
    monkeypatch.setattr(ops, "use_kernel", lambda t, impl: impl == "auto")

    def counted(name, fn):
        def run(*a, **k):
            cuda.LAUNCHES[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(cuda, "lsq_fakequant", counted(
        "lsq_fakequant", lambda x, s, b: ref.lsq_fakequant_grouped(x, s, b)
        if isinstance(s, list) else ref.lsq_fakequant(x, s, b)))
    monkeypatch.setattr(cuda, "lsq_fakequant_bwd", counted(
        "lsq_fakequant_bwd", ref.lsq_fakequant_bwd))
    monkeypatch.setattr(cuda, "histogram", counted("histogram",
                                                   ref.histogram))

    def flash(q, k, v, causal=True):
        name = ("flash_attention_f32" if q.dtype == torch.float32
                else "flash_attention")
        cuda.LAUNCHES[name] += 1
        return ops.flash_attention(q, k, v, causal, impl="ref")
    monkeypatch.setattr(cuda, "flash_attention", flash)
    real = ops.packed_matmul

    def packed_matmul(x, p, impl="auto"):
        if p.bits != 8 and impl == "auto":
            cuda.LAUNCHES["quant_matmul"] += 1
        return real(x, p, impl)
    monkeypatch.setattr(ops, "packed_matmul", packed_matmul)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "device_breakdown", lambda fn, top=20: (
        fn(), {"wall_ms": 1.0, "device_ms": 0.5, "idle_share": 0.5,
               "dtoh_copies": 0, "device_ops": 1, "qmm_gemv_ms": 0.0,
               "decode_attention_ms": 0.0, "lsq_fakequant_ms": 0.0,
               "lsq_fakequant_bwd_ms": 0.0, "copy_kernel_ms": 0.0,
               "copy_kernels": 0, "top": []})[1])
    for name, value in (("BERT_B", 2), ("BERT_S", 32), ("ALPS_B", 2),
                        ("ALPS_S", 32), ("FRONTIER_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_chip_smoke_bert_phase_runs_on_cpu(cpu_card):
    """chip_smoke.py's bert phase at bert-base's smoke size on the CPU
    (2 x 32 tokens), the kernels stood in for by their plain versions:
    B2-B6 hold; the train step's LSQ launches are worked out for a GeLU
    FFN and an untied head (6 weights a layer and 2 edges); the packed
    forward launches 6 quant_matmul, 4 lsq_fakequant and 1 float32 flash
    a layer and one more lsq_fakequant for the head; kernel path and plain
    path are one code path here, so B5 reads 0."""
    cfg = get_config("bert-base").smoke()
    rec = cpu_card.phase_bert(cfg, torch.device("cpu"), "cpu rehearsal")
    layers = cfg.n_repeats
    sites = cpu_card.lsq_sites(cfg)
    assert sites == {"activations": 4 * layers + 1,
                     "weights": 6 * layers + 2, "recomputed": 4 * layers}
    train = rec["train"]
    assert train["t1_loss_equal"] and train["t3_margin"] > 0
    assert not train["grads"]["bad"]
    # the 10 leaves of a layer with a shape (6 projections, 2 LayerNorms'
    # scale and bias), the embedding, the head and the final LayerNorm's
    assert train["grads"]["w_equal"] == 10 * layers + 4
    assert rec["select"]["take_equal"] and rec["select"]["n2"]
    assert rec["alps"]["units"] == rec["hawq"]["units"] == 4 * layers
    assert rec["hawq"]["h2_params_equal"] and rec["alps"]["a1_params_equal"]
    front = rec["frontier"]
    assert front["f3_params_equal"] and front["joint"]["cache_units"] == 0
    fwd = rec["forward"]
    assert fwd["launches"]["quant_matmul"] == 6 * layers
    assert fwd["launches"]["lsq_fakequant"] == 4 * layers + 1
    assert fwd["launches"]["flash_attention_f32"] == layers
    assert fwd["rel_logit_err"] == 0.0 and fwd["finite"]
    assert fwd["resident_weight_bytes"] < fwd["weight_bytes_bf16"]
    assert "autoregressive" in rec["b6"]


def _jax_tree(js):
    return _np({"step": js.step, "params": js.params,
                "opt_state": {"count": js.opt_state.count,
                              "m": js.opt_state.m, "v": js.opt_state.v},
                "policy": js.policy})


def test_checkpoints_cross_the_packages(one_step, tmp_path):
    """The states after the step, int8 moments: JAX's CheckpointManager
    restores the port's checkpoint into its TrainState, and the port
    restores JAX's into its own, each the writer's tree bit for bit (the
    head, the LayerNorms' biases and the stacked steps' shared scales)."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint.manager import CheckpointManager
    js2, _, st, _ = one_step
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        1, st.to_tree())
    _, restored = JManager(str(tmp_path / "port")).restore_latest(js2)
    mine = st.to_tree()
    for (path, a), (_, b) in zip(tree.flatten(_jax_tree(restored)),
                                 tree.flatten(mine)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      str(path))
    JManager(str(tmp_path / "jax"), async_save=False).save(1, js2)
    _, back = CheckpointManager(str(tmp_path / "jax")).restore_latest(mine)
    want = _jax_tree(js2)
    assert [p for p, _ in tree.flatten(back)] == [
        p for p, _ in tree.flatten(want)]
    for (path, a), (_, b) in zip(tree.flatten(back), tree.flatten(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      str(path))
