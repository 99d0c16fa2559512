"""HAWQ-v3 in the port (repro_torch/core/metrics/hawq.py) and the forward
mode of its LSQ fake-quant (core/quant.LsqFakeQuantHvp.jvp) against the
reference's, on olmo-1b's smoke config in float32 on the CPU, with the
same numpy params, batch (JAX's ``make_batch(5, 0, 2, 32)``) and probes
(the reference's own Rademacher draws, regenerated here with its key
splits, ``repro/core/metrics/hawq.py:45-55``).

The port computes HAWQ per layer; the reference reads each path it is
given whole, so it is called here with per-layer paths ``t + (u.layer,)``
(its callers pass whole-leaf paths: ``test_reference_whole_leaf_paths``
pins what those give).

Tolerances, each with its reason:
  - per-tensor traces within 1e-5 of the largest trace, and gains within
    1e-5 of the largest gain (measured 1.9e-6 and 3.3e-6: summation order
    in the two packages' forward, backward and tangent products);
  - ||Q4(W) - Q2(W)||^2: the difference elements bit for bit with the
    reference's, the port's sum within 1e-6 relative of their float64 sum
    and the reference's within 1e-5 (XLA's float32 sum on the CPU reads
    6.1e-6 off it at the (64, 512) attention weights; the port's 1.5e-8);
  - the LSQ tangents bit for bit; the tangent of a small loss's gradient
    (an HVP) within 1e-6 of the largest element in x (measured 8.4e-8),
    and within 3e-5 relative in the step (measured 1.3e-5 at 8 bits: the
    port adds the step's 3072 terms in float64, the reference in float32;
    ROADMAP Queue 3 entry 4);
  - Hutchinson on a quadratic within the reference's own bound (15%,
    ``tests/test_metrics.py:53-68``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.metrics import hawq as jhawq  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.metrics import hawq  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

N_PROBES = 2
TRACE_TOL = 1e-5          # of the largest trace
GAIN_TOL = 1e-5           # of the largest gain


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


def jax_probes(params, n: int, seed: int = 0) -> list:
    """The reference's probe trees, drawn as ``hutchinson_traces`` draws
    them."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subkeys = jax.random.split(sub, len(leaves))
        out.append(jax.tree_util.tree_unflatten(treedef, [
            (jax.random.rademacher(k, leaf.shape, jnp.float32)
             .astype(leaf.dtype)
             if jnp.issubdtype(leaf.dtype, jnp.floating)
             else jnp.zeros_like(leaf))
            for k, leaf in zip(subkeys, leaves)]))
    return out


@pytest.fixture(scope="module")
def setup():
    cfg_j = configs.get_config("olmo-1b").smoke()
    cfg = olmo_1b.config().smoke()
    policy_j = jtf.build_policy(cfg_j)
    params = jtf.init_params(cfg_j, jax.random.PRNGKey(0))
    batch = make_batch(5, 0, 2, 32, cfg_j.vocab)
    pa = jax.tree.map(jnp.asarray, policy_j.as_arrays())
    ctx = local_context()

    def jloss(p, b):
        return jtf.loss_fn(p, pa, b, cfg_j, ctx)[0]
    return cfg_j, cfg, policy_j, params, batch, jloss


@pytest.fixture(scope="module")
def per_layer(setup):
    """Both packages' HAWQ on the same probes: JAX's hawq_gains with
    per-layer paths (its traces caught on the way), the port's default."""
    cfg_j, cfg, policy_j, params, batch, jloss = setup
    paths = {f"{u.name}/{t}": t + (u.layer,)
             for u in policy_j.selectable_units() for t in u.tensors}
    caught = {}
    real = jhawq.hutchinson_traces

    def catch(*args, **kwargs):
        caught.update(real(*args, **kwargs))
        return caught
    jhawq.hutchinson_traces = catch
    try:
        gj = jhawq.hawq_gains(policy_j, jloss, params, paths,
                              jhawq.HawqConfig(n_probes=N_PROBES), batch)
    finally:
        jhawq.hutchinson_traces = real
    policy = tf.build_policy(cfg)
    pt = convert.from_jax_params(_np(params), device="cpu")
    probes = [convert.from_jax_params(_np(v), device="cpu")
              for v in jax_probes(params, N_PROBES)]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss = hawq.hvp_loss(cfg, policy.as_arrays())
    traces = hawq.hutchinson_traces(loss, pt, hawq.unit_tensor_paths(policy),
                                    hawq.HawqConfig(n_probes=N_PROBES), tb,
                                    probes=probes)
    gt = hawq.hawq_gains(policy, loss, pt, None,
                         hawq.HawqConfig(n_probes=N_PROBES), tb,
                         probes=probes)
    return caught, gj, traces, gt, params, pt, policy


def test_traces_match_jax_per_layer(per_layer):
    caught, _, traces, _, _, _, _ = per_layer
    assert traces.keys() == caught.keys()
    top = max(abs(v) for v in caught.values())
    for k, want in caught.items():
        assert abs(traces[k] - want) <= TRACE_TOL * top, (k, traces[k],
                                                          want)


def test_gains_match_jax_per_layer(per_layer):
    _, gj, _, gt, _, _, policy = per_layer
    assert gt.keys() == gj.keys() == {u.name for u in
                                      policy.selectable_units()}
    top = max(abs(v) for v in gj.values())
    for k, want in gj.items():
        assert abs(gt[k] - want) <= GAIN_TOL * top, (k, gt[k], want)
    # per layer: the two layers of a slot read different gains
    assert gt["pat0.attn_qkv.L0"] != gt["pat0.attn_qkv.L1"]


def test_quant_perturbation_matches_jax(per_layer):
    _, _, _, _, params, pt, policy = per_layer
    paths = hawq.unit_tensor_paths(policy)
    for u in policy.selectable_units():
        for t in u.tensors:
            wj = params
            for k in t + (u.layer,):
                wj = wj[k]
            w = hawq._get_path(pt, paths[f"{u.name}/{t}"])
            elems = []
            for pkg, ww in (("jax", jnp.asarray(wj, jnp.float32)),
                            ("port", w.float())):
                mod = jnp if pkg == "jax" else torch
                rng = mod.maximum(abs(ww.min()), abs(ww.max()))
                deq = [(jquant.quantize_int(ww, rng / 2.0 ** (b - 1),
                                            jnp.float32(b))
                        if pkg == "jax" else
                        quant.quantize_int(ww, rng / 2.0 ** (b - 1), b))
                       * (rng / 2.0 ** (b - 1)) for b in (4.0, 2.0)]
                elems.append(np.asarray(deq[0] - deq[1]))
            np.testing.assert_array_equal(elems[0], elems[1])
            exact = float(np.sum(elems[0].astype(np.float64) ** 2))
            got = hawq.quant_perturbation_l2sq(w, 4.0, 2.0)
            want = jhawq.quant_perturbation_l2sq(jnp.asarray(wj), 4.0, 2.0)
            assert abs(got - exact) <= 1e-6 * exact, (u.name, t)
            assert abs(want - exact) <= 1e-5 * exact, (u.name, t)


def test_reference_whole_leaf_paths(setup):
    """What the reference's callers get (``benchmarks/frontier_bench.py:
    58-59``): a whole-leaf path gives each layer of a stacked slot the
    trace and perturbation of all its layers, so both layers of every
    slot read one gain.  The port's per-layer gains are the paper's."""
    cfg_j, _, policy_j, params, batch, jloss = setup
    paths = {f"{u.name}/{t}": t for u in policy_j.selectable_units()
             for t in u.tensors}
    gains = jhawq.hawq_gains(policy_j, jloss, params, paths,
                             jhawq.HawqConfig(n_probes=1), batch)
    for slot in ("attn_qkv", "attn_wo", "mlp_gateup", "mlp_down"):
        assert gains[f"pat0.{slot}.L0"] == gains[f"pat0.{slot}.L1"], slot


def test_hutchinson_quadratic():
    """loss = 0.5 x^T A x: the Hessian is A, the average trace mean(diag
    A); the port's own probes, the reference's test's 300 of them."""
    rng = np.random.default_rng(1)
    d = 16
    a_half = rng.normal(size=(d, d))
    a_mat = a_half @ a_half.T
    A = torch.tensor(a_mat, dtype=torch.float32)
    params = {"x": torch.tensor(rng.normal(size=(d,)), dtype=torch.float32)}
    traces = hawq.hutchinson_traces(lambda p: 0.5 * p["x"] @ A @ p["x"],
                                    params, {"u": ("x",)},
                                    hawq.HawqConfig(n_probes=300, seed=0))
    assert traces["u"] == pytest.approx(np.trace(a_mat) / d, rel=0.15)


def test_rademacher_probes_cover_every_floating_leaf():
    cfg = olmo_1b.config().smoke()
    params = tf.init_params(cfg, 0, "cpu")
    probes = list(hawq.rademacher_probes(params,
                                         hawq.HawqConfig(n_probes=2)))
    from repro_torch import tree
    assert len(probes) == 2
    for (path, p), (vpath, v) in zip(tree.flatten(params),
                                     tree.flatten(probes[0])):
        assert path == vpath and v.shape == p.shape and v.dtype == p.dtype
        assert set(torch.unique(v).tolist()) <= {-1.0, 1.0}, path
    again = list(hawq.rademacher_probes(params, hawq.HawqConfig(n_probes=2)))
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(probes[1]), tree.leaves(again[1])))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree.leaves(probes[0]), tree.leaves(probes[1])))


@pytest.mark.parametrize("bits", [2.0, 4.0, 8.0])
def test_lsq_jvp_matches_jax(bits):
    """The forward's tangent: the reference's primal (``_lsq_fwd``, which
    its HVP differentiates) under ``jax.jvp``; then the tangent of a
    small loss's gradient through the custom VJP (an HVP) against
    ``jax.jvp`` of ``jax.grad``."""
    rng = np.random.default_rng(int(bits))
    x = rng.normal(size=(64, 48)).astype(np.float32)
    step = np.float32(0.37 / bits)
    c = rng.normal(size=(64, 48)).astype(np.float32)
    xt = rng.normal(size=(64, 48)).astype(np.float32)
    st = np.float32(0.8)

    def jfwd(a, s):
        return jquant._lsq_fwd(a, s, jnp.float32(bits), True)[0]
    _, want = jax.jvp(jfwd, (jnp.asarray(x), jnp.asarray(step)),
                      (jnp.asarray(xt), jnp.asarray(st)))

    def tfwd(a, s):
        return quant.fake_quant(a, s, bits, "ref", hvp=True)
    _, got = torch.func.jvp(tfwd, (torch.tensor(x), torch.tensor(step)),
                            (torch.tensor(xt), torch.tensor(st)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def jloss(a, s):
        y = jquant.lsq_fake_quant(a, s, jnp.float32(bits))
        return jnp.sum(jnp.sin(y) * c)
    _, want_hv = jax.jvp(jax.grad(jloss, argnums=(0, 1)),
                         (jnp.asarray(x), jnp.asarray(step)),
                         (jnp.asarray(xt), jnp.asarray(st)))
    ct = torch.tensor(c)

    def tloss(a, s):
        y = quant.fake_quant(a, s, bits, "ref", hvp=True)
        return torch.sum(torch.sin(y) * ct)
    _, got_hv = torch.func.jvp(torch.func.grad(tloss, argnums=(0, 1)),
                               (torch.tensor(x), torch.tensor(step)),
                               (torch.tensor(xt), torch.tensor(st)))
    (gx, gs), (wx, ws) = got_hv, [np.asarray(w, np.float64)
                                  for w in want_hv]
    assert np.abs(gx.double().numpy() - wx).max() <= 1e-6 * np.abs(wx).max()
    assert abs(float(gs) - float(ws)) <= 3e-5 * abs(float(ws))


def test_kernel_wrappers_refuse_transformed_tensors():
    """A kernel launch has no forward-mode rule: a dual tensor, or a
    tensor a torch.func transform wrapped, makes the wrapper raise before
    it looks for a card."""
    from torch.autograd import forward_ad as fwad
    x = torch.randn(64)
    with fwad.dual_level():
        dual = fwad.make_dual(x, torch.ones(64))
        with pytest.raises(RuntimeError, match="dual"):
            cuda.lsq_fakequant(dual, 0.1, 4.0)
    with pytest.raises(RuntimeError, match="functorch-wrapped"):
        torch.func.grad(lambda t: cuda.lsq_fakequant(t, 0.1, 4.0).sum())(x)
