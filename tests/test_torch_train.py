"""The port's QAT training path against the reference's, on olmo-1b's
smoke config in float32 on the CPU: the same numpy params (through
``convert.from_jax_params``) and the same batches (JAX's ``make_batch``,
as numpy) through both packages.

Tolerances, each with its reason:
  - loss within 1e-5 relative (measured: equal);
  - every leaf's gradient within ||dg|| / ||g|| <= 1e-3 (measured at most
    1.5e-5: summation order in the matmuls and reductions);
  - one AdamW step (lr 2e-3, clip 1.0): Adam's first step is lr * g /
    (|g| + eps), about lr * sign(g), so a gradient element that the two
    packages round to opposite signs moves the param by up to 2 lr; at
    most 1e-4 of the elements may flip (measured: none), and every other
    element is within 5e-2 * lr of JAX's (the elements with |g| near eps,
    where g's rounding shows);
  - float32 moments within 1e-4 of the largest of their leaf: they carry
    the gradients' rounding (1.5e-5), doubled in v by the square;
  - int8 moments in the reference's stacked layout (``to_tree``): every
    scale bit for bit, the codes of the layers' LSQ steps (one 1-D leaf
    with one shared scale) bit for bit, and the weights' codes within one
    code step, at most 1e-4 of them off (measured: 21 of about 1.1M; the
    gradients' rounding carries a bf16 moment across a code boundary);
  - 2 microbatches against 1: JAX's own test's rtol 5e-3 / atol 5e-4.
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
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    train_state_from_params)

B, S = 4, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg_j = configs.get_config("olmo-1b").smoke()
    cfg = olmo_1b.config().smoke()
    policy = jtf.build_policy(cfg_j)
    params = jtf.init_params(cfg_j, jax.random.PRNGKey(0))
    gains = jeagl.eagl_gains(
        policy, lambda u, t: jtf.fetch_unit_tensor(params, u, t), impl="ref")
    mixed = policy.apply_selection(
        jknapsack.select_for_budget(policy, gains, budget_frac=0.7).take)
    return cfg_j, cfg, {"uniform4": policy, "mixed42": mixed}, params


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("policy_name", ["uniform4", "mixed42"])
def test_loss_and_every_gradient_match_jax(setup, policy_name):
    cfg_j, cfg, policies, params = setup
    policy = policies[policy_name]
    pa = policy.as_arrays()
    if policy_name == "mixed42":
        bits = [float(b) for g in pa.values() for v in g.values() for b in v]
        assert 2.0 in bits and 4.0 in bits
    batch = make_batch(0, 0, B, S, cfg_j.vocab)
    ctx = local_context()
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jax.tree.map(jnp.asarray, pa), batch,
                              cfg_j, ctx), has_aux=True))(params)
    pt = convert.from_jax_params(_np(params), device="cpu")
    leaves = tree.leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lt, mt = tf.loss_fn(pt, pa, _torch_batch(batch), cfg)
    grads = torch.autograd.grad(lt, leaves)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]),
                                                  abs=1.0 / (B * S))
    want = tree.flatten(convert.from_jax_params(_np(gj), device="cpu"))
    assert len(want) == len(grads) == len(leaves)
    for (path, w), g, p in zip(want, grads, leaves):
        assert g.shape == p.shape and torch.isfinite(g).all(), path
        assert float(w.abs().max()) > 0, path
        assert _rel(g, w) <= 1e-3, (path, _rel(g, w))


@pytest.fixture(scope="module")
def one_step(setup):
    """One train step of each package from the same state, f32 and int8
    moments."""
    cfg_j, cfg, policies, params = setup
    policy = policies["uniform4"]
    batch = make_batch(0, 0, B, S, cfg_j.vocab)
    out = {}
    for sd in ("f32", "int8"):
        jopt = JAdamW(learning_rate=2e-3, grad_clip=1.0, state_dtype=sd)
        js = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=jopt.init(params),
                              policy=jax.tree.map(jnp.asarray,
                                                  policy.as_arrays()))
        js2, jm = jax.jit(jstep.make_train_step(cfg_j, local_context(),
                                                jopt))(js, batch)
        st = train_state_from_params(
            convert.from_jax_params(_np(params), device="cpu"),
            functools.partial(AdamW, learning_rate=2e-3, grad_clip=1.0,
                              state_dtype=sd), policy)
        st, m = make_train_step(cfg)(st, _torch_batch(batch))
        out[sd] = (js2, jm, st, m)
    return params, out


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_one_train_step_matches_jax(one_step, state_dtype):
    params, out = one_step
    assert_step_matches(params, *out[state_dtype], state_dtype)


def assert_step_matches(params, js2, jm, st, m, state_dtype, lr=2e-3):
    """One port step ``st, m`` from the reference params ``params`` against
    the reference's ``js2, jm``, at this module's tolerances."""
    assert_step_params_match(params, js2, jm, st, m, lr)
    if state_dtype == "int8":
        _int8_moments_match(st, js2)
        return
    for name in ("m", "v"):
        per_layer = tree.flatten(convert.from_jax_params(
            _np(getattr(js2.opt_state, name)), device="cpu"))
        for (path, w), p in zip(per_layer, tree.leaves(st.params)):
            mine = st.optimizer.state[p][name]
            tol = 1e-4 * max(float(w.abs().max()), 1e-30)
            assert float((mine.float() - w.float()).abs().max()) <= tol, (
                name, path)


def assert_step_params_match(params, js2, jm, st, m, lr=2e-3):
    """``assert_step_matches``' step count, loss, grad norm and params."""
    assert st.step == int(js2.step) == 1
    assert st.optimizer.count == int(js2.opt_state.count) == 1
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    before = tree.leaves(convert.from_jax_params(_np(params), device="cpu"))
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
        assert err.numel() == 0 or float(err.max()) <= 5e-2 * lr, (
            path, float(err.max()))
    assert flips <= 1e-4 * total, (flips, total)


def _int8_moments_match(st, js2):
    """The port's int8 m and v in the reference's stacked layout against
    the reference's own: keys, shapes, dtypes and scales equal; the codes
    of the stacked LSQ steps equal; the weights' codes within one step."""
    mine = st.to_tree()["opt_state"]
    off = total = 0
    for name in ("m", "v"):
        want = dict(tree.flatten(_np(getattr(js2.opt_state, name))))
        got = dict(tree.flatten(mine[name]))
        assert got.keys() == want.keys(), name
        for path, w in want.items():
            g = np.asarray(got[path])
            assert g.shape == w.shape and g.dtype == w.dtype, (name, path)
            if path[-1] == "s" or w.ndim <= 1:
                assert np.array_equal(g, w), (name, path)
                continue
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert int(d.max()) <= 1, (name, path)
            off += int((d > 0).sum())
            total += d.size
    assert off <= 1e-4 * total, (off, total)


def test_two_microbatches_equal_one(setup):
    """The counterpart of test_microbatch_equivalence: the averaged
    gradients of 2 microbatches give the step of the whole batch."""
    cfg_j, cfg, policies, params = setup
    batch = _torch_batch(make_batch(0, 0, B, S, cfg_j.vocab))
    states = []
    for n in (1, 2):
        st = train_state_from_params(
            convert.from_jax_params(_np(params), device="cpu"),
            functools.partial(AdamW, learning_rate=2e-3, grad_clip=1.0),
            policies["uniform4"])
        st, m = make_train_step(cfg, n_microbatches=n)(st, batch)
        states.append((st, m))
    (s1, m1), (s2, m2) = states
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(tree.leaves(s1.params), tree.leaves(s2.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-3, atol=5e-4)


def test_int8_grad_compression_names_its_item(setup):
    cfg = setup[1]
    with pytest.raises(NotImplementedError, match="item 14"):
        make_train_step(cfg, grad_compression="int8")


def test_train_mode_remats_each_layer_and_prequantizes(setup, monkeypatch):
    """Train mode with a gradient checkpoints every layer (non-reentrant)
    and fake-quantizes each projection weight once, before the layers;
    without a gradient it runs the layers as they are."""
    cfg = setup[1]
    params = tf.init_params(cfg, 0, "cpu")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    pa = tf.build_policy(cfg).as_arrays()
    calls = []
    real = tf.checkpoint

    def counted(fn, *args, use_reentrant=None):
        calls.append(use_reentrant)
        return real(fn, *args, use_reentrant=use_reentrant)
    monkeypatch.setattr(tf, "checkpoint", counted)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    logits, _ = tf.apply(params, pa, tokens, cfg, mode="train")
    assert calls == [False] * cfg.n_repeats and logits.requires_grad
    with torch.no_grad():
        again, _ = tf.apply(params, pa, tokens, cfg, mode="train")
    assert len(calls) == cfg.n_repeats and torch.equal(again, logits.detach())
    assert all(leaf.requires_grad for leaf in tree.leaves(params))
