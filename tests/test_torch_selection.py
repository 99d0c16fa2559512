"""The port's selection surface against the reference's: the policy's
weight and cache bits (repro_torch/core/policy.py), the cost models
(core/costs.py), the paper's baselines (core/metrics/baselines.py), the
joint weight-and-cache knapsack (core/knapsack.select_weights_and_cache),
the frontier sweep (core/frontier.py) and distillation
(optim/distill.py), on olmo-1b's smoke config (and its full-size policy
for the knapsack) in float32 on the CPU.

The distillation module is held against the reference's formulas, not
its functions: the reference's dead-code check
(tests/test_analysis.py::test_repo_deadcode_clean) lists
``repro.optim.distill`` as unused, matches bare names over src/ and
tests/, and fails on an entry that a name makes look used; the reference
is not edited.  So the reference's module is not imported here and its
loss is written out below (``_jax_distill_loss``, its ten lines).  The
same check lists three of ``repro.core.costs``' functions as unused; the
port has no counterpart of them (core/costs.py says which).

Everything numpy-only is held equal: the same floats, takes and points.
Tolerances, each with its reason:
  - a frontier point's real 2-step fine-tune: the first step's loss within
    1e-5 relative of JAX's (the forward's tolerance in
    tests/test_torch_train.py), and the eval loss after the two steps
    within 1e-3 relative (tests/test_torch_alps.py's bound on the mean loss
    of a 2-step probe).  Measured 1.7e-4 at the smoke config's 4/2 mix at
    0.75: after step 1 the params are within 1.4e-5 (0.007 lr), which moves
    some weights across a 2-bit or 4-bit code boundary in one package, and
    at step 2 Adam's normalized update turns the gradients that this flips
    in sign into a difference of up to 2 lr (measured 1.6 lr);
  - distillation: kd_loss within 1e-6 relative on the same logits; one
    distilled step's loss, kd_loss and grad_norm within 1e-5 relative, and
    its params as test_torch_train.py holds one step's, except that an
    element off by more than 5e-2 lr counts with the sign flips, at most
    1e-4 of all elements (measured one element, 0.078 lr: a gradient near
    Adam's eps, where its rounding shows).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core import frontier as jfrontier  # noqa: E402
from repro.core import knapsack as jknapsack  # noqa: E402
from repro.core.metrics import baselines as jbaselines  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.core import costs, frontier, knapsack  # noqa: E402
from repro_torch.core.metrics import baselines  # noqa: E402
from repro_torch.core.policy import CACHE_FULL_BITS  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.distill import (kd_loss,  # noqa: E402
                                       make_distill_loss,
                                       teacher_policy_arrays)
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    train_state_from_params)

B, S = 4, 64
LOSS_TOL = 1e-5
FINETUNE_TOL = 1e-3
BUDGETS = (0.9, 0.75, 0.6)
CONTEXTS = (128, 1024, 8192)


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
def policies():
    return {"smoke": (jtf.build_policy(configs.get_config("olmo-1b").smoke()),
                      tf.build_policy(olmo_1b.config().smoke())),
            "full": (jtf.build_policy(configs.get_config("olmo-1b")),
                     tf.build_policy(olmo_1b.config()))}


def _mixed(p, k):
    """A fixed mix: every third selectable unit at b_lo, the cache of
    every other layer at int4, one unit at 3 bits."""
    units = p.selectable_units()
    m = p.apply_selection({u.name: i % 3 != 0 for i, u in enumerate(units)})
    m = m.apply_cache_selection({c.name: i % 2 == 0 for i, c in
                                 enumerate(m.selectable_cache_units())})
    m.set_bits(units[k].name, 3.0)
    return m


def _same_policy(tp, jp):
    assert [tp.bits_of(u.name) for u in tp.units] == \
        [jp.bits_of(u.name) for u in jp.units]
    assert [tp.cache_bits_of(c.name) for c in tp.cache_units] == \
        [jp.cache_bits_of(c.name) for c in jp.cache_units]
    ja, ta = jp.cache_bits_arrays(), tp.cache_bits_arrays()
    assert ja.keys() == ta.keys()
    for g in ja:
        np.testing.assert_array_equal(ta[g], ja[g])
    for name in ("kv_bytes_per_token", "model_bits", "compression_ratio",
                 "summary"):
        assert getattr(tp, name)() == getattr(jp, name)(), name
    for flag in (True, False):
        assert tp.cost_bmacs_per_token(flag) == \
            jp.cost_bmacs_per_token(flag)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_policy_methods_match_jax(policies, which):
    jp, tp = policies[which]
    assert (tp.cache_b_hi, tp.cache_b_lo) == (jp.cache_b_hi, jp.cache_b_lo)
    assert CACHE_FULL_BITS == 16.0
    assert [c.name for c in tp.selectable_cache_units()] == \
        [c.name for c in jp.selectable_cache_units()]
    assert [(c.kv_elems_per_token, c.pinned_bits) for c in tp.cache_units] \
        == [(c.kv_elems_per_token, c.pinned_bits) for c in jp.cache_units]
    _same_policy(tp, jp)
    _same_policy(_mixed(tp, 1), _mixed(jp, 1))
    for bits in (2.0, 3.0, 4.0):
        _same_policy(tp.uniform(bits), jp.uniform(bits))
    for bits in (4.0, 8.0, CACHE_FULL_BITS):
        _same_policy(tp.uniform_cache(bits), jp.uniform_cache(bits))
    # copy carries the cache bits and leaves the original alone
    m = _mixed(tp, 2)
    c = m.copy()
    _same_policy(c, _mixed(jp, 2))
    c.set_cache_bits(tp.cache_units[0].name, CACHE_FULL_BITS)
    assert m.cache_bits_of(tp.cache_units[0].name) == tp.cache_b_hi


def test_policy_refuses_what_the_reference_refuses(policies):
    jp, tp = policies["smoke"]
    pinned = next(u.name for u in tp.units if not u.selectable)
    for p in (jp, tp):
        with pytest.raises(ValueError, match="pinned"):
            p.copy().set_bits(pinned, 2.0)
        with pytest.raises(ValueError, match="cache bits must be"):
            p.copy().set_cache_bits(p.cache_units[0].name, 2.0)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_costs_match_jax(policies, which):
    jp, tp = policies[which]
    for jm, tm in ((jp, tp), (_mixed(jp, 0), _mixed(tp, 0)),
                   (jp.uniform(2.0), tp.uniform(2.0))):
        assert costs.bmacs(tm) == jcosts.bmacs(jm)
        over = {u.name: 2.0 for u in tm.selectable_units()[::2]}
        assert costs.bmacs(tm, over) == jcosts.bmacs(jm, over)
    assert costs.budget_sweep() == jcosts.budget_sweep()
    assert costs.budget_sweep([0.8, 0.5]) == jcosts.budget_sweep([0.8, 0.5])


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_baselines_match_jax(policies, which):
    jp, tp = policies[which]
    for name in ("uniform_gains", "first_to_last_gains",
                 "last_to_first_gains"):
        assert getattr(baselines, name)(tp) == getattr(jbaselines, name)(jp)
    for frac in costs.budget_sweep() + [0.5, 0.45, 1.0]:
        for rev in (False, True):
            assert baselines.greedy_prefix_selection(tp, frac, rev) == \
                jbaselines.greedy_prefix_selection(jp, frac, rev)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_joint_knapsack_takes_what_jax_takes(policies, which):
    jp, tp = policies[which]
    assert knapsack.synthetic_cache_gains(tp) == \
        jknapsack.synthetic_cache_gains(jp)
    gains = knapsack.synthetic_gains(tp)
    cgains = knapsack.synthetic_cache_gains(tp)
    mixes = set()
    for frac in BUDGETS:
        for ctx in CONTEXTS:
            tr = knapsack.select_weights_and_cache(tp, gains, cgains, frac,
                                                   ctx)
            jr = jknapsack.select_weights_and_cache(jp, gains, cgains, frac,
                                                    ctx)
            assert tr.take == jr.take, (frac, ctx)
            assert (tr.total_value, tr.total_weight, tr.capacity,
                    tr.weight_resolution) == (jr.total_value,
                                              jr.total_weight, jr.capacity,
                                              jr.weight_resolution)
            _same_policy(tp.apply_selection(tr.take)
                         .apply_cache_selection(tr.take),
                         jp.apply_selection(jr.take)
                         .apply_cache_selection(jr.take))
            mixes.add(sum(tr.take[c.name]
                          for c in tp.selectable_cache_units()))
    assert len(mixes) > 1      # the context moves the cache's share


def _methods(p, base):
    """Six methods as frontier_bench names them; the three metrics get
    fixed heterogeneous gains (the sweep, not the metric, is under
    test)."""
    g = knapsack.synthetic_gains(p)
    names = [u.name for u in p.selectable_units()]
    return {"eagl": g,
            "alps": {k: float((i * 31) % 7 + 1) for i, k in enumerate(names)},
            "hawq_v3": {k: g[k] * ((i % 5) - 2) for i, k in enumerate(names)},
            "uniform": base.uniform_gains(p),
            "first_to_last": None, "last_to_first": None}


def _fake_eval(policy=None):
    """A deterministic 'fine-tune and evaluate': a function of the bits."""
    return {"loss": float(sum(policy.bits_of(u.name) * (i + 1) for i, u in
                              enumerate(policy.selectable_units()))),
            "accuracy": float(policy.compression_ratio())}


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_frontier_sweep_points_match_jax(policies, which):
    jp, tp = policies[which]
    got = frontier.sweep(tp, _methods(tp, baselines), _fake_eval)
    want = jfrontier.sweep(jp, _methods(jp, jbaselines), _fake_eval)
    assert len(got) == len(want) == 6 * len(costs.budget_sweep())
    for a, b in zip(got, want):
        assert (a.method, a.budget_frac, a.achieved_cost_frac, a.n_dropped,
                a.task_metrics, a.compression_ratio) == \
            (b.method, b.budget_frac, b.achieved_cost_frac, b.n_dropped,
             b.task_metrics, b.compression_ratio)
        assert a.achieved_cost_frac <= a.budget_frac + 1e-9 or \
            a.method == "uniform"
    with pytest.raises(ValueError, match="needs gains"):
        frontier.select_policy(tp, "eagl", None, 0.7)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def smoke_model():
    cfg_j = configs.get_config("olmo-1b").smoke()
    cfg = olmo_1b.config().smoke()
    return cfg_j, cfg, jtf.init_params(cfg_j, jax.random.PRNGKey(0))


def test_frontier_point_with_a_real_finetune(policies, smoke_model):
    """One point of each package's sweep with frontier_bench's fine-tune
    (2 steps on make_batch(7, i) from the same params) and
    benchmarks/common.eval_loss on 2 held-out batches (make_batch(123,
    i))."""
    jp, tp = policies["smoke"]
    cfg_j, cfg, params = smoke_model
    ctx = local_context()
    jopt = JAdamW(learning_rate=2e-3, grad_clip=1.0)
    jtrain = jax.jit(jstep.make_train_step(cfg_j, ctx, jopt))

    def jax_eval(policy=None):
        pa = jax.tree.map(jnp.asarray, policy.as_arrays())
        st = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=jopt.init(params), policy=pa)
        first = []
        for i in range(2):
            st, m = jtrain(st, make_batch(7, i, B, S, cfg_j.vocab))
            first.append(float(m["loss"]))
        return {"loss": float(np.mean([
            float(jtf.loss_fn(st.params, pa, make_batch(123, i, B, S,
                                                         cfg_j.vocab),
                              cfg_j, ctx)[0]) for i in range(2)])),
            "first_step_loss": first[0]}

    def port_eval(policy=None):
        st = train_state_from_params(
            convert.from_jax_params(_np(params), device="cpu"),
            functools.partial(AdamW, learning_rate=2e-3, grad_clip=1.0),
            policy)
        step = make_train_step(cfg)
        first = []
        for i in range(2):
            st, m = step(st, _torch_batch(make_batch(7, i, B, S,
                                                     cfg_j.vocab)))
            first.append(float(m["loss"]))
        with torch.no_grad():
            return {"loss": float(np.mean([
                float(tf.loss_fn(st.params, st.policy, _torch_batch(
                    make_batch(123, i, B, S, cfg_j.vocab)), cfg)[0])
                for i in range(2)])), "first_step_loss": first[0]}

    gains = knapsack.synthetic_gains(tp)
    (got,) = frontier.sweep(tp, {"eagl": gains}, port_eval, [0.75])
    (want,) = jfrontier.sweep(jp, {"eagl": gains}, jax_eval, [0.75])
    assert (got.n_dropped, got.achieved_cost_frac) == (want.n_dropped,
                                                       want.achieved_cost_frac)
    assert got.n_dropped > 0
    a, b = (got.task_metrics["first_step_loss"],
            want.task_metrics["first_step_loss"])
    assert abs(a - b) <= LOSS_TOL * abs(b), (a, b)
    a, b = got.task_metrics["loss"], want.task_metrics["loss"]
    assert abs(a - b) <= FINETUNE_TOL * abs(b), (a, b)


def _jax_kd(student_logits, teacher_logits, temperature=2.0):
    """The reference's KD term (repro/optim/distill.py:18-23), in JAX."""
    t = temperature
    sp = jax.nn.log_softmax(student_logits.astype(jnp.float32) / t, axis=-1)
    tp = jax.nn.softmax(teacher_logits.astype(jnp.float32) / t, axis=-1)
    return -jnp.mean(jnp.sum(tp * sp, axis=-1)) * t * t


def _jax_distill_loss(alpha=0.5, temperature=2.0):
    """The reference's make_distill_loss(jtf.loss_fn, jtf.apply)
    (repro/optim/distill.py:26-39), in JAX."""
    def loss(params, policy_arrays, batch, cfg, ctx):
        task, metrics = jtf.loss_fn(params, policy_arrays, batch, cfg, ctx)
        s_logits, _, _ = jtf.apply(params, policy_arrays, batch, cfg, ctx,
                                   mode="train")
        t_arrays = jax.tree.map(lambda b: jnp.full_like(b, 16.0),
                                policy_arrays)
        t_logits, _, _ = jtf.apply(jax.lax.stop_gradient(params), t_arrays,
                                   batch, cfg, ctx, mode="train")
        kd = _jax_kd(s_logits, jax.lax.stop_gradient(t_logits), temperature)
        return alpha * task + (1 - alpha) * kd, dict(metrics, kd_loss=kd)
    return loss


def test_kd_loss_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(2, 8, 50)).astype(np.float32) * 3
    t = rng.normal(size=(2, 8, 50)).astype(np.float32) * 3
    for temp in (1.0, 2.0, 4.0):
        want = float(_jax_kd(jnp.asarray(s), jnp.asarray(t), temp))
        got = float(kd_loss(torch.tensor(s), torch.tensor(t), temp))
        assert abs(got - want) <= 1e-6 * abs(want), temp
    pa = {"pat0": {"attn_qkv": np.array([4.0, 2.0], np.float32)}}
    np.testing.assert_array_equal(teacher_policy_arrays(pa)["pat0"][
        "attn_qkv"], np.full((2,), 16.0, np.float32))


def test_one_distilled_step_matches_jax(policies, smoke_model):
    """make_distill_loss around each package's loss and apply, one AdamW
    step of each package's train step from the same params and batch."""
    jp, tp = policies["smoke"]
    cfg_j, cfg, params = smoke_model
    mixed_j = jp.apply_selection(jknapsack.select_for_budget(
        jp, jknapsack.synthetic_gains(jp), 0.7).take)
    mixed_t = tp.apply_selection(knapsack.select_for_budget(
        tp, knapsack.synthetic_gains(tp), 0.7).take)
    batch = make_batch(0, 0, B, S, cfg_j.vocab)
    jopt = JAdamW(learning_rate=2e-3, grad_clip=1.0)
    js = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jopt.init(params),
                          policy=jax.tree.map(jnp.asarray,
                                              mixed_j.as_arrays()))
    js2, jm = jax.jit(jstep.make_train_step(
        cfg_j, local_context(), jopt, loss_fn=_jax_distill_loss()))(js, batch)
    st = train_state_from_params(
        convert.from_jax_params(_np(params), device="cpu"),
        functools.partial(AdamW, learning_rate=2e-3, grad_clip=1.0), mixed_t)
    before = [p.detach().clone() for p in tree.leaves(st.params)]
    st, m = make_train_step(cfg, loss_fn=make_distill_loss(
        tf.loss_fn, tf.apply))(st, _torch_batch(batch))
    for k in ("loss", "kd_loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=LOSS_TOL), k
    assert float(m["kd_loss"]) > 0
    lr = 2e-3
    want = tree.leaves(convert.from_jax_params(_np(js2.params),
                                               device="cpu"))
    off = total = 0
    for p, w, p0 in zip(tree.leaves(st.params), want, before):
        d_port, d_ref = p.detach().double() - p0.double(), w.double() - \
            p0.double()
        far = ((d_port * d_ref) < 0) | (
            (p.detach().double() - w.double()).abs() > 5e-2 * lr)
        off += int(far.sum())
        total += p.numel()
    assert off <= 1e-4 * total, (off, total)
