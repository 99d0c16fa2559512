"""The paper's method over dbrx-132b's experts in the port against the
reference, on its ``.smoke()`` config (4 experts, top-2, 2 layers, one KV
head) in float32 on the CPU: the same numpy params in both packages
(``convert.from_jax_params``), the same batches (numpy, from seeds).
Each expert is its own quant unit; the module ladders, in order:

  1. LSQ QAT over the expert banks: the loss, the aux loss and every
     gradient (each expert's ``w``, its weight step ``sw[e]`` and its
     activation step ``sa[e]``, the router, the attention, the edges) under
     uniform 4 bits and under a mix of 4 and 2 bits inside one bank, and the
     gradient of the aux loss alone (its share of the router's);
  2. one train step over the MoE, float32 and int8 AdamW moments;
  3. ALPS over the per-expert units: probes that drop one expert's bits,
     from the same b_hi state, and the knapsack take;
  4. HAWQ-v3 per expert: ``tests/test_torch_hawq.py`` (``per_expert``);
  5. the frontier over the MoE policy: its points, takes and costs;
  6. the continuous-batching scheduler over the MoE: contiguous full and
     int8 caches, and paged full with prefix sharing.

The router.  The reference initializes every activation step for 4 bits,
so the pinned 8-bit router reads its LayerNorm'd input on a handful of
levels (step 0.756 against unit variance) and its weights on the 4-bit
grid: the logits are small integer sums times one scale, and two experts
tie often (a top-k margin of 0, or of an ulp, in most (4, 64) batches of
the raw init).  A tie is broken by the float summation order, which
differs between XLA and PyTorch, and a different choice moves a token's
whole row.  So the params here give the router 8-bit steps (its weights'
range over 127, and 1/32 for its input: +-4 standard deviations), in both
packages, and
``router_margins`` records the smallest top-k margin of every routing in
the port: each test asserts it above MIN_MARGIN, so that its comparison
tests the port and not a tie.  Exact ties, resolved to the lower expert in
both packages, are ``tests/test_torch_moe.py``'s ``ties`` case.

Tolerances, each with its reason:
  - losses within 1e-5 relative (``tests/test_torch_train.py``);
  - every gradient within ||dg|| / ||g|| <= 1e-3 (the same), and the up
    bank's activation steps, which nothing reads (gate and up share the
    gate's fake-quant of each buffer), a zero gradient in both;
  - the train step as ``test_torch_train.assert_step_matches`` holds it;
  - ALPS: each probe's first step loss (the forward under the probe's
    policy) within 1e-4 relative (measured 6.5e-5 at one unit, where an
    activation code flips at a rounding tie, the others below 6e-6), its
    mean over ALPS_STEPS steps, the gain,
    within 2e-3 relative (measured 1.1e-3 at one attention unit, most
    units below 1e-6: the first update is Adam's lr * sign(g), an element
    whose gradient the two packages round to opposite signs moves by up to
    2 lr, and at 2 bits that can carry a weight across a code boundary and
    a token to another expert; ``tests/test_torch_alps.py``'s dense model
    measures 1e-6 under its 1e-3), the takes equal, the state restored bit
    for bit;
  - the frontier's points and takes equal (numpy only);
  - the scheduler's tokens, finish reasons and latency report equal.
"""
import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import frontier as jfrontier  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.core.metrics import alps as jalps  # noqa: E402
from repro.core.metrics import baselines as jbaselines  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import EngineSpec as JSpec  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import frontier, knapsack  # noqa: E402
from repro_torch.core.metrics import alps, baselines  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serve import EngineSpec, ServeEngine, pack_params  # noqa
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    train_state_from_params)
from test_torch_scheduler import _assert_same, _serve_both  # noqa: E402
from test_torch_train import assert_step_matches  # noqa: E402

NAME = "dbrx-132b"
B, S = 4, 64                # 256 tokens: capacity 160 of 256 slots an expert
ROUTER_SA = 1.0 / 32
MIN_MARGIN = 1e-5
LR = 2e-3
ALPS_STEPS = 2
ALPS_TOL = 2e-3             # a probe's mean loss, relative (the docstring)
BUDGETS = (0.9, 0.75, 0.6)
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
    """The smallest non-zero top-k margin (the k-th probability less the
    next) of each routing the port makes inside the block, appended to a
    list.  An exact tie (equal probabilities) goes to the lower expert in
    both packages; a margin of a few ulps is a tie that rounding broke."""
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
def moe():
    """Both packages' smoke config, params from JAX's PRNGKey(0) with the
    router's steps at its pinned 8 bits (the weights' range over 127, the
    activations' ROUTER_SA) carried across, and the uniform and
    mixed policies (knapsack at 0.6 on synthetic gains: 4 and 2 bits inside
    one bank)."""
    jcfg = configs.get_config(NAME).smoke()
    cfg = get_config(NAME).smoke()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    moe_p = jparams["pat"]["p0"]["moe"]
    w = moe_p["router"]["w"]
    router = dict(moe_p["router"],
                  sw=jnp.max(jnp.abs(w), axis=(1, 2)) / 127.0,
                  sa=jnp.full_like(moe_p["router"]["sa"], ROUTER_SA))
    jparams = dict(jparams, pat={"p0": dict(jparams["pat"]["p0"],
                                            moe=dict(moe_p, router=router))})
    jpol, tpol = jtf.build_policy(jcfg), tf.build_policy(cfg)
    jtake = jk.select_for_budget(jpol, jk.synthetic_gains(jpol), 0.6).take
    ttake = knapsack.select_for_budget(tpol, knapsack.synthetic_gains(tpol),
                                       0.6).take
    assert ttake == jtake
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams,
            "jpol": jpol, "tpol": tpol,
            "policies": {"uniform": (jpol, tpol),
                         "mixed": (jpol.apply_selection(jtake),
                                   tpol.apply_selection(ttake))}}


def _np(t):
    return jax.tree.map(np.asarray, t)


def _tparams(moe):
    return convert.from_jax_params(_np(moe["jparams"]), device="cpu")


def _batch(seed, b=B, s=S, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _grads(loss, leaves):
    return [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True,
                            retain_graph=True), leaves)]


def _assert_grads(want_tree, grads, leaves):
    """Every leaf's gradient within 1e-3 relative of the reference's; a
    leaf the reference gives an exactly zero gradient (the up bank's
    activation steps) exactly zero here too."""
    want = tree.flatten(convert.from_jax_params(_np(want_tree),
                                                device="cpu"))
    assert len(want) == len(grads) == len(leaves)
    zero = []
    for (path, w), g, p in zip(want, grads, leaves):
        assert g.shape == p.shape and torch.isfinite(g).all(), path
        if float(w.abs().max()) == 0:
            assert float(g.abs().max()) == 0, path
            zero.append(path[2:])
            continue
        assert _rel(g, w) <= 1e-3, (path, _rel(g, w))
    return zero


@pytest.mark.parametrize("policy_name", ["uniform", "mixed"])
def test_bank_qat_gradients_match_jax(moe, policy_name):
    """The QAT loss, its aux loss and every gradient against ``jax.grad``
    of the reference's ``loss_fn``; the bank leaves are (E, d_in, d_out)
    weights and (E,) steps a layer, every expert's gradient its own."""
    jcfg, cfg = moe["jcfg"], moe["cfg"]
    jpol, tpol = moe["policies"][policy_name]
    pa = tpol.as_arrays()
    assert np.array_equal(pa["pat0"]["moe_gateup"],
                          jpol.as_arrays()["pat0"]["moe_gateup"])
    if policy_name == "mixed":
        assert any(len(set(row)) > 1 for slot in ("moe_gateup", "moe_down")
                   for row in pa["pat0"][slot])
    batch = _batch(3)
    ctx = local_context()
    jpa = jax.tree.map(jnp.asarray, jpol.as_arrays())
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jpa, batch, jcfg, ctx), has_aux=True))(
            moe["jparams"])
    pt = _tparams(moe)
    leaves = tree.leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    with router_margins() as margins:
        lt, mt = tf.loss_fn(pt, pa, _torch_batch(batch), cfg)
    assert min(margins) > MIN_MARGIN, margins
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    assert abs(float(mt["aux_loss"]) - float(mj["aux_loss"])) <= \
        1e-5 * abs(float(mj["aux_loss"]))
    bank = pt["pat"][0]["p0"]["moe"]["gate"]
    assert bank["w"].shape[0] == bank["sw"].shape[0] == bank["sa"].shape[0] \
        == cfg.n_experts
    zero = _assert_grads(gj, _grads(lt, leaves), leaves)
    assert zero == [("p0", "moe", "up", "sa")] * cfg.n_repeats
    if policy_name == "uniform":
        # the aux loss's share: its gradient alone, router and all
        gaux = jax.jit(jax.grad(lambda p: jtf.loss_fn(p, jpa, batch, jcfg,
                                                      ctx)[1]["aux_loss"]))(
            moe["jparams"])
        _assert_grads(gaux, _grads(mt["aux_loss"], leaves), leaves)


@pytest.fixture(scope="module")
def one_step(moe):
    """One train step of each package from the same params under the mixed
    policy, float32 and int8 moments."""
    jcfg, cfg = moe["jcfg"], moe["cfg"]
    jpol, tpol = moe["policies"]["mixed"]
    batch = _batch(5)
    out = {}
    for sd in ("f32", "int8"):
        jopt = JAdamW(learning_rate=LR, grad_clip=1.0, state_dtype=sd)
        js = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=moe["jparams"],
                              opt_state=jopt.init(moe["jparams"]),
                              policy=jax.tree.map(jnp.asarray,
                                                  jpol.as_arrays()))
        js2, jm = jax.jit(jstep.make_train_step(jcfg, local_context(),
                                                jopt))(js, batch)
        st = train_state_from_params(_tparams(moe), functools.partial(
            AdamW, learning_rate=LR, grad_clip=1.0, state_dtype=sd), tpol)
        with router_margins() as margins:
            st, m = make_train_step(cfg)(st, _torch_batch(batch))
        assert min(margins) > MIN_MARGIN, margins
        out[sd] = (js2, jm, st, m)
    return out


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_one_train_step_matches_jax(moe, one_step, state_dtype):
    """The step's loss, grad norm, params and moments (int8: in the
    reference's stacked layout, each bank step's row its own scale)."""
    js2, jm, st, m = one_step[state_dtype]
    assert float(m["aux_loss"]) == pytest.approx(float(jm["aux_loss"]),
                                                 rel=1e-5)
    assert_step_matches(moe["jparams"], js2, jm, st, m, state_dtype, LR)


def test_alps_over_experts_matches_jax(moe):
    """ALPS over every selectable unit (attention and each expert's gate/up
    and down) from a b_hi state 8 of JAX's QAT steps from the params, the
    probe of ``tests/test_torch_alps.py`` (ALPS_STEPS train steps under the
    probe's policy, the mean loss): the gains and the knapsack take at 0.7,
    and the state restored bit for bit."""
    jcfg, cfg = moe["jcfg"], moe["cfg"]
    jpol, tpol = moe["policies"]["uniform"]
    jopt = JAdamW(learning_rate=LR, grad_clip=1.0)
    step = jax.jit(jstep.make_train_step(jcfg, local_context(), jopt))
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=moe["jparams"],
                             opt_state=jopt.init(moe["jparams"]),
                             policy=jax.tree.map(jnp.asarray,
                                                 jpol.as_arrays()))
    for i in range(8):
        state, _ = step(state, _batch(100 + i))
    batches = [_batch(11 + i) for i in range(ALPS_STEPS)]

    jfirst, first = [], []

    def jprobe(policy=None, steps=ALPS_STEPS):
        st = state._replace(policy=jax.tree.map(jnp.asarray,
                                                policy.as_arrays()))
        losses = []
        for i in range(steps):
            st, m = step(st, batches[i])
            losses.append(float(m["loss"]))
        jfirst.append(losses[0])
        return {"loss": float(np.mean(losses)),
                "accuracy": float(m["accuracy"])}
    want = jalps.alps_gains(jpol, probe_finetune=jprobe,
                            cfg=jalps.AlpsConfig(steps_per_probe=ALPS_STEPS))

    ts = train_state_from_params(_tparams(moe), functools.partial(
        AdamW, learning_rate=LR, grad_clip=1.0), tpol)
    ts.load_tree(_np({"step": state.step, "params": state.params,
                      "opt_state": {"count": state.opt_state.count,
                                    "m": state.opt_state.m,
                                    "v": state.opt_state.v},
                      "policy": state.policy}))
    before = [p.detach().clone() for p in tree.leaves(ts.params)]
    tbatches = [_torch_batch(b) for b in batches]
    tstep = make_train_step(cfg)

    def counted_step(st, batch):
        st, m = tstep(st, batch)
        if batch is tbatches[0]:
            first.append(float(m["loss"]))
        return st, m
    probe = alps.make_probe(ts, counted_step, lambda i: tbatches[i])
    seen = []

    def probe_policy(policy=None, steps=ALPS_STEPS):
        seen.append(policy)
        return probe(policy=policy, steps=steps)
    with router_margins() as margins:
        got = alps.alps_gains(tpol, probe_finetune=probe_policy,
                              cfg=alps.AlpsConfig(steps_per_probe=ALPS_STEPS))
    assert min(margins) > MIN_MARGIN, min(margins)
    units = tpol.selectable_units()
    experts = [u for u in units if u.sub is not None]
    assert list(got) == list(want) == [u.name for u in units]
    assert len(experts) == 2 * cfg.n_experts * cfg.n_repeats
    # a probe drops one expert's bits: its row of the slot, nothing else
    u = experts[3]
    pa = seen[units.index(u)].as_arrays()["pat0"][u.slot]
    assert pa[u.layer, u.sub] == tpol.b_lo and (pa == tpol.b_lo).sum() == 1
    assert len(first) == len(jfirst) == len(units)
    for a, b in zip(first, jfirst):
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    for k in want:
        assert abs(got[k] - want[k]) <= ALPS_TOL * abs(want[k]), (
            k, got[k], want[k])
    assert len({got[u.name] for u in experts}) > 1
    assert (knapsack.select_for_budget(tpol, got, 0.7).take
            == jk.select_for_budget(jpol, want, 0.7).take)
    assert ts.optimizer.count == int(state.opt_state.count)
    assert ts.step == int(state.step)
    for a, b in zip(tree.leaves(ts.params), before):
        assert torch.equal(a.detach(), b)


def _methods(p, base):
    """EAGL, ALPS and HAWQ-v3 with fixed heterogeneous gains (the sweep,
    not the metric, is under test) and the three baselines."""
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


def test_frontier_over_experts_matches_jax(moe):
    """``sweep`` at three budgets over the MoE policy (each expert a unit,
    MACs k / E of an expert's): every point's achieved cost, drops,
    compression and metrics, and each method's take (per-expert bits)."""
    jp, tp = moe["policies"]["uniform"]
    got = frontier.sweep(tp, _methods(tp, baselines), _fake_eval,
                         list(BUDGETS))
    want = jfrontier.sweep(jp, _methods(jp, jbaselines), _fake_eval,
                           list(BUDGETS))
    assert len(got) == len(want) == 6 * len(BUDGETS)
    for a, b in zip(got, want):
        assert (a.method, a.budget_frac, a.achieved_cost_frac, a.n_dropped,
                a.task_metrics, a.compression_ratio) == \
            (b.method, b.budget_frac, b.achieved_cost_frac, b.n_dropped,
             b.task_metrics, b.compression_ratio)
    dropped_experts = set()
    for method, gains in _methods(tp, baselines).items():
        for frac in BUDGETS:
            mine = frontier.select_policy(tp, method, gains, frac)
            ref = jfrontier.select_policy(jp, method, gains, frac)
            assert [mine.bits_of(u.name) for u in tp.units] == \
                [ref.bits_of(u.name) for u in jp.units], (method, frac)
            dropped_experts |= {u.name for u in tp.selectable_units()
                                if u.sub is not None
                                and mine.bits_of(u.name) == tp.b_lo}
    assert dropped_experts


def _sched_engines(moe, cache, layout):
    jpol, tpol = moe["policies"]["mixed"]
    ja, ta = jpol.as_arrays(), tpol.as_arrays()
    je = JEngine(cfg=moe["jcfg"], params=jpack(moe["jparams"], ja,
                                               moe["jcfg"]),
                 policy_arrays=jax.tree.map(jnp.asarray, ja),
                 ctx=local_context(), max_seq=MAX_SEQ,
                 spec=JSpec(weights="packed", cache=cache, cache_bits=8,
                            cache_layout=layout))
    te = ServeEngine(moe["cfg"], pack_params(_tparams(moe), ta, moe["cfg"],
                                             device="cpu"), ta, MAX_SEQ,
                     EngineSpec(cache=cache, cache_bits=8,
                                cache_layout=layout), device="cpu")
    return je, te


@pytest.mark.parametrize("cache,layout", [("full", "contiguous"),
                                          ("quantized", "contiguous"),
                                          ("full", "paged")])
def test_scheduler_over_experts_matches_jax(moe, cache, layout):
    """Five requests (prompts of 12 to 24 tokens; the last two open with
    the first one's 16-token prefix, a page) through 2 slots under the
    mixed per-expert policy: the reference scheduler's tokens, finish
    reasons and latency report.  Each admission prefills its request alone
    (its own capacity), and a decode step sends each slot's token to k
    experts of 8 rows at least, so no slot is dropped in decode.  The
    paged full cache shares the prefix and prefills the suffix."""
    rng = np.random.default_rng(30)
    shared = rng.integers(0, 512, 16).tolist()
    prompts = [shared + rng.integers(0, 512, 4).tolist(),
               rng.integers(0, 512, 12).tolist(),
               rng.integers(0, 512, 24).tolist(),
               shared + rng.integers(0, 512, 6).tolist(),
               shared + rng.integers(0, 512, 8).tolist()]
    reqs = [(f"r{i}", p, 10 + 2 * i, None) for i, p in enumerate(prompts)]
    je, te = _sched_engines(moe, cache, layout)
    with router_margins() as margins:
        js, ts = _serve_both(je, te, reqs, 2)
    assert min(margins) > MIN_MARGIN, min(margins)
    _assert_same(js, ts)
    if layout == "paged":
        assert ts.registry.hits >= 2
