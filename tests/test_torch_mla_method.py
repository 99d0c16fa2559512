"""The paper's method over deepseek-v3-671b in the port against the
reference, on its ``.smoke()`` config (one MLA + SwiGLU prefix block, 2
MLA + MoE layers of 8 experts, top-2, with a shared expert; the MTP head)
with q_lora_rank and kv_lora_rank raised from 64 to 128, so that all four
of MLA's units (attn_q_a, attn_q_b, attn_kv_b, attn_wo) are selectable
rather than pinned narrow, in float32 on the CPU: the same numpy params in
both packages (JAX's jitted init through ``convert.from_jax_params``), the
same batches (numpy, from seeds).  The module ladders, in order:

  1. LSQ QAT: the loss (cross entropy, the aux loss and 0.3 x the MTP
     loss), ``mtp_loss``, the aux loss and every gradient under a mixed
     4/2 policy that drops MLA units (attn_kv_b, whose wk_b and wv_b are
     read as weights only, and attn_wo), prefix units, experts inside one
     bank and the shared expert;
  2. one train step, float32 and int8 AdamW moments (the prefix blocks'
     leaves unstacked beside the stacked pattern's);
  3. ALPS over every selectable unit (prefix, MLA, per-expert, shared):
     the gains, the knapsack take, the state restored bit for bit;
  4. HAWQ-v3: ``tests/test_torch_hawq.py`` (``per_expert``, its
     deepseek-v3 case);
  5. the frontier over the deepseek-v3 policy: its points, takes, costs;
  6. the continuous-batching scheduler over the contiguous latent, full
     and int8 ``cache_bits`` (the latent stays full precision, as the
     policy pins it), under the mixed policy; a paged layout refused.

The router gets 8-bit steps in both packages (its weights' range over
127, and ROUTER_SA for its input), as in ``tests/test_torch_moe_method.py``
(whose docstring gives the reason: the raw init's router ties), and every
routing's smallest top-k margin is asserted above MIN_MARGIN
(``router_margins``).

Tolerances, each with its reason (``tests/test_torch_moe_method.py``'s):
  - losses within 1e-5 relative (``tests/test_torch_train.py``);
  - every gradient within ||dg|| / ||g|| <= 1e-3 (the same); the
    activation steps that nothing reads (wk_b's and wv_b's in every MLA
    block, the up bank's in a MoE layer) a zero gradient in both;
  - the train step as ``test_torch_train.assert_step_matches`` holds it
    (the loss and grad norm within 1e-5, each weight within 5e-2 lr where
    its update's sign agrees, at most 1e-4 of the elements flipped; int8
    moment codes within one), with two stated differences: an LSQ step's
    float32 m within STEP_SW_TOL relative and v (its square) within twice
    that (the port sums a step gradient's terms in float64, the reference
    in float32, ROADMAP Queue 3 entry 4; layer 1's shared gate step sums to
    1.2e-9 of cancelling terms and reads 6.9e-4 apart in m, 1.4e-3 in v,
    the other steps below 5e-5 in m), and an int8 moment's
    row scales within SCALE_TOL relative (a row's scale is its largest
    moment over 127; one of the 4096 rows of the expert down bank's m and
    one of the 2048 of the gate bank's v read 6.3e-3 and 4.0e-3 apart,
    their largest element moved by an activation code at a rounding tie;
    every other scale bit for bit);
  - ALPS: each probe's first step loss within 1e-4 relative, its mean over
    ALPS_STEPS steps (the gain) within 2e-3 relative (an element whose
    gradient the two packages round to opposite signs moves by up to 2 lr
    in Adam's first update), the takes equal, the state bit for bit.  Its
    50 probes of ALPS_STEPS steps route 12800 tokens a layer at ALPS_B x
    ALPS_S: at 4 x 64 some routing came within a rounding of a tie at
    every probe seed tried (margins of 1.5e-8 to 9.9e-6), so the probes
    run at 2 x 32, where make_batch's seeds 11 and 12 clear MIN_MARGIN;
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
from test_torch_train import assert_step_params_match  # noqa: E402

NAME = "deepseek-v3-671b"
RANKS = {"q_lora_rank": 128, "kv_lora_rank": 128}
B, S = 4, 64
ROUTER_SA = 1.0 / 32
MIN_MARGIN = 1e-5
LR = 2e-3
ALPS_STEPS = 2
ALPS_TOL = 2e-3             # a probe's mean loss, relative (the docstring)
ALPS_B, ALPS_S = 2, 32      # a probe's batch (the docstring)
STEP_SW_TOL = 1e-3          # an LSQ step's m, relative (v: twice; the
                            # docstring)
SCALE_TOL = 1e-2            # an int8 moment's row scale (the docstring)
BUDGETS = (0.9, 0.75, 0.6)
MAX_SEQ = 64
# the mixed policy's 2-bit units: MLA's wk_b/wv_b and wo, prefix units,
# experts inside one bank and the shared expert
DROPPED = ("prefix0.attn_kv_b.L0", "prefix0.mlp_gateup.L0",
           "pat0.attn_wo.L1", "pat0.attn_q_b.L0",
           "pat0.moe_gateup.e1.L0", "pat0.moe_gateup.e6.L0",
           "pat0.moe_down.e3.L1", "pat0.mlp_down.L1")


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
def dsv3():
    """Both packages' config, params from JAX's jitted init at
    PRNGKey(0) with the router's steps at its pinned 8 bits carried
    across, and the uniform and mixed (DROPPED at 2 bits) policies."""
    jcfg = configs.get_config(NAME).smoke().replace(**RANKS)
    cfg = get_config(NAME).smoke().replace(**RANKS)
    jparams = jax.jit(jtf.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    moe_p = jparams["pat"]["p0"]["moe"]
    w = moe_p["router"]["w"]
    router = dict(moe_p["router"],
                  sw=jnp.max(jnp.abs(w), axis=(1, 2)) / 127.0,
                  sa=jnp.full_like(moe_p["router"]["sa"], ROUTER_SA))
    jparams = dict(jparams, pat={"p0": dict(jparams["pat"]["p0"],
                                            moe=dict(moe_p, router=router))})
    jpol, tpol = jtf.build_policy(jcfg), tf.build_policy(cfg)
    names = [u.name for u in tpol.selectable_units()]
    assert names == [u.name for u in jpol.selectable_units()]
    assert set(DROPPED) <= set(names)
    take = {n: n not in DROPPED for n in names}
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams,
            "jpol": jpol, "tpol": tpol,
            "policies": {"uniform": (jpol, tpol),
                         "mixed": (jpol.apply_selection(take),
                                   tpol.apply_selection(take))}}


def _np(t):
    return jax.tree.map(np.asarray, t)


def _tparams(dsv3):
    return convert.from_jax_params(_np(dsv3["jparams"]), device="cpu")


def _batch(seed, b=B, s=S, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def test_mixed_qat_loss_mtp_and_every_gradient_match_jax(dsv3):
    """The QAT loss, ``mtp_loss``, the aux loss and the gradient of every
    leaf (the prefix block, MLA's six projections and norms, each expert,
    the shared expert, the router, the MTP head, the edges) against
    ``jax.grad`` of the reference's ``loss_fn`` under the mixed policy;
    the unread activation steps are exactly zero in both packages."""
    jcfg, cfg = dsv3["jcfg"], dsv3["cfg"]
    jpol, tpol = dsv3["policies"]["mixed"]
    pa = tpol.as_arrays()
    assert float(pa["prefix0"]["attn_kv_b"][0]) == tpol.b_lo
    assert sorted(set(pa["pat0"]["moe_gateup"][0])) == [tpol.b_lo,
                                                        tpol.b_hi]
    batch = _batch(3)
    jpa = jax.tree.map(jnp.asarray, jpol.as_arrays())
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jpa, batch, jcfg, local_context()),
        has_aux=True))(dsv3["jparams"])
    pt = _tparams(dsv3)
    leaves = tree.leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    with router_margins() as margins:
        lt, mt = tf.loss_fn(pt, pa, _torch_batch(batch), cfg)
    assert min(margins) > MIN_MARGIN, margins
    assert float(mt["mtp_loss"]) > 0
    for a, b in ((lt.detach(), lj), (mt["mtp_loss"], mj["mtp_loss"]),
                 (mt["aux_loss"].detach(), mj["aux_loss"])):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    grads = torch.autograd.grad(lt, leaves, allow_unused=True)
    want = tree.flatten(convert.from_jax_params(_np(gj), device="cpu"))
    assert len(want) == len(grads) == len(leaves)
    zero = []
    for (path, w), g, p in zip(want, grads, leaves):
        g = torch.zeros_like(p) if g is None else g
        assert g.shape == p.shape and torch.isfinite(g).all(), path
        if float(w.abs().max()) == 0:
            assert float(g.abs().max()) == 0, path
            zero.append(path[-3:])
            continue
        assert _rel(g, w) <= 1e-3, (path, _rel(g, w))
    mla = [("attn", "wk_b", "sa"), ("attn", "wv_b", "sa")]
    assert sorted(zero) == sorted(mla * (1 + cfg.n_repeats)
                                  + [("moe", "up", "sa")] * cfg.n_repeats)


@pytest.fixture(scope="module")
def one_step(dsv3):
    """One train step of each package from the same params under the mixed
    policy, float32 and int8 moments."""
    jcfg, cfg = dsv3["jcfg"], dsv3["cfg"]
    jpol, tpol = dsv3["policies"]["mixed"]
    batch = _batch(5)
    out = {}
    for sd in ("f32", "int8"):
        jopt = JAdamW(learning_rate=LR, grad_clip=1.0, state_dtype=sd)
        js = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=dsv3["jparams"],
                              opt_state=jopt.init(dsv3["jparams"]),
                              policy=jax.tree.map(jnp.asarray,
                                                  jpol.as_arrays()))
        js2, jm = jax.jit(jstep.make_train_step(jcfg, local_context(),
                                                jopt))(js, batch)
        st = train_state_from_params(_tparams(dsv3), functools.partial(
            AdamW, learning_rate=LR, grad_clip=1.0, state_dtype=sd), tpol)
        with router_margins() as margins:
            st, m = make_train_step(cfg)(st, _torch_batch(batch))
        assert min(margins) > MIN_MARGIN, margins
        out[sd] = (js2, jm, st, m)
    return out


def _moments_match(js2, st, state_dtype):
    """The moments as ``assert_step_matches`` holds them, but for the two
    stated differences of the docstring: an LSQ step's float32 moments
    within STEP_SW_TOL relative, an int8 row scale within SCALE_TOL."""
    if state_dtype == "f32":
        for name in ("m", "v"):
            want = tree.flatten(convert.from_jax_params(
                _np(getattr(js2.opt_state, name)), device="cpu"))
            for (path, w), p in zip(want, tree.leaves(st.params)):
                mine = st.optimizer.state[p][name].float()
                tol = ((1 + (name == "v")) * STEP_SW_TOL
                       if path[-1] in ("sw", "sa") else 1e-4) \
                    * max(float(w.abs().max()), 1e-30)
                assert float((mine - w.float()).abs().max()) <= tol, (
                    name, path)
        return
    mine = st.to_tree()["opt_state"]
    off = total = scales = 0
    for name in ("m", "v"):
        want = dict(tree.flatten(_np(getattr(js2.opt_state, name))))
        got = dict(tree.flatten(mine[name]))
        assert got.keys() == want.keys(), name
        for path, w in want.items():
            g = np.asarray(got[path])
            assert g.shape == w.shape and g.dtype == w.dtype, (name, path)
            if path[-1] == "s":
                assert np.allclose(g, w, rtol=SCALE_TOL, atol=0), (name,
                                                                   path)
                scales += int((g != w).sum())
            elif w.ndim <= 1:
                assert np.array_equal(g, w), (name, path)
            else:
                d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert int(d.max()) <= 1, (name, path)
                off += int((d > 0).sum())
                total += d.size
    assert off <= 1e-4 * total, (off, total)
    assert scales <= 2, scales
    assert "prefix0" in mine["m"] and "mtp" in mine["m"]


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_one_train_step_matches_jax(dsv3, one_step, state_dtype):
    """The step's loss (the MTP term in it), aux loss, grad norm, params
    and moments (int8: in the reference's layout, the prefix block's and
    the MTP head's leaves unstacked beside the pattern's stacked ones),
    as the docstring states."""
    js2, jm, st, m = one_step[state_dtype]
    assert float(m["aux_loss"]) == pytest.approx(float(jm["aux_loss"]),
                                                 rel=1e-5)
    assert_step_params_match(dsv3["jparams"], js2, jm, st, m, LR)
    _moments_match(js2, st, state_dtype)


def test_alps_over_mla_prefix_and_experts_matches_jax(dsv3):
    """ALPS over every selectable unit (the prefix block's, MLA's four a
    layer, each expert's gate/up and down, the shared expert's) from a
    b_hi state 4 of JAX's QAT steps from the params, each probe
    ALPS_STEPS train steps under its policy (the mean loss): the gains,
    the knapsack take at 0.7, and the state restored bit for bit."""
    jcfg, cfg = dsv3["jcfg"], dsv3["cfg"]
    jpol, tpol = dsv3["policies"]["uniform"]
    jopt = JAdamW(learning_rate=LR, grad_clip=1.0)
    step = jax.jit(jstep.make_train_step(jcfg, local_context(), jopt))
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=dsv3["jparams"],
                             opt_state=jopt.init(dsv3["jparams"]),
                             policy=jax.tree.map(jnp.asarray,
                                                 jpol.as_arrays()))
    for i in range(4):
        state, _ = step(state, _batch(100 + i))
    batches = [_batch(11 + i, ALPS_B, ALPS_S) for i in range(ALPS_STEPS)]

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

    ts = train_state_from_params(_tparams(dsv3), functools.partial(
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
    with router_margins() as margins:
        got = alps.alps_gains(tpol, probe_finetune=probe,
                              cfg=alps.AlpsConfig(steps_per_probe=ALPS_STEPS))
    assert min(margins) > MIN_MARGIN, min(margins)
    units = tpol.selectable_units()
    assert list(got) == list(want) == [u.name for u in units]
    slots = {u.slot for u in units}
    assert {"attn_q_a", "attn_q_b", "attn_kv_b", "attn_wo", "mlp_gateup",
            "mlp_down", "moe_gateup", "moe_down"} == slots
    assert {u.group for u in units} == {"prefix0", "pat0"}
    assert len(first) == len(jfirst) == len(units)
    for a, b in zip(first, jfirst):
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    for k in want:
        assert abs(got[k] - want[k]) <= ALPS_TOL * abs(want[k]), (
            k, got[k], want[k])
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


def test_frontier_over_mla_matches_jax(dsv3):
    """``sweep`` at three budgets over the deepseek-v3 policy (the prefix
    group first, MLA's four units a layer, experts at k / E of an
    expert's MACs, the shared expert): every point's achieved cost, drops,
    compression and metrics, and each method's take."""
    jp, tp = dsv3["policies"]["uniform"]
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
    dropped = set()
    for method, gains in _methods(tp, baselines).items():
        for frac in BUDGETS:
            mine = frontier.select_policy(tp, method, gains, frac)
            ref = jfrontier.select_policy(jp, method, gains, frac)
            assert [mine.bits_of(u.name) for u in tp.units] == \
                [ref.bits_of(u.name) for u in jp.units], (method, frac)
            dropped |= {u.slot for u in tp.selectable_units()
                        if mine.bits_of(u.name) == tp.b_lo}
    assert {"attn_kv_b", "moe_gateup", "mlp_down"} <= dropped


def _sched_engines(dsv3, cache):
    jpol, tpol = dsv3["policies"]["mixed"]
    ja, ta = jpol.as_arrays(), tpol.as_arrays()
    je = JEngine(cfg=dsv3["jcfg"], params=jpack(dsv3["jparams"], ja,
                                                dsv3["jcfg"]),
                 policy_arrays=jax.tree.map(jnp.asarray, ja),
                 ctx=local_context(), max_seq=MAX_SEQ,
                 spec=JSpec(weights="packed", cache=cache, cache_bits=8))
    te = ServeEngine(dsv3["cfg"], pack_params(_tparams(dsv3), ta,
                                              dsv3["cfg"], device="cpu"),
                     ta, MAX_SEQ, EngineSpec(cache=cache, cache_bits=8),
                     device="cpu")
    return je, te


@pytest.mark.parametrize("cache", ["full", "quantized"])
def test_scheduler_over_the_latent_matches_jax(dsv3, cache):
    """Five requests (prompts of 9 to 24 tokens) through 2 slots over the
    contiguous latent cache under the mixed policy: the reference
    scheduler's tokens, finish reasons and latency report.  Each admission
    prefills its request alone, and a decode step sends each slot's token
    to k experts of 8 rows at least, so no slot is dropped in decode.
    int8 ``cache_bits`` leave the latent at full precision (the policy
    pins it at 16), in the compute dtype as the engine keeps it; a paged
    layout
    is refused in both packages."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 512, n).tolist() for n in (20, 12, 24, 9, 16)]
    reqs = [(f"r{i}", p, 10 + 2 * i, None) for i, p in enumerate(prompts)]
    je, te = _sched_engines(dsv3, cache)
    with router_margins() as margins:
        js, ts = _serve_both(je, te, reqs, 2)
    assert min(margins) > MIN_MARGIN, min(margins)
    _assert_same(js, ts)
    latent = ts.cache.layers["pat"][1]["p0"]
    assert set(latent) == {"c_kv", "k_rope"}
    assert latent["c_kv"].dtype == dsv3["cfg"].compute_dtype
    for spec in (EngineSpec(cache=cache, cache_bits=8,
                            cache_layout="paged"),
                 JSpec(cache=cache, cache_bits=8, cache_layout="paged")):
        with pytest.raises(ValueError, match="paged"):
            spec.validate(dsv3["cfg"] if isinstance(spec, EngineSpec)
                          else dsv3["jcfg"])
