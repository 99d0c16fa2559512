"""ALPS in the port (repro_torch/core/metrics/alps.py) against the
reference's: the probe of benchmarks/frontier_bench.py:36-46 (from the
b_hi state, steps_per_probe 2 train steps under the probe's policy on
``make_batch(11, i, ...)``, the mean loss) over every selectable unit of
olmo-1b's smoke config, from the same 4-bit QAT checkpoint (30 of JAX's
steps), with JAX's batches fed in as numpy.

Tolerance: each gain within 1e-3 relative of JAX's (measured at most
about 1e-6: the first probe step's loss is the forward's, the second's
follows one Adam step, whose size is lr * sign(g) in both packages), and
the knapsack take at budget 0.7 equal.  The probe restores the b_hi state
before and after every probe: the params and moments end bit for bit
where they started."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jknapsack  # noqa: E402
from repro.core.metrics import alps as jalps  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.train.step import init_train_state, make_train_step  # noqa
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.core import knapsack  # noqa: E402
from repro_torch.core.metrics import alps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

B, S, STEPS = 4, 64, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_alps_gains_and_take_match_jax():
    cfg_j = configs.get_config("olmo-1b").smoke()
    cfg = olmo_1b.config().smoke()
    policy_j = jtf.build_policy(cfg_j)
    opt = JAdamW(learning_rate=2e-3, grad_clip=1.0)
    step = jax.jit(make_train_step(cfg_j, local_context(), opt))
    state = init_train_state(cfg_j, opt, jax.random.PRNGKey(0), policy_j)
    for i in range(30):
        state, _ = step(state, make_batch(0, i, B, S, cfg_j.vocab))
    batches = [make_batch(11, i, B, S, cfg_j.vocab) for i in range(STEPS)]

    def jprobe(policy=None, steps=STEPS):
        st = state._replace(policy=jax.tree.map(jnp.asarray,
                                                policy.as_arrays()))
        losses, m = [], {}
        for i in range(steps):
            st, m = step(st, batches[i])
            losses.append(float(m["loss"]))
        return {"loss": float(np.mean(losses)),
                "accuracy": float(m["accuracy"])}
    want = jalps.alps_gains(policy_j, probe_finetune=jprobe,
                            cfg=jalps.AlpsConfig(steps_per_probe=STEPS))

    policy = tf.build_policy(cfg)
    ts = tstep.train_state_from_params(
        convert.from_jax_params(jax.tree.map(np.asarray, state.params),
                                device="cpu"),
        functools.partial(AdamW, learning_rate=2e-3, grad_clip=1.0), policy)
    ts.load_tree(jax.tree.map(np.asarray, {
        "step": state.step, "params": state.params,
        "opt_state": {"count": state.opt_state.count,
                      "m": state.opt_state.m, "v": state.opt_state.v},
        "policy": state.policy}))
    before = [p.detach().clone() for p in tree.leaves(ts.params)]
    count = ts.optimizer.count
    tbatches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                for b in batches]
    probe = alps.make_probe(ts, tstep.make_train_step(cfg),
                            lambda i: tbatches[i])
    seen = []
    got = alps.alps_gains(policy, probe_finetune=probe,
                          cfg=alps.AlpsConfig(steps_per_probe=STEPS),
                          progress=lambda name, i, n, dt: seen.append(name))
    assert list(got) == list(want) == seen
    assert len(got) == len(policy.selectable_units()) == 8
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k],
                                                               want[k])
    take_j = jknapsack.select_for_budget(policy_j, want, budget_frac=0.7)
    take = knapsack.select_for_budget(policy, got, budget_frac=0.7)
    assert take.take == take_j.take
    assert ts.optimizer.count == count and ts.step == int(state.step)
    for a, b in zip(tree.leaves(ts.params), before):
        assert torch.equal(a.detach(), b)


def test_probe_restores_state_between_probes():
    """Two probes of the same policy give the same loss bit for bit, and a
    probe that raises still restores the state."""
    cfg = olmo_1b.config().smoke()
    policy = tf.build_policy(cfg)
    ts = tstep.init_train_state(cfg, functools.partial(AdamW,
                                                       learning_rate=2e-3),
                                0, policy, device="cpu")
    from repro_torch.data.synthetic import make_batch as tbatch
    batches = [tbatch(11, i, 2, 32, cfg.vocab, device="cpu")
               for i in range(2)]
    step = tstep.make_train_step(cfg)
    probe = alps.make_probe(ts, step, lambda i: batches[i])
    u = policy.selectable_units()[0]
    mixed = policy.apply_selection({u.name: False})
    a, b = probe(policy=mixed, steps=2), probe(policy=mixed, steps=2)
    assert a == b
    before = [p.detach().clone() for p in tree.leaves(ts.params)]

    def broken(state, batch):
        step(state, batch)
        raise RuntimeError("probe failed")
    bad = alps.make_probe(ts, broken, lambda i: batches[i])
    with pytest.raises(RuntimeError, match="probe failed"):
        bad(policy=mixed, steps=1)
    assert all(torch.equal(x.detach(), y) for x, y in
               zip(tree.leaves(ts.params), before))
    assert ts.optimizer.count == 0 and ts.step == 0
