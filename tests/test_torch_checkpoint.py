"""The port's checkpoints (repro_torch/checkpoint/manager.py) and train
loop (repro_torch/train/loop.py): the reference's on-disk layout read both
ways, bit for bit (params, moments, count, step, policy), and the
counterparts of tests/test_checkpoint.py and tests/test_train.py's loop
tests (retention, incomplete checkpoints, async save, dtypes, metadata,
resume, stragglers)."""
import functools
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, make_batch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.loop import TrainLoop, TrainLoopConfig  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = olmo_1b.config().smoke()
OPT = functools.partial(AdamW, learning_rate=2e-3, grad_clip=1.0)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.randn((8,), generator=g)},
            "step": np.int32(7),
            "nested": [torch.arange(4),
                       {"x": torch.ones((2, 2), dtype=torch.bfloat16)}]}


def _state(seed=0, state_dtype="f32"):
    return init_train_state(CFG, functools.partial(OPT,
                                                   state_dtype=state_dtype),
                            seed, tf.build_policy(CFG), device="cpu")


def _equal_trees(a, b):
    fa, fb = tree.flatten(a), tree.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and np.array_equal(
            x.astype(np.float64), y.astype(np.float64)), path


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree()
    mgr.save(10, t)
    step, restored = mgr.restore_latest(t)
    assert step == 10
    for (_, a), (_, b) in zip(tree.flatten(t), tree.flatten(restored)):
        assert torch.equal(torch.as_tensor(a).float(),
                           torch.as_tensor(b).float())
    assert sorted(os.listdir(tmp_path / "step_10")) == sorted(
        ["meta.json", "nested::#0.npy", "nested::#1::x.npy",
         "params::b.npy", "params::w.npy", "step.npy"])


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _tree())
    mgr.wait()
    assert mgr.latest_step() == 1


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, _tree())
    os.makedirs(tmp_path / "step_9.tmp")      # a crashed write
    os.makedirs(tmp_path / "step_8")          # committed but no meta
    assert mgr.latest_step() == 5


def test_restore_respects_dtype_and_type(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = _tree()
    mgr.save(1, t)
    _, restored = mgr.restore_latest(t)
    assert restored["nested"][1]["x"].dtype == torch.bfloat16
    assert np.load(tmp_path / "step_1" / "nested::#1::x.npy").dtype == \
        np.float32
    assert isinstance(restored["step"], np.int32)


def test_metadata(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, _tree(), extra_meta={"data": {"seed": 0, "step": 3}})
    meta = mgr.metadata(3)
    assert meta["step"] == 3 and meta["data"]["step"] == 3


def _jax_state(state_dtype="f32"):
    """The reference's TrainState after one step of its own train step."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.data.synthetic import make_batch as jbatch
    from repro.models import transformer as jtf
    from repro.optim.adamw import AdamW as JAdamW
    from repro.parallel.context import local_context
    from repro.train.step import init_train_state as jinit
    from repro.train.step import make_train_step as jmake
    cfg = configs.get_config("olmo-1b").smoke()
    opt = JAdamW(learning_rate=2e-3, grad_clip=1.0, state_dtype=state_dtype)
    state = jinit(cfg, opt, jax.random.PRNGKey(3), jtf.build_policy(cfg))
    step = jax.jit(jmake(cfg, local_context(), opt))
    state, _ = step(state, jbatch(0, 0, 2, 32, cfg.vocab))
    return state


def test_port_restores_a_jax_checkpoint(tmp_path):
    """JAX's CheckpointManager writes its TrainState; the port restores it
    into a state made from another seed: params, moments, count, step and
    policy equal JAX's bit for bit, and the port's tree of the state is
    JAX's tree."""
    _port_restores_a_jax_checkpoint(tmp_path, "f32")


def test_port_restores_a_jax_int8_checkpoint(tmp_path):
    """The same with int8 moments: the layers' LSQ steps are one stacked
    leaf in the reference, with one scale (1,) over the layers, and come
    back in that layout."""
    _port_restores_a_jax_checkpoint(tmp_path, "int8")


def _port_restores_a_jax_checkpoint(tmp_path, state_dtype):
    import jax
    from repro.checkpoint.manager import CheckpointManager as JManager
    jstate = _jax_state(state_dtype)
    jpolicy = jstate.policy
    jstate = jstate._replace(policy=jax.tree.map(
        lambda a: a.at[0].set(2.0), jpolicy))    # a mixed policy
    JManager(str(tmp_path), async_save=False).save(1, jstate)
    state = _state(seed=11, state_dtype=state_dtype)
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(
        state.to_tree())
    assert step == 1
    state.load_tree(restored)
    want = jax.tree.map(np.asarray, {
        "step": jstate.step, "params": jstate.params,
        "opt_state": {"count": jstate.opt_state.count,
                      "m": jstate.opt_state.m, "v": jstate.opt_state.v},
        "policy": jstate.policy})
    _equal_trees(state.to_tree(), want)
    assert state.step == 1 and state.optimizer.count == 1
    assert float(state.policy["pat0"]["attn_qkv"][0]) == 2.0


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The port writes its state after one step; JAX's CheckpointManager
    restores it into its own TrainState, bit for bit."""
    _jax_restores_a_port_checkpoint(tmp_path, "f32")


def test_jax_restores_a_port_int8_checkpoint(tmp_path):
    """The same with int8 moments, written in the reference's stacked
    layout (each stacked LSQ step's scale (1,))."""
    _jax_restores_a_port_checkpoint(tmp_path, "int8")


def _jax_restores_a_port_checkpoint(tmp_path, state_dtype):
    import jax
    from repro.checkpoint.manager import CheckpointManager as JManager
    state = _state(seed=2, state_dtype=state_dtype)
    data = SyntheticLM(seed=0, batch=2, seq=32, vocab=CFG.vocab,
                       device="cpu")
    state, _ = make_train_step(CFG)(state, data.next())
    CheckpointManager(str(tmp_path), async_save=False).save(1,
                                                            state.to_tree())
    like = _jax_state(state_dtype)
    step, restored = JManager(str(tmp_path)).restore_latest(like)
    assert step == 1
    got = jax.tree.map(np.asarray, {
        "step": restored.step, "params": restored.params,
        "opt_state": {"count": restored.opt_state.count,
                      "m": restored.opt_state.m, "v": restored.opt_state.v},
        "policy": restored.policy})
    _equal_trees(got, state.to_tree())


def test_params_round_trip_through_the_jax_layout():
    state = _state(seed=4)
    back = convert.from_jax_params(convert.to_jax_tree(state.params), "cpu")
    for a, b in zip(tree.leaves(state.params), tree.leaves(back)):
        assert torch.equal(a.detach(), b)


def test_loop_checkpoints_and_resumes(tmp_path):
    step = make_train_step(CFG)
    data = SyntheticLM(seed=0, batch=2, seq=32, vocab=CFG.vocab,
                       device="cpu")
    loop = TrainLoop(step, data, TrainLoopConfig(
        total_steps=6, checkpoint_every=3, log_every=0),
        ckpt_dir=str(tmp_path))
    state = loop.run(_state())
    assert loop.manager.latest_step() == 6 and state.step == 6

    data2 = SyntheticLM(seed=0, batch=2, seq=32, vocab=CFG.vocab,
                        device="cpu")
    loop2 = TrainLoop(step, data2, TrainLoopConfig(
        total_steps=8, checkpoint_every=3, log_every=0),
        ckpt_dir=str(tmp_path))
    resumed = loop2.try_resume(_state(seed=9))
    assert resumed.step == 6 and data2.step == 6
    for a, b in zip(tree.leaves(resumed.params), tree.leaves(state.params)):
        assert torch.equal(a.detach(), b.detach())
    out = loop2.run(resumed)
    assert out.step == 8 and out.optimizer.count == 8


def test_straggler_detection():
    calls = {"n": 0}
    real = make_train_step(CFG)
    data = SyntheticLM(seed=0, batch=2, seq=32, vocab=CFG.vocab,
                       device="cpu")
    # warm the step (first-call allocations) and time it, so the EWMA
    # tracks the steady state and the slow step stands out on a busy host
    warm = _state(seed=1)
    real(warm, data.next())
    t0 = time.perf_counter()
    real(warm, data.next())
    pause = max(1.0, 10 * (time.perf_counter() - t0))
    data.step = 0

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 6:
            time.sleep(pause)
        return real(state, batch)
    loop = TrainLoop(slow_step, data, TrainLoopConfig(
        total_steps=8, log_every=0, straggler_factor=3.0))
    loop.run(_state())
    assert 5 in loop.straggler_steps


def test_synthetic_batches_are_stateless_and_learnable():
    """A batch depends on (seed, step) alone; labels are the next token;
    most rows follow (a + b t) mod V."""
    a = make_batch(0, 3, 4, 16, 512, device="cpu")
    b = make_batch(0, 3, 4, 16, 512, device="cpu")
    c = make_batch(0, 4, 4, 16, 512, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    d = torch.diff(a["tokens"], dim=1) % 512
    mode = torch.mode(d, dim=1).values[:, None]
    assert float((d == mode).float().mean()) > 0.8
    assert a["loss_mask"].shape == (4, 16) and bool((a["loss_mask"] == 1)
                                                    .all())
