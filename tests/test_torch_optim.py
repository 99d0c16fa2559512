"""The port's optimizers and schedule (repro_torch/optim) against the
reference's: the counterparts of tests/test_optim.py (AdamW with f32,
bf16 and int8 moments, LAMB and the clip converge on a quadratic), three
updates against JAX's, and the cosine schedule within one float32 ulp of
JAX's (XLA's float32 cos and PyTorch's round apart by an ulp)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim.adamw import AdamW, global_norm  # noqa: E402
from repro_torch.optim.lamb import Lamb  # noqa: E402
from repro_torch.optim.schedule import constant, cosine_with_warmup  # noqa


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quadratic_losses(make, steps=60, d=32, seed=0):
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32))
    w = torch.zeros((d, d), requires_grad=True)
    opt = make([w])
    losses = []
    for _ in range(steps):
        loss = torch.mean((w - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_adamw_converges(dtype):
    losses = _quadratic_losses(
        lambda ps: AdamW(ps, learning_rate=0.05, state_dtype=dtype))
    assert losses[-1] < 0.2 * losses[0]


def test_int8_state_tracks_f32():
    l32 = _quadratic_losses(lambda ps: AdamW(ps, learning_rate=0.05))
    l8 = _quadratic_losses(lambda ps: AdamW(ps, learning_rate=0.05,
                                            state_dtype="int8"))
    assert abs(l8[-1] - l32[-1]) < 0.15 * l32[0] + 1e-3


def test_grad_clip():
    w = torch.ones(4, requires_grad=True)
    opt = AdamW([w], learning_rate=0.1, grad_clip=1e-9)
    opt.step(grads=[torch.full((4,), 100.0)])
    assert float((w.detach() - 1).abs().max()) < 0.2


def test_lamb_converges():
    losses = _quadratic_losses(lambda ps: Lamb(ps, learning_rate=0.05),
                               steps=80)
    assert losses[-1] < 0.3 * losses[0]


def test_global_norm():
    t = [torch.ones(3), torch.full((4,), 2.0)]
    assert float(global_norm(t)) == pytest.approx(np.sqrt(3 + 16))


def test_refuses_unknown_state_dtype():
    with pytest.raises(ValueError, match="state_dtype"):
        AdamW([torch.zeros(2, requires_grad=True)], state_dtype="fp8")


@pytest.mark.parametrize("opt_name,state_dtype", [
    ("adamw", "f32"), ("adamw", "bf16"), ("adamw", "int8"), ("lamb", "f32")])
def test_update_matches_jax(opt_name, state_dtype):
    """Three updates of a matrix, a vector and a scalar leaf from the same
    numpy gradients: params and moments within 2e-6 of JAX's (XLA may
    contract the moment update's products and sums into FMAs; PyTorch
    rounds each).  LAMB keeps float32 moments only."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro.optim import lamb as jlamb
    rng = np.random.default_rng(5)
    shapes = {"a": (8, 16), "b": (16,), "c": ()}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    gs = [{k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
           shapes.items()} for _ in range(3)]
    sched = cosine_with_warmup(0.01, total_steps=10, warmup_steps=2)
    if opt_name == "adamw":
        from repro.optim.schedule import cosine_with_warmup as jcos
        jopt = jadamw.AdamW(learning_rate=jcos(0.01, 10, 2),
                            weight_decay=0.1, state_dtype=state_dtype,
                            grad_clip=0.5)
    else:
        jopt = jlamb.Lamb(learning_rate=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    for g in gs:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
    leaves = [torch.from_numpy(np.array(p0[k])).requires_grad_(True)
              for k in sorted(shapes)]
    if opt_name == "adamw":
        opt = AdamW(leaves, learning_rate=sched, weight_decay=0.1,
                    state_dtype=state_dtype, grad_clip=0.5)
    else:
        opt = Lamb(leaves, learning_rate=0.01)
    for g in gs:
        opt.step(grads=[torch.from_numpy(np.array(g[k]))
                        for k in sorted(shapes)])
    assert opt.count == int(js.count) == 3
    for k, leaf in zip(sorted(shapes), leaves):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=2e-6)
        for name in ("m", "v"):
            mine = opt.state[leaf][name]
            ref = getattr(js, name)[k]
            if isinstance(mine, dict):
                mine = {"q": mine["q"].numpy(), "s": mine["s"].numpy()}
                mine = jadamw._q8_decode({q: jnp.asarray(v) for q, v in
                                          mine.items()})
                ref = jadamw._q8_decode(ref)
            if isinstance(mine, torch.Tensor):
                mine = mine.float().numpy()
            np.testing.assert_allclose(
                np.asarray(mine, np.float32), np.asarray(ref, np.float32),
                rtol=2e-6 if state_dtype == "f32" else 1e-2, atol=1e-9)


def test_cosine_schedule_equals_jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim.schedule import constant as jconst
    from repro.optim.schedule import cosine_with_warmup as jcos
    for args in ((1.0, 100, 10), (3e-4, 1000, 0), (2e-3, 50, 7, 0.1)):
        mine, ref = cosine_with_warmup(*args), jcos(*args)
        for c in (0, 1, 5, 10, 11, 49, 55, 90, 100, 150):
            want = np.float32(ref(jnp.int32(c)))
            assert abs(float(mine(c)) - want) <= np.spacing(want), (args, c)
    assert float(constant(0.5)(3)) == float(jconst(0.5)(jnp.int32(3)))
    lr = cosine_with_warmup(1.0, total_steps=100, warmup_steps=10)
    assert float(lr(0)) == 0.0 and float(lr(10)) == pytest.approx(1.0)
    assert float(lr(55)) > float(lr(90))
