"""The port's LSQ gradient (core/quant.LsqFakeQuant, the plain backward
kernels/ref.lsq_fakequant_bwd) against ``jax.vjp`` of the reference's
``quant.lsq_fake_quant``, on the same numpy inputs; and the guard that
keeps a forward-only kernel wrapper from dropping a gradient.

Tolerances: the forward and gx bit for bit.  A step's gradient within
1e-5 * gscale * sum|g * ds| of JAX's: JAX sums the products g * ds in
float32, the port in float64 (exact products), so the two differ by JAX's
float32 rounding of a sum whose terms cancel (relative to the result
itself it can reach 2e-5 at 2 bits and 131k elements).  The grouped form
rounds the summed cotangents once, JAX's separate calls once per add:
within 2 ulp (of x's dtype) of the terms' summed magnitudes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GS_TOL = 1e-5


def _inputs(dtype, shape, step, seed=0):
    """x with exact ties, values past both clamp edges, NaN-free; g
    normal; both rounded to ``dtype`` and returned as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 4.0 * float(
        np.max(step))
    flat = x.reshape(-1)
    s0 = np.float32(np.asarray(step).reshape(-1)[0])
    flat[:6] = s0 * np.array([0.5, 1.5, -2.5, 300.0, -300.0, 0.0],
                             np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    t = getattr(torch, dtype)
    x = torch.from_numpy(x).to(t).float().numpy()
    g = torch.from_numpy(g).to(t).float().numpy()
    return x, g


def _jax_vjp(x, g, step, bits, dtype):
    jdt = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda a, s: jquant.lsq_fake_quant(
        a, s, jnp.float32(bits)), jnp.asarray(x).astype(jdt),
        jnp.asarray(step))
    gx, gs = vjp(jnp.asarray(g).astype(jdt))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(gx.astype(jnp.float32)), np.asarray(gs))


def _gs_scale(x, g, step, bits, grad_qmax=None):
    """gscale * sum|g * ds|, reduced to the step's shape: the size of the
    terms the step gradient sums."""
    qmin, qmax = quant.qrange(bits)
    s = np.maximum(np.abs(step), 1e-9).astype(np.float32)
    xs = x / s
    inr = (xs >= qmin) & (xs <= qmax)
    ds = np.where(inr, np.round(xs) - xs, np.clip(xs, qmin, qmax))
    n = x.size // np.asarray(step).size
    gscale = quant.lsq_step_grad_scale(n, bits, grad_qmax)
    t = np.abs(g.astype(np.float64) * ds) * gscale
    shape = np.shape(step)
    if shape == ():
        return t.sum()
    return t.sum(axis=tuple(i for i, d in enumerate(shape) if d == 1),
                 keepdims=True)


@pytest.mark.parametrize("step_kind", ["scalar", "broadcast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lsq_vjp_matches_jax(bits, dtype, step_kind):
    shape = (64, 2048) if step_kind == "scalar" else (96, 48)
    if step_kind == "scalar":
        step = np.float32(0.37)
    else:   # a per-column step, as a per-channel weight step would be
        step = np.random.default_rng(1).uniform(
            0.1, 0.6, size=(1, shape[1])).astype(np.float32)
    x, g = _inputs(dtype, shape, step)
    want_y, want_gx, want_gs = _jax_vjp(x, g, step, bits, dtype)

    t = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(t).requires_grad_(True)
    st = torch.from_numpy(np.asarray(step)).requires_grad_(True)
    y = quant.fake_quant(xt, st, bits)
    y.backward(torch.from_numpy(g).to(t))
    assert y.dtype == t and xt.grad.dtype == t
    np.testing.assert_array_equal(y.detach().float().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.float().numpy(), want_gx)
    assert st.grad.shape == st.shape and st.grad.dtype == torch.float32
    err = np.abs(st.grad.numpy().astype(np.float64) - want_gs)
    assert np.all(err <= GS_TOL * _gs_scale(x, g, step, bits)), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_steps", [2, 3])
def test_grouped_lsq_vjp_matches_separate_jax_calls(dtype, n_steps):
    """Steps that share x: one grouped call whose gx is the summed
    straight-through cotangents, against n separate JAX calls whose
    cotangents JAX adds in x's dtype."""
    steps = [np.float32(v) for v in (0.25, 0.1, 3.0)[:n_steps]]
    x, _ = _inputs(dtype, (32, 256), np.float32(0.25))
    rng = np.random.default_rng(3)
    t = getattr(torch, dtype)
    gs = [torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(
        t).float().numpy() for _ in steps]
    jdt = getattr(jnp, dtype)

    def f(a, *ss):
        return tuple(jquant.lsq_fake_quant(a, s, jnp.float32(4.0))
                     for s in ss)
    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt),
                     *[jnp.asarray(s) for s in steps])
    want = vjp(tuple(jnp.asarray(g).astype(jdt) for g in gs))

    xt = torch.from_numpy(x).to(t).requires_grad_(True)
    sts = [torch.tensor(s, requires_grad=True) for s in steps]
    outs = quant.fake_quant_group(xt, sts, 4.0)
    torch.autograd.backward(outs, [torch.from_numpy(g).to(t) for g in gs])
    got = xt.grad.float().numpy()
    wx = np.asarray(want[0].astype(jnp.float32))
    mag = np.sum([np.abs(g) for g in gs], axis=0).astype(np.float32)
    ulp = np.spacing(mag) * (2 ** 16 if dtype == "bfloat16" else 1)
    assert np.all(np.abs(got - wx) <= 2 * ulp + 1e-30)
    for st, s, g, w in zip(sts, steps, gs, want[1:]):
        err = abs(float(st.grad) - float(w))
        assert err <= GS_TOL * _gs_scale(x, g, s, 4.0), err


def test_grouped_backward_equals_plain_sum():
    """gx of the grouped backward: the first straight-through term as it
    is, then the others added in float32 in step order, rounded once."""
    x = torch.linspace(-3, 3, 1001).to(torch.bfloat16)
    gs = [torch.randn(1001, generator=torch.Generator().manual_seed(k)).to(
        torch.bfloat16) for k in range(3)]
    steps = [0.25, torch.tensor(0.1), 3.0]
    gx, gsteps = tref.lsq_fakequant_bwd(x, gs, steps, 2)
    qmin, qmax = quant.qrange(2)
    acc = None
    for g, s in zip(gs, (0.25, 0.1, 3.0)):
        xs = x.float() / torch.tensor(s)
        term = torch.where((xs >= qmin) & (xs <= qmax), g.float(), 0.0)
        acc = term if acc is None else acc + term
    assert torch.equal(gx, acc.to(torch.bfloat16))
    assert [t.shape for t in gsteps] == [()] * 3


def test_float_steps_and_bits_get_no_gradient():
    """A float step (the LM head's pinned activation step) and the bits are
    constants: the backward returns no gradient for them, and a tensor step
    that does not require grad gets none either."""
    x = torch.randn(40, requires_grad=True)
    s = torch.tensor(0.3, requires_grad=True)
    frozen = torch.tensor(0.2)
    outs = quant.fake_quant_group(x, [s, 0.05, frozen], 4)
    sum(o.sum() for o in outs).backward()
    assert s.grad is not None and frozen.grad is None
    assert x.grad.shape == x.shape


def test_no_grad_calls_the_forward_alone(monkeypatch):
    """Without a gradient to record (serving), fake_quant_group calls the
    forward dispatch directly, not the autograd Function."""
    def refuse(*a, **k):
        raise AssertionError("LsqFakeQuant.apply under no_grad")
    monkeypatch.setattr(quant.LsqFakeQuant, "apply", refuse)
    x = torch.randn(16, requires_grad=True)
    with torch.no_grad():
        out = quant.fake_quant_group(x, [torch.tensor(0.1)], 4)
    assert len(out) == 1 and not out[0].requires_grad


def test_plain_forward_refuses_to_record_a_gradient():
    """torch.round has a zero gradient, so the plain forward raises rather
    than give x and the step a wrong one."""
    x = torch.randn(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="fake_quant"):
        quant.lsq_fake_quant(x, 0.1, 4)
    with torch.no_grad():
        quant.lsq_fake_quant(x, 0.1, 4)


def test_rescale_step_for_bits_matches_jax():
    for old, new in ((4.0, 2.0), (8.0, 4.0), (2.0, 4.0)):
        want = float(jquant.rescale_step_for_bits(jnp.float32(0.3), old,
                                                  new))
        got = float(quant.rescale_step_for_bits(torch.tensor(0.3), old, new))
        assert got == want


def test_step_grad_scale_matches_jax_formula():
    for n, bits in ((1, 8), (1000, 2), (4096 * 2048, 4), (2 ** 25, 8)):
        qmax = 2.0 ** (bits - 1) - 1
        want = float(jax.lax.rsqrt(jnp.maximum(
            float(n) * jnp.float32(qmax), 1.0)))
        # one float32 ulp: XLA's rsqrt and torch's may round apart
        got = quant.lsq_step_grad_scale(n, bits)
        assert abs(got - want) <= np.spacing(np.float32(want))
    # a stacked weight's layers at bits 2, 4, 4 and 2: their mean qmax
    layers = jnp.asarray([2.0, 4.0, 4.0, 2.0])
    mean = jnp.mean(2.0 ** (layers - 1.0) - 1.0).astype(jnp.float32)
    want = float(jax.lax.rsqrt(jnp.maximum(768.0 * mean, 1.0)))
    got = quant.lsq_step_grad_scale(768, 2, quant.mean_qmax([2, 4, 4, 2]))
    assert quant.mean_qmax([2, 4, 4, 2]) == float(mean) == 4.0
    assert abs(got - want) <= np.spacing(np.float32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [(2, 4, 4, 2), (4, 2, 8)])
def test_stacked_mixed_bits_step_grads_match_jax(bits, dtype):
    """The reference fake-quantizes a pattern slot's weights stacked over
    its layers, per-layer steps and bits: every layer's step gradient takes
    rsqrt(n * mean(qmax)) over the layers.  The port quantizes each layer
    alone at its own bits and passes the slot's ``mean_qmax``; the same
    tolerances as above."""
    steps = np.array([0.37, 0.21, 0.6, 0.45][:len(bits)], np.float32)
    x, g = _inputs(dtype, (len(bits), 48, 96), steps)
    jdt = getattr(jnp, dtype)
    b = jnp.asarray(bits, jnp.float32)[:, None, None]
    y, vjp = jax.vjp(lambda a, s: jquant.lsq_fake_quant(a, s, b),
                     jnp.asarray(x).astype(jdt),
                     jnp.asarray(steps)[:, None, None])
    want_gx, want_gs = vjp(jnp.asarray(g).astype(jdt))
    t = getattr(torch, dtype)
    grad_qmax = quant.mean_qmax(bits)
    for layer, lb in enumerate(bits):
        xt = torch.from_numpy(x[layer]).to(t).requires_grad_(True)
        st = torch.tensor(steps[layer]).requires_grad_(True)
        yt = quant.fake_quant(xt, st, float(lb), grad_qmax=grad_qmax)
        yt.backward(torch.from_numpy(g[layer]).to(t))
        np.testing.assert_array_equal(
            yt.detach().float().numpy(),
            np.asarray(y[layer].astype(jnp.float32)))
        np.testing.assert_array_equal(
            xt.grad.float().numpy(),
            np.asarray(want_gx[layer].astype(jnp.float32)))
        err = abs(float(st.grad) - float(want_gs[layer, 0, 0]))
        assert err <= GS_TOL * _gs_scale(x[layer], g[layer], steps[layer],
                                         lb, grad_qmax), (layer, err)


def _grad_operands():
    bf = torch.bfloat16
    req = dict(requires_grad=True)
    q = torch.zeros(1, 1, 8, 64, dtype=bf, **req)
    codes = torch.zeros(1, 8, 1, 64, dtype=torch.int8)
    return [
        ("flash_attention", lambda: cuda.flash_attention(
            q, q.detach(), q.detach())),
        ("quant_matmul", lambda: cuda.quant_matmul(
            torch.zeros(2, 8, dtype=bf, **req),
            torch.zeros(4, 16, dtype=torch.uint8), torch.ones(16), 4)),
        ("kv_decode_attention", lambda: cuda.kv_decode_attention(
            torch.zeros(1, 1, 64, **req), codes, torch.ones(1, 1, 64),
            codes.clone(), torch.ones(1, 8, 1),
            torch.zeros(1, dtype=torch.int32), 8)),
        ("paged_kv_decode_attention", lambda: cuda.paged_kv_decode_attention(
            torch.zeros(1, 1, 64, **req), codes, torch.ones(1, 1, 64),
            codes.clone(), torch.ones(1, 8, 1),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 8)),
        ("histogram", lambda: cuda.histogram(
            torch.zeros(8, **req).int(), 4)),
        ("lsq_fakequant", lambda: cuda.lsq_fakequant(
            torch.zeros(8, **req), 0.1, 4)),
        ("lsq_fakequant", lambda: cuda.lsq_fakequant(
            torch.zeros(8), torch.tensor(0.1, **req), 4)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_forward_only_wrappers_refuse_grad(monkeypatch, case):
    """Every kernel wrapper without a backward raises when grad mode is on
    and an operand requires grad, before any launch; the device check is
    stubbed so the CPU tensors reach the guard, and with grad mode off the
    same call passes it (and reaches the stubbed launch)."""
    launched = []
    monkeypatch.setattr(cuda, "_same_card", lambda name, t: t[0].device)
    monkeypatch.setattr(cuda, "_stream", lambda: 0)
    monkeypatch.setattr(cuda, "_launch", lambda name, *a: launched.append(
        name))
    name, call = _grad_operands()[case]
    if name == "histogram":   # int codes cannot require grad: a float
        monkeypatch.setattr(torch.Tensor, "int", lambda t: t)
    with pytest.raises(RuntimeError, match="no gradient"):
        call()
    assert not launched
    with torch.no_grad():
        try:
            call()
        except ValueError:
            pass            # a shape or dtype check past the guard
    assert launched in ([name], [])


@pytest.mark.parametrize("mode", ["backward", "hvp"])
def test_plain_backward_in_chunks(monkeypatch, mode):
    """A long input at scalar steps goes through the plain backward in
    chunks (``ref.BWD_CHUNK``, here 1000 elements against 64 x 48 + 5):
    gx equal to the whole tensor's at once, each step's gradient within
    1e-12 relative (float64 sums grouped otherwise); and the same under
    HAWQ's ``torch.func.jvp`` of ``torch.func.grad``."""
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(64 * 48 + 5,)), dtype=torch.float32)
    g = [torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)
         for _ in range(2)]
    steps = [torch.tensor(0.11), 0.37]
    c = torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)
    xt = torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)

    def run():
        if mode == "backward":
            return tref.lsq_fakequant_bwd(x, g, steps, 4.0)

        def loss(a, s):
            y = quant.fake_quant(a, s, 4.0, "ref", hvp=True)
            return torch.sum(torch.sin(y) * c)
        _, (gx, gs) = torch.func.jvp(
            torch.func.grad(loss, argnums=(0, 1)),
            (x, steps[0]), (xt, torch.tensor(0.8)))
        return gx, [gs]
    whole = run()
    monkeypatch.setattr(tref, "BWD_CHUNK", 1000)
    chunked = run()
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=0)
    for a, b in zip(chunked[1], whole[1]):
        assert a.shape == b.shape
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b)) + 1e-30
