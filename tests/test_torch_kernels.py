"""Port kernels: each plain PyTorch version (repro_torch/kernels/ref.py)
against the JAX Pallas kernel in interpret mode and the JAX oracle, on the
same numpy inputs; plus CUDA-only cases of each hand-written kernel against
its plain version, which skip without a card.

Tolerances: integer outputs and lsq exact; float outputs within
1e-5 * max|ref| (float32, different summation orders).  The histogram's
and the paged decode's CPU parity with JAX is in test_torch_eagl.py and
test_torch_paging.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

REL = 1e-5


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture
def jax_side():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jops, jref


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------ lsq_fakequant
@pytest.mark.parametrize("shape", [(33,), (4, 7, 64)])
@pytest.mark.parametrize("bits", [2.0, 4.0, 8.0])
def test_lsq_fakequant_exact(jax_side, shape, bits):
    jops, jref = jax_side
    import jax.numpy as jnp
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    # ties: values at exact half steps must round half to even
    x.reshape(-1)[:4] = np.float32(0.1) * np.array([0.5, 1.5, 2.5, -0.5],
                                                    np.float32)
    step = np.float32(0.1)
    want = np.asarray(jops.lsq_fakequant(jnp.asarray(x), jnp.float32(step),
                                         bits, impl="interpret"))
    got = tops.lsq_fakequant(_t(x), _t(step), bits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jref.lsq_fakequant(jnp.asarray(x), jnp.float32(step),
                                           jnp.float32(bits))))


LSQ_GROUP_STEPS = (0.25, 0.1, 3.0)   # chip_smoke.LSQ_PROBE_STEPS


def _bits_of(a):
    """The bits of a torch or numpy float array, as int16 / int32."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16
                   else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_same_bits(got, want):
    """Bit for bit (signed zeros too), NaN where ``want`` is NaN."""
    gn = np.isnan(got.float().numpy())
    wn = np.isnan(np.asarray(want).astype(np.float32)) \
        if not isinstance(want, torch.Tensor) else np.isnan(
            want.float().numpy())
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(_bits_of(got)[~gn], _bits_of(want)[~wn])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_steps", [1, 2, 3])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lsq_grouped_matches_jax(jax_side, bits, n_steps, dtype):
    """The grouped plain version, one output per step, against the JAX
    Pallas kernel in interpret mode at each step, bit for bit, on the
    chip_smoke probe values: NaN, +-inf, signed zeros, ties and near ties
    of every code, both clamp edges, normal values."""
    import chip_smoke
    import jax.numpy as jnp
    jops, _ = jax_side
    tdt = getattr(torch, dtype)
    x = chip_smoke.lsq_probe_values(tdt, LSQ_GROUP_STEPS, torch.device("cpu"))
    steps = [np.float32(v) for v in LSQ_GROUP_STEPS[:n_steps]]
    got = tops.lsq_fakequant(x, [_t(s) for s in steps], bits)
    assert isinstance(got, list) and len(got) == n_steps
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    for g, s in zip(got, steps):
        assert g.dtype == tdt and g.shape == x.shape
        want = jops.lsq_fakequant(xj, jnp.float32(s), float(bits),
                                  impl="interpret")
        _assert_same_bits(g, want)
        _assert_same_bits(g, tref.lsq_fakequant(x, _t(s), bits))


def test_lsq_probe_catches_nan_to_bound():
    """The probe's first value is NaN: a quantizer that clamps NaN to a
    bound (fminf/fmaxf) differs from the plain version on it."""
    import chip_smoke
    x = chip_smoke.lsq_probe_values(torch.bfloat16, LSQ_GROUP_STEPS,
                                    torch.device("cpu"))
    assert torch.isnan(x[0]) and torch.isinf(x[1:3]).all()
    want = tref.lsq_fakequant(x, 0.25, 4)
    assert torch.isnan(want[0])
    assert not chip_smoke.same_bits(torch.nan_to_num(want, nan=-2.0), want)
    assert chip_smoke.same_bits(want.clone(), want)


def test_lsq_grouped_dispatch_and_count(monkeypatch):
    """ops with a list of steps gives a list from one call; with one step
    a tensor; the grouped models fake-quantize each shared input once:
    attention q/k/v then o, the MLP gate/up then down."""
    from repro_torch.configs import olmo_1b
    from repro_torch.models import attention as attn
    from repro_torch.models import common
    from repro_torch.models import mlp
    x = torch.randn(2, 3, 8)
    assert isinstance(tops.lsq_fakequant(x, 0.1, 4), torch.Tensor)
    assert len(tops.lsq_fakequant(x, (0.1, 0.2), 4)) == 2
    cfg = olmo_1b.config().smoke()
    gen = torch.Generator().manual_seed(0)
    pa = attn.init_gqa(gen, cfg, "cpu")
    pm = mlp.init_dense_mlp(gen, cfg, "cpu")
    xs = torch.randn((2, 5, cfg.d_model), generator=gen)
    calls = []
    real = tops.lsq_fakequant

    def counted(x, step, bits, impl="auto"):
        if x.ndim == 3:     # activations; the 2-D weights have their own
            calls.append(len(step) if isinstance(step, (list, tuple))
                         else 0)
        return real(x, step, bits, impl=impl)

    bits = {"attn_qkv": 4.0, "attn_wo": 2.0, "mlp_gateup": 4.0,
            "mlp_down": 2.0}
    pos = torch.arange(5)[None].expand(2, 5)
    monkeypatch.setattr(tops, "lsq_fakequant", counted)
    y_attn, _ = attn.gqa_apply(pa, xs, bits, cfg, "train", None, pos)
    attn_calls, calls[:] = list(calls), []
    y_mlp = mlp.dense_mlp_apply(pm, xs, bits)
    mlp_calls, calls[:] = list(calls), []
    sep = [common.qproj(xs, pm[k], 4.0) for k in ("gate", "up")]
    grouped = common.qproj_group(xs, (pm["gate"], pm["up"]), 4.0)
    assert attn_calls == [3, 1] and mlp_calls == [2, 1]
    assert y_attn.shape == y_mlp.shape == xs.shape
    assert all(torch.equal(a, b) for a, b in zip(sep, grouped))


# ------------------------------------------------------------- quant_matmul
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m,k,n", [(3, 64, 40), (8, 256, 128),
                                   # the card tests' ragged tiled shapes: a
                                   # partial last 64-deep K step
                                   (129, 520, 200), (129, 72, 200)])
def test_quant_matmul_ref_matches_pallas(jax_side, bits, m, k, n):
    jops, jref = jax_side
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    codes = rng.integers(lo, hi + 1, size=(k, n))
    x = rng.normal(size=(m, k)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, size=(n,)).astype(np.float32)
    jpack = jref.pack_w4 if bits == 4 else jref.pack_w2
    tpack = tref.pack_w4 if bits == 4 else tref.pack_w2
    wp = np.asarray(jpack(jnp.asarray(codes)))
    np.testing.assert_array_equal(tpack(_t(codes)).numpy(), wp)
    tunpack = tref.unpack_w4 if bits == 4 else tref.unpack_w2
    np.testing.assert_array_equal(tunpack(_t(wp), torch.float32).numpy(),
                                  codes)
    # ragged M and N: the Pallas kernel runs on tile-multiple shapes, the
    # port's plain version (and CUDA kernel) on the ragged ones directly
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jnp.asarray(wp),
                                        jnp.asarray(scale), bits,
                                        impl="interpret", bm=m, bn=n,
                                        bk=k))
    f = tref.quant_matmul_w4 if bits == 4 else tref.quant_matmul_w2
    got = f(_t(x), _t(wp), _t(scale)).numpy()
    _close(got, want)
    jf = jref.quant_matmul_w4 if bits == 4 else jref.quant_matmul_w2
    _close(got, jf(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale)))
    # the CPU serving path: dequantize then matmul (JAX's CPU op order)
    _close(tref.dequant_matmul(_t(x), _t(wp), _t(scale), bits).numpy(),
           jref.dequant_matmul(jnp.asarray(x), jnp.asarray(wp),
                               jnp.asarray(scale), bits))


# ------------------------------------------------------ kv_decode_attention
def _kv_inputs(bits, b=3, s=24, hkv=2, group=2, d=32, seed=2):
    from repro_torch.kernels import kv_quant
    rng = np.random.default_rng(seed)
    h = hkv * group
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = torch.as_tensor(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    lengths = torch.tensor([s, 5, 11], dtype=torch.int32)[:b]
    qc = kv_quant.quantize_prefill({"k": k, "v": v}, lengths, bits)
    # one slot off range (an inactive slot pinned at max_seq)
    positions = np.array([s, 4, 10], np.int32)[:b]
    return q, {kk: vv.numpy() for kk, vv in qc.items()}, positions


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_decode_ref_matches_pallas(jax_side, bits):
    jops, jref = jax_side
    import jax.numpy as jnp
    q, c, pos = _kv_inputs(bits)
    args = (q, c["kq"], c["k_scale"], c["vq"], c["v_scale"], pos)
    want = np.asarray(jops.kv_cache_attention(
        *[jnp.asarray(a) for a in args], bits, impl="interpret"))
    got = tops.kv_cache_attention(*[_t(a) for a in args], bits).numpy()
    assert got.dtype == np.float32
    _close(got, want)
    _close(got, jref.kv_cache_attention(*[jnp.asarray(a) for a in args],
                                        bits))


# ---------------------------------------------------------- flash_attention
FLASH_PALLAS_CASES = [  # group, causal, (b, hkv, s, d), Pallas bq = bk
    pytest.param(g, c, (2, 2, 32, 32), 16, id=f"{g}-{c}")
    for g in (1, 2) for c in (True, False)] + [
    pytest.param(4, c, (1, 1, 256, 128), 64, id=f"4-{c}-d128")
    for c in (True, False)]


@pytest.mark.parametrize("group,causal,shape,blk", FLASH_PALLAS_CASES)
def test_flash_ref_matches_pallas(jax_side, group, causal, shape, blk):
    jops, jref = jax_side
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    b, hkv, s, d = shape
    q = rng.normal(size=(b, hkv * group, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    want = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=causal,
                                           impl="interpret", bq=blk, bk=blk))
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    _close(got, want)


def test_chunked_attention_matches_jax(jax_side):
    """The port's CPU prefill attention (ragged S: pad rows masked), and
    each side against float64 attention on the same inputs, so that a
    failure names the side that moved.  Measured on a CPU host: |port - JAX|
    is 7.2e-7 at torch threads 1, 2, 4 and 6, and 2.4e-7 with XLA's
    single-threaded Eigen; each side lies within 6.7e-7 of float64.  The
    tolerance, 1e-5 * max|ref| (3.0e-5), holds 40x that."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 40, 4, 32)).astype(np.float32)
               for _ in range(3))
    chunk = 16
    n = -(-40 // chunk)
    kp = jnp.pad(jnp.asarray(k), ((0, 0), (0, n * chunk - 40), (0, 0),
                                  (0, 0)))
    vp = jnp.pad(jnp.asarray(v), ((0, 0), (0, n * chunk - 40), (0, 0),
                                  (0, 0)))

    def kv_fn(i):
        import jax
        return (jax.lax.dynamic_slice_in_dim(kp, i * chunk, chunk, axis=1),
                jax.lax.dynamic_slice_in_dim(vp, i * chunk, chunk, axis=1))

    want = np.asarray(jattn.chunked_attention(jnp.asarray(q), kv_fn, n, chunk,
                                              causal=True))
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), chunk, True).numpy()
    logits = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                       k.astype(np.float64)) * 32 ** -0.5
    logits = np.where(np.tril(np.ones((40, 40), bool)), logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    exact = np.einsum("bhst,bthd->bshd", p / p.sum(-1, keepdims=True),
                      v.astype(np.float64))
    _close(want, exact)
    _close(got, exact)
    _close(got, want)


@pytest.mark.parametrize("s,s_virt,off", [(16, 64, 32), (7, 48, 16),
                                          (24, 40, 16)])
def test_chunked_attention_offset_matches_jax(jax_side, s, s_virt, off):
    """The suffix prefill's CPU attention: queries at positions [off,
    off + S) over a window of S_virt keys (rows past the suffix causally
    masked), chunks of 16 with a ragged last one, against JAX's
    ``chunked_attention`` with the same ``q_offset``; tolerance 1e-5 *
    max|ref| as for the whole-prompt case above."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, s, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(1, s_virt, 4, 32)).astype(np.float32)
            for _ in range(2))
    chunk = 16
    n = -(-s_virt // chunk)
    kp, vp = (jnp.pad(jnp.asarray(a), ((0, 0), (0, n * chunk - s_virt),
                                       (0, 0), (0, 0))) for a in (k, v))

    def kv_fn(i):
        return (jax.lax.dynamic_slice_in_dim(kp, i * chunk, chunk, axis=1),
                jax.lax.dynamic_slice_in_dim(vp, i * chunk, chunk, axis=1))

    want = np.asarray(jattn.chunked_attention(jnp.asarray(q), kv_fn, n, chunk,
                                              causal=True, q_offset=off))
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), chunk, True,
                                  q_offset=off).numpy()
    _close(got, want)


@pytest.mark.parametrize("group", [1, 4])
def test_flash_plain_offset_is_the_whole_prompts_tail(group):
    """The plain flash_attention with Sk > Sq aligns the queries
    bottom-right: its rows are the last Sq rows of the whole prompt's
    attention (the suffix prefill's contract), to float32 rounding."""
    g = torch.Generator().manual_seed(6)
    q = torch.randn((1, 2 * group, 40, 16), generator=g)
    k, v = (torch.randn((1, 2, 40, 16), generator=g) for _ in range(2))
    whole = tops.flash_attention(q, k, v, causal=True, impl="ref")
    tail = tops.flash_attention(q[:, :, 24:], k, v, causal=True, impl="ref")
    torch.testing.assert_close(tail, whole[:, :, 24:], rtol=0, atol=1e-6)


# ---------------------------------------------------- CUDA kernel vs plain
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card (run `python3 chip_smoke.py` there)")
    return torch.device("cuda")


def _cuda_qmm_case(card, bits, m, k, n, dtype=torch.bfloat16, seed=0):
    """The kernel and its plain version on one random shape; the plain
    version rounds x to bf16 as the kernel does."""
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    codes = torch.randint(lo, hi, (k, n), generator=g, device=card)
    wp = (tref.pack_w4 if bits == 4 else tref.pack_w2)(codes)
    x = torch.randn((m, k), generator=g, device=card).to(dtype)
    scale = torch.rand((n,), generator=g, device=card) * 0.1 + 0.01
    got = cuda.quant_matmul(x, wp, scale, bits)
    f = tref.quant_matmul_w4 if bits == 4 else tref.quant_matmul_w2
    return got, f(x, wp, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m", [1, 5, 16, 17, 100, 128, 129, 300])
def test_cuda_quant_matmul(card, bits, m):
    """The GEMV (M <= 16) and the tensor-core kernel (M > 16) at a ragged
    N = 200."""
    got, want = _cuda_qmm_case(card, bits, m, 512, 200)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * want.abs().max()          # 1 bf16 ulp of max|ref|
    assert (got.float() - want).abs().max() <= ulp


@pytest.mark.cuda
@pytest.mark.parametrize("bits,m,k,n", [
    # mma.sync: partial last K step, 4-byte code copies
    (4, 129, 520, 200),
    (2, 129, 72, 200),
    # mma.sync: K % 8 != 0 (4-byte x copies), odd N (byte loads)
    (4, 129, 66, 37),
    (2, 17, 68, 37),
    # wgmma: partial last K step and ragged M zero-filled by TMA
    (2, 300, 520, 256),
    (4, 17, 72, 256),
    (4, 4099, 2048, 2048),  # ragged M at a projection's width
])
def test_cuda_quant_matmul_tiled_ragged(card, bits, m, k, n):
    got, want = _cuda_qmm_case(card, bits, m, k, n, seed=1)
    ulp = 2.0 ** -7 * want.abs().max()
    assert (got.float() - want).abs().max() <= ulp


@pytest.mark.cuda
@pytest.mark.parametrize("m", [129, 8])
@pytest.mark.parametrize("n", [256, 200])
def test_cuda_quant_matmul_misaligned_views(card, n, m):
    """x 2 bytes and wp 4 bytes past a 16-byte boundary: the wrapper copies
    what a route's 16-byte copies cannot read, so the shape alone picks the
    route (wgmma at N = 256, mma.sync at N = 200); the GEMV (M = 8) reads
    such x and codes as they are, by 4-byte and 2-byte loads."""
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(4)
    k, bits = 520, 4
    codes = torch.randint(-8, 8, (k, n), generator=g, device=card)
    packed = tref.pack_w4(codes)
    wbuf = torch.empty(packed.numel() + 16, dtype=torch.uint8, device=card)
    wp = wbuf[4:4 + packed.numel()].view(packed.shape)
    wp.copy_(packed)
    xbuf = torch.randn((m * k + 8,), generator=g, device=card).bfloat16()
    x = xbuf[1:1 + m * k].view(m, k)
    assert x.data_ptr() % 16 and wp.data_ptr() % 16
    scale = torch.rand((n,), generator=g, device=card) * 0.1 + 0.01
    got = cuda.quant_matmul(x, wp, scale, bits).float()
    want = tref.quant_matmul_w4(x, wp, scale)
    assert (got - want).abs().max() <= 2.0 ** -7 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m", [8, 129])
def test_cuda_quant_matmul_float32(card, bits, m):
    """float32 x: the kernel multiplies bf16(x) and writes float32."""
    got, want = _cuda_qmm_case(card, bits, m, 520, 200, torch.float32, 2)
    assert got.dtype == torch.float32
    ulp = 2.0 ** -7 * want.abs().max()
    assert (got - want).abs().max() <= ulp


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 2])
def test_cuda_quant_matmul_identity_probe(card, bits):
    """x = the K x K identity, packed bytes cycling through all 256 values
    in every row: each output is code * scale rounded once to bf16, so the
    kernel equals codes * scale bit for bit.  A wrong lane byte or bit
    offset, or a wrong swizzled row, moves a code to another output."""
    from repro_torch.kernels import cuda
    k = n = 256
    r = torch.arange(k // (8 // bits), device=card)[:, None]
    wp = ((r + torch.arange(n, device=card)[None, :]) % 256).to(torch.uint8)
    scale = torch.rand((n,), generator=torch.Generator(card).manual_seed(3),
                       device=card) + 0.5
    x = torch.eye(k, device=card, dtype=torch.bfloat16)
    got = cuda.quant_matmul(x, wp, scale, bits)
    unpack = tref.unpack_w4 if bits == 4 else tref.unpack_w2
    want = (unpack(wp, torch.float32) * scale[None]).to(torch.bfloat16)
    assert torch.equal(got, want)
    f = tref.quant_matmul_w4 if bits == 4 else tref.quant_matmul_w2
    assert torch.equal(got, f(x, wp, scale).to(torch.bfloat16))


# the olmo-1b decode projections (K, N): q, k, v, o; gate, up; down
OLMO_DECODE_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048)]
GEMV_SHAPES = [(4, 520, 200), (2, 520, 200), (4, 520, 37), (2, 520, 37),
               (4, 66, 37), (2, 68, 37), (4, 66, 200), (2, 68, 200)] + [
    (bits, k, n) for bits in (4, 2) for (k, n) in OLMO_DECODE_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits,k,n", GEMV_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 5, 8, 9, 16])
def test_cuda_quant_matmul_gemv(card, m, bits, k, n, dtype):
    """The GEMV route at every M of one and two token tiles, ragged N (37:
    byte loads; 200: 4-byte loads), a partial last K step (520; 66 at int4,
    68 at int2) and the three olmo-1b decode shapes, split-K and not;
    within 1 bf16 ulp of max|ref|, in x's dtype."""
    from repro_torch.kernels import cuda
    assert cuda.quant_matmul_route(m, n, k) == "gemv"
    got, want = _cuda_qmm_case(card, bits, m, k, n, dtype, seed=5)
    assert got.dtype == dtype
    assert (got.float() - want).abs().max() <= 2.0 ** -7 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m", [16, 8, 5])
def test_cuda_gemv_selector_probe(card, bits, m):
    """K = N = 256, packed bytes cycling through all 256 values, x rows
    one-hot: over ceil(K / M) calls a 1 lands on every K position, so each
    output is one code times its scale, rounded once to bf16 -- bit for
    bit.  It pins every lane's byte, bit offset and channel permutation,
    the order x is staged in and each K slice of the plan."""
    import chip_smoke
    from repro_torch.kernels import cuda
    assert cuda.gemv_plan(m, 256, 256, bits)[0] > 1
    assert chip_smoke.gemv_selector_probe(card, bits, m)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("k,n", OLMO_DECODE_SHAPES)
def test_cuda_gemv_repeats_bit_for_bit(card, bits, k, n):
    """Split-K adds the slices in a fixed order, never with floating-point
    atomics: two calls on the same inputs are equal."""
    from repro_torch.kernels import cuda
    assert cuda.gemv_plan(8, n, k, bits)[0] > 1
    got, _ = _cuda_qmm_case(card, bits, 8, k, n, seed=6)
    again, _ = _cuda_qmm_case(card, bits, 8, k, n, seed=6)
    assert torch.equal(got, again)


# (B, S, Hkv) of the card's decode cases: S not a multiple of the plan's C
# (C = 16 over 19 splits; C = 96 over 11), and a plan of one split
DECODE_SHAPES = [(6, 300, 2), (6, 16, 2), (6, 1000, 4)]


def _decode_positions(s, c):
    """Positions 0, C - 1, C, C + 1, the last row and past the end (an
    inactive slot pinned at max_seq)."""
    return [0, c - 1, c, c + 1, s - 1, s]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_kv_decode(card, bits, d, group, dtype, shape):
    """Within 1e-4 * max|ref| of the plain version at positions around the
    plan's first chunk boundary, the last row and past it; two calls equal
    bit for bit (the splits merge in a fixed order).  A group of 3 leaves
    one of a block's 4 warps idle; a group of 8 takes two rounds over the
    chunk."""
    from repro_torch.kernels import cuda, kv_quant
    b, s, hkv = shape
    g = torch.Generator(card).manual_seed(5)
    splits, c = cuda.decode_plan(b, hkv, group, s, bits)
    assert (splits == 1) == (s <= c)
    k = torch.randn((b, s, hkv, d), generator=g, device=card)
    v = torch.randn((b, s, hkv, d), generator=g, device=card)
    qc = kv_quant.quantize_prefill({"k": k, "v": v}, torch.full(
        (b,), s, dtype=torch.int32, device=card), bits)
    q = torch.randn((b, hkv * group, d), generator=g, device=card).to(dtype)
    pos = torch.tensor(_decode_positions(s, c), dtype=torch.int32,
                       device=card)
    args = (q, qc["kq"], qc["k_scale"], qc["vq"], qc["v_scale"], pos)
    got = cuda.kv_decode_attention(*args, bits)
    want = tref.kv_cache_attention(*args, bits)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(got, cuda.kv_decode_attention(*args, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "model"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 300, 513])
def test_cuda_flash(card, s, d, group, causal, layout):
    """Ragged S around the 64-row tiles, both head dims, GQA groups, and
    the model's own (B, S, H, D) projections passed as (B, H, S, D) views
    (non-contiguous in S), as attention.py's prefill does."""
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(1)
    b, hkv = 2, 2

    def make(heads):
        if layout == "model":
            x = torch.randn((b, s, heads, d), generator=g, device=card)
            return x.bfloat16().transpose(1, 2)
        return torch.randn((b, heads, s, d), generator=g,
                           device=card).bfloat16()

    q, k, v = make(hkv * group), make(hkv), make(hkv)
    got = cuda.flash_attention(q, k, v, causal=causal).float()
    # the plain version in float32: in bf16 its scores round to bf16
    # before the softmax, which costs it more than the kernel's error
    want = tops.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal, impl="ref")
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()
    # each query row too: late causal rows are far smaller than max|ref|
    row = torch.linalg.vector_norm(got - want, dim=-1)
    assert (row <= 1e-2 * torch.linalg.vector_norm(want, dim=-1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "model"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("off", [16, 256, 496])
@pytest.mark.parametrize("s", [1, 16, 37, 200])
def test_cuda_flash_offset(card, s, off, d, group, layout):
    """Keys longer than the queries (Sk = off + Sq, the suffix prefill):
    ragged Sq, page-aligned offsets, both head dims, GQA groups and the
    model's transposed views, against the plain version in float32 with
    the flash tolerance (max-abs and per row); and each row bit for bit
    the same row of the whole prompt's call (a row's result does not
    depend on which q tile holds it)."""
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(2)
    b, hkv, s_k = 1, 2, off + s

    def make(heads, n):
        if layout == "model":
            x = torch.randn((b, n, heads, d), generator=g, device=card)
            return x.bfloat16().transpose(1, 2)
        return torch.randn((b, heads, n, d), generator=g,
                           device=card).bfloat16()

    q_all, k, v = make(hkv * group, s_k), make(hkv, s_k), make(hkv, s_k)
    q = q_all[:, :, off:]
    got = cuda.flash_attention(q, k, v, causal=True)
    want = tops.flash_attention(q.float(), k.float(), v.float(), causal=True,
                                impl="ref")
    err = got.float() - want
    assert err.abs().max() <= 1e-2 * want.abs().max()
    row = torch.linalg.vector_norm(err, dim=-1)
    assert (row <= 1e-2 * torch.linalg.vector_norm(want, dim=-1)).all()
    whole = cuda.flash_attention(q_all, k, v, causal=True)
    assert torch.equal(got, whole[:, :, off:])


@pytest.mark.cuda
def test_cuda_flash_refuses_short_keys(card):
    """Sk < Sq has no bottom-right alignment: the wrapper refuses it."""
    from repro_torch.kernels import cuda
    q = torch.zeros((1, 2, 32, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        cuda.flash_attention(q, q[:, :, :16], q[:, :, :16])


def _selector_probe(dev, h, hkv, s, causal=True):
    import chip_smoke
    return chip_smoke.flash_selector_probe(dev, 1, h, hkv, s, causal=causal)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("s", [128, 129, 300, 513])
def test_flash_selector_probe_plain(h, hkv, s):
    """The selector probe itself, on the plain version: every score but the
    selected one underflows to 0, so row i is V[pi(i)] exactly."""
    q, k, v, want = _selector_probe(torch.device("cpu"), h, hkv, s)
    got = tops.flash_attention(q, k, v, causal=True, impl="ref")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(16, 16), (16, 4)])
@pytest.mark.parametrize("s", [128, 129, 300, 513])
def test_cuda_flash_selector_probe(card, h, hkv, s):
    """The kernel on the selector probe, bit for bit: a wrong row mapping,
    V transpose, kv-tile offset or swizzled row selects another row of V."""
    from repro_torch.kernels import cuda
    q, k, v, want = _selector_probe(card, h, hkv, s)
    assert torch.equal(cuda.flash_attention(q, k, v, causal=True), want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(16, 16), (16, 4)])
@pytest.mark.parametrize("s,off", [(16, 256), (37, 16), (200, 496),
                                   (1, 512)])
def test_cuda_flash_selector_probe_offset(card, h, hkv, s, off):
    """The causal selector probe with the queries cut to the last Sq rows:
    query row i sits at position off + i, so it must select
    V[pos(pi(off + i))] bit for bit; a wrong q_off in the mask, the
    kv-tile count or the edge test selects another row or none."""
    from repro_torch.kernels import cuda
    q, k, v, want = _selector_probe(card, h, hkv, off + s)
    got = cuda.flash_attention(q[:, :, off:], k, v, causal=True)
    assert torch.equal(got, want[:, :, off:])


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("s", [128, 129, 300, 513])
def test_flash_selector_probe_spread_plain(h, hkv, s):
    """The non-causal selector probe on the plain version: its one-hot keys
    lie at random positions, the last one always among them, and row i is
    the V row at the selected key's position exactly."""
    q, k, v, want = _selector_probe(torch.device("cpu"), h, hkv, s,
                                    causal=False)
    n_tiles = -(-s // 64)
    key_tiles = torch.nonzero(k.float().abs().sum(-1))[:, -1] // 64
    assert set(key_tiles.tolist()) == set(range(n_tiles))
    got = tops.flash_attention(q, k, v, causal=False, impl="ref")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(16, 16), (16, 4)])
@pytest.mark.parametrize("s", [128, 129, 300, 513])
def test_cuda_flash_selector_probe_spread(card, h, hkv, s):
    """The kernel on the non-causal selector probe, bit for bit: selected
    keys in every kv tile pin each tile's offset and both phases of the
    copy ring."""
    from repro_torch.kernels import cuda
    q, k, v, want = _selector_probe(card, h, hkv, s, causal=False)
    assert torch.equal(cuda.flash_attention(q, k, v, causal=False), want)


@pytest.mark.cuda
def test_cuda_lsq_exact(card):
    """The random case, then the chip_smoke probe: NaN, +-inf, ties and
    near ties, clamp edges, lengths 1, 7 and 8k + 3, bf16 and float32,
    bits 2/4/8, 1-3 steps as tensors and as floats, bit for bit."""
    import chip_smoke
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(2)
    x = torch.randn((3, 1000), generator=g, device=card).bfloat16()
    step = torch.tensor(0.05, device=card)
    for bits in (2, 4, 8):
        torch.testing.assert_close(cuda.lsq_fakequant(x, step, bits),
                                   tref.lsq_fakequant(x, step, bits),
                                   rtol=0, atol=0)
    calls, bad = chip_smoke.lsq_probe(card)
    assert calls == 144 and not bad, bad


LSQ_BWD_SHAPES = [((8 * 512, 2048), 3), ((8 * 512, 8192), 1),
                  ((2048, 8192), 1), ((8 * 1000 + 3,), 3), ((5,), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,n_steps", LSQ_BWD_SHAPES)
def test_cuda_lsq_bwd_matches_plain(card, shape, n_steps, dtype):
    """The backward kernel at chip_smoke's phase 3 shapes (q/k/v's and the
    down projection's train inputs, a gate/up weight, a ragged length and
    a length below one vector): gx bit for bit, each gs within 1e-5 *
    gscale * sum|g * ds| of the plain version (the sums' orders differ; both
    add in float64); two launches equal; one launch counted."""
    import chip_smoke
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(3)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    grads = [torch.randn(shape, generator=g, device=card).to(dtype)
             for _ in range(n_steps)]
    steps = [torch.tensor(v, device=card) if k != 1 else v
             for k, v in enumerate((0.31, 0.7, 1.7)[:n_steps])]
    for bits in (2, 4, 8):
        equal, worst, _ = chip_smoke.lsq_bwd_compare(x, grads, steps, bits)
        assert equal and worst <= 1.0, (bits, equal, worst)
    before = cuda.LAUNCHES["lsq_fakequant_bwd"]
    a = cuda.lsq_fakequant_bwd(x, grads, steps, 4)
    b = cuda.lsq_fakequant_bwd(x, grads, steps, 4)
    assert cuda.LAUNCHES["lsq_fakequant_bwd"] == before + 2
    assert torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in
                                           zip(a[1], b[1]))


@pytest.mark.cuda
def test_cuda_lsq_bwd_autograd_matches_ref(card):
    """LsqFakeQuant on a CUDA tensor runs both kernels (the counters move)
    and gives the gradients of impl="ref" (gx exactly, the steps within
    1e-6 relative)."""
    from repro_torch.core import quant
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(4)
    x0 = torch.randn((64, 512), generator=g, device=card).bfloat16()
    cot = [torch.randn(x0.shape, generator=g, device=card).bfloat16()
           for _ in range(3)]
    out = {}
    for impl in ("auto", "ref"):
        x = x0.clone().requires_grad_(True)
        steps = [torch.tensor(v, device=card, requires_grad=True)
                 for v in (0.2, 0.3, 0.5)]
        before = dict(cuda.LAUNCHES)
        ys = quant.fake_quant_group(x, steps, 4, impl)
        torch.autograd.backward(ys, cot)
        moved = {k: cuda.LAUNCHES[k] - before[k] for k in before}
        out[impl] = (x.grad, [s.grad for s in steps], moved)
    assert out["auto"][2]["lsq_fakequant"] == 1
    assert out["auto"][2]["lsq_fakequant_bwd"] == 1
    assert not any(out["ref"][2].values())
    assert torch.equal(out["auto"][0], out["ref"][0])
    for a, b in zip(out["auto"][1], out["ref"][1]):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


@pytest.mark.cuda
def test_cuda_lsq_refuses_misaligned(card):
    """An x off a 16-byte boundary raises in the wrapper; ops copies it
    to an aligned buffer and launches."""
    from repro_torch.kernels import cuda
    buf = torch.zeros(1003, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cuda.lsq_fakequant(buf[3:], 0.1, 4)
    before = cuda.LAUNCHES["lsq_fakequant"]
    got = tops.lsq_fakequant(buf[3:], [0.1, 0.2], 4)
    assert cuda.LAUNCHES["lsq_fakequant"] == before + 1 and len(got) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_bins", [
    (2048 * 8192, 16), (2048 * 8192, 4), (1_000_003, 16), (1_000_003, 4),
    (1_000_003, 1), (1_000_003, 17), (1_000_003, 4096), (5, 4096), (3, 16),
    (0, 4)])
def test_cuda_histogram_exact(card, n, n_bins):
    """Exact against the plain version, with negatives and the sentinel
    n_bins in the codes and ragged lengths, through the register path
    (n_bins <= 16) and the shared one; two calls in a row equal (the
    counters reset)."""
    from repro_torch.kernels import cuda
    g = torch.Generator(card).manual_seed(3)
    codes = torch.randint(-3, n_bins + 3, (n,), generator=g, device=card,
                          dtype=torch.int32)
    first = cuda.histogram(codes, n_bins)
    assert torch.equal(first, tref.histogram(codes, n_bins))
    assert torch.equal(cuda.histogram(codes, n_bins), first)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 19])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("bits,h,hkv", [(8, 16, 16), (4, 16, 16), (4, 16, 4),
                                        (8, 4, 2)])
def test_cuda_paged_kv_decode(card, bits, h, hkv, d, n):
    """Bit for bit the contiguous kernel on the gathered cache, within
    1e-4 * max|ref| of the plain version, over a shuffled table with stale
    and -1 entries and NaN-poisoned free pages (chip_smoke's case), at
    positions on page and chunk boundaries, the last row and past it, with
    n * page a multiple of the plan's C (n = 64) and not (n = 19)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import cuda, kv_quant
    g = torch.Generator(card).manual_seed(4)
    b, page = 8, 16
    s = n * page
    c = cuda.decode_plan(b, hkv, h // hkv, s, bits)[1]
    pos = torch.tensor([0, 15, 16] + _decode_positions(s, c)[1:],
                       dtype=torch.int32, device=card)
    q, qc, (kqp, vqp, vsp), tbl = chip_smoke.paged_case(
        g, card, bits, b, h, hkv, d, n, page, pos)
    args = (q, kqp, qc["k_scale"], vqp, vsp, tbl, pos)
    got = cuda.paged_kv_decode_attention(*args, bits)
    gathered = (q, kv_quant.gather_pages(kqp, tbl), qc["k_scale"],
                kv_quant.gather_pages(vqp, tbl),
                kv_quant.gather_pages(vsp, tbl), pos)
    assert torch.equal(got, cuda.kv_decode_attention(*gathered, bits))
    assert torch.equal(got, cuda.paged_kv_decode_attention(*args, bits))
    want = tref.paged_kv_cache_attention(*args, bits)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("hkv", [4, 1])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_decode_selector_probe_plain(bits, layout, hkv):
    """The decode selector probe itself, on the plain versions: every logit
    but the selected row's is exactly 0, 200 below it, so each output is
    the selected V row exactly, in both layouts."""
    import chip_smoke
    calls, splits, c, same = chip_smoke.kv_decode_selector_probe(
        torch.device("cpu"), bits, layout, b=2, h=4, hkv=hkv, s=256, d=64,
        impl="ref")
    assert splits > 1 and same


@pytest.mark.cuda
@pytest.mark.parametrize("hkv", [16, 4])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_kv_decode_selector_probe(card, bits, layout, hkv):
    """The kernels on the selector probe, bit for bit, with the selected
    rows at the first, middle and last row of every chunk of the plan: a
    wrong chunk offset, row, lane byte, nibble, page entry or merge weight
    selects or mixes in another V row."""
    import chip_smoke
    assert chip_smoke.kv_decode_selector_probe(card, bits, layout,
                                               hkv=hkv)[3]


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(card):
    """ops on a CUDA tensor launch the kernel (the counter moves)."""
    from repro_torch.kernels import cuda
    before = cuda.LAUNCHES["lsq_fakequant"]
    tops.lsq_fakequant(torch.ones(8, device=card), 0.1, 4)
    assert cuda.LAUNCHES["lsq_fakequant"] == before + 1


def test_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import cuda
    with pytest.raises(ValueError, match="CUDA"):
        cuda.lsq_fakequant(torch.ones(4), 0.1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.flash_attention(*(torch.ones(1, 1, 8, 64, dtype=torch.bfloat16)
                               for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA"):
        cuda.histogram(torch.zeros(8, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.kv_decode_attention(
            torch.ones(1, 2, 64), torch.zeros(1, 4, 2, 64, dtype=torch.int8),
            torch.ones(1, 2, 64), torch.zeros(1, 4, 2, 64, dtype=torch.int8),
            torch.ones(1, 4, 2), torch.zeros(1, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.paged_kv_decode_attention(
            torch.ones(1, 2, 64), torch.zeros(3, 4, 2, 64, dtype=torch.int8),
            torch.ones(1, 2, 64), torch.zeros(3, 4, 2, 64, dtype=torch.int8),
            torch.ones(3, 4, 2), torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="impl"):
        tops.use_kernel(torch.ones(1), "pallas")


@pytest.mark.parametrize("bits", [4, 2])
def test_packed_matmul_pads_ragged_k(bits):
    """K not divisible by the pack factor: the activations are zero-padded
    to the packed K, whose padding rows hold zero codes."""
    from repro_torch.core import quant
    rng = np.random.default_rng(5)
    w = _t(rng.normal(size=(67, 24)).astype(np.float32) * 0.1)
    p = quant.pack_linear(w, 0.03, 0.5, bits)
    assert p.k_padded == 68 and p.k_dim == 67
    x = _t(rng.normal(size=(3, 67)).astype(np.float32))
    got = tops.packed_matmul(x, p).numpy()
    want = (x.double() @ quant.packed_weight_dense(p).double()).numpy()
    _close(got, want)
    with pytest.raises(ValueError, match="K=66"):
        tops.packed_matmul(x[:, :66], p)


def test_quant_matmul_route():
    """The GEMV for M <= 16; above it wgmma where TMA's 16-byte row strides
    hold (K % 8 == 0 for bf16 x, N % 16 == 0 for the codes), mma.sync
    elsewhere: every olmo-1b projection takes wgmma in prefill, and the
    card tests' N = 200 and 37 and K = 66 take mma.sync."""
    from repro_torch.kernels import cuda
    assert cuda.quant_matmul_route(16, 2048, 2048) == "gemv"
    for n, k in ((2048, 2048), (8192, 2048), (2048, 8192), (256, 520)):
        assert cuda.quant_matmul_route(4096, n, k) == "wgmma"
    for n, k in ((200, 520), (37, 64), (256, 66), (2048, 0)):
        assert cuda.quant_matmul_route(17, n, k) == "mma.sync"


@pytest.mark.parametrize("bits,k,n", [
    (bits, k, n) for bits in (4, 2) for (k, n) in OLMO_DECODE_SHAPES + [
        (520, 200), (520, 37), (256, 256), (8, 16), (0, 64), (2048 * 5, 128)]]
    + [(4, 66, 37), (2, 68, 37), (4, 2, 8)])
def test_gemv_plan(bits, k, n):
    """The GEMV's K plan: whole K steps of the packed layout (8 packed rows:
    16 K at int4, 32 at int2), slices that cover K exactly once, none empty
    and none past GEMV_SLICE_MAX_K; at least 128 blocks (one on each of
    128 of an H100's 132 SMs) for every olmo-1b decode shape.  M does not
    change it."""
    from repro_torch.kernels import cuda
    kc = cuda.GEMV_STEP_ROWS * (8 // bits)
    slices, per = cuda.gemv_plan(8, n, k, bits)
    assert all(cuda.gemv_plan(m, n, k, bits) == (slices, per)
               for m in (1, 5, 9, 16))
    assert per * kc <= cuda.GEMV_SLICE_MAX_K and per >= 1
    bounds = [(s * per * kc, min((s + 1) * per * kc, k)) for s in
              range(slices)]
    assert all(lo % kc == 0 for lo, _ in bounds)
    covered = [kk for lo, hi in bounds for kk in range(lo, hi)]
    assert covered == list(range(k))
    assert k == 0 or all(hi > lo for lo, hi in bounds)
    if (k, n) in OLMO_DECODE_SHAPES:  # one block on 128 of the 132 SMs
        assert -(-n // cuda.GEMV_CHANNELS) * slices >= 128 and slices > 1
    # the card tests' ragged shapes run a plan of one slice and of several
    if (bits, k, n) in ((2, 68, 37), (4, 2, 8)):
        assert slices == 1
    if (k, n) == (520, 37):
        assert slices > 1
    with pytest.raises(ValueError, match="M must be"):
        cuda.gemv_plan(17, n, k, bits)


DECODE_PLAN_CASES = [  # (B, Hkv, group, rows)
    (8, 16, 1, 1024),     # olmo-1b serving: max_seq 1024
    (8, 4, 4, 1024),      # GQA 16/4
    (8, 16, 1, 19 * 16),
    (1, 16, 1, 1024),
    (6, 2, 2, 300), (6, 2, 1, 16), (6, 4, 4, 1000), (3, 2, 2, 24),
    (2, 2, 8, 300),       # a group of 8 takes two rounds over a chunk
    (8, 16, 1, 8192), (1, 1, 1, 200_000), (1, 1, 1, 1)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b,hkv,group,rows", DECODE_PLAN_CASES)
def test_decode_plan(b, hkv, group, rows, bits):
    """Decode attention's split: chunks of whole 16-row units (whole pages
    of 16) that cover every row exactly once, none empty, at most
    DECODE_MAX_SPLITS of them; the same at both widths.  At the serve
    shapes, C = 128 and at least two waves of blocks over 132 SMs."""
    from repro_torch.kernels import cuda
    splits, c = cuda.decode_plan(b, hkv, group, rows, bits)
    assert c % 16 == 0 and c >= 16
    assert 1 <= splits <= cuda.DECODE_MAX_SPLITS
    bounds = [(k * c, min((k + 1) * c, rows)) for k in range(splits)]
    assert all(hi > lo for lo, hi in bounds)
    assert [r for lo, hi in bounds for r in range(lo, hi)] == list(
        range(rows))
    assert cuda.decode_plan(b, hkv, group, rows, 12 - bits) == (splits, c)
    if (b, hkv, rows) == (8, 16, 1024):
        assert c == 128 and b * hkv * splits >= 2 * 132
    if rows <= 16:
        assert splits == 1


def test_decode_plan_refuses():
    from repro_torch.kernels import cuda
    for args in ((0, 16, 1, 1024, 8), (8, 16, 1, 0, 8), (8, 16, 1, 64, 2)):
        with pytest.raises(ValueError, match="decode_plan"):
            cuda.decode_plan(*args)


def _decode_args(layout, b=2, h=4, hkv=2, d=64, bits=8, s=1024, page=16):
    """CPU operands of a decode wrapper (both layouts over s rows)."""
    code = torch.int8 if bits == 8 else torch.uint8
    dp = d if bits == 8 else d // 2
    q = torch.zeros(b, h, d)
    ks = torch.ones(b, hkv, d)
    pos = torch.zeros(b, dtype=torch.int32)
    if layout == "contiguous":
        kq = torch.zeros(b, s, hkv, dp, dtype=code)
        return [q, kq, ks, kq.clone(), torch.ones(b, s, hkv), pos]
    n = s // page
    pool = torch.zeros(b * n, page, hkv, dp, dtype=code)
    return [q, pool, ks, pool.clone(), torch.ones(b * n, page, hkv),
            torch.zeros(b, n, dtype=torch.int32), pos]


@pytest.fixture
def fake_card(monkeypatch):
    """The decode wrappers with the device check, the stream and the launch
    stubbed: returns the list each launch's arguments are appended to."""
    from repro_torch.kernels import cuda
    calls = []
    monkeypatch.setattr(cuda, "_on_card", lambda name, *t: t[0].device)
    monkeypatch.setattr(cuda, "_stream", lambda: 0)
    monkeypatch.setattr(cuda, "_launch", lambda name, *a: calls.append(
        (name, a)))
    return calls


def test_decode_wrappers_plan_equal_rows(fake_card):
    """A contiguous cache of S rows and a paged one of n * page = S rows
    launch on the same plan; a plan of several splits gets a workspace of
    B * H * splits * (D + 4) floats and the stream's counters, one split
    gets neither."""
    from repro_torch.kernels import cuda
    for layout, fn in (("contiguous", cuda.kv_decode_attention),
                       ("paged", cuda.paged_kv_decode_attention)):
        out = fn(*_decode_args(layout), 8)
        assert out.shape == (2, 4, 64) and out.dtype == torch.float32
    (_, a), (_, p) = fake_card
    # chunk and splits are the 3rd and 2nd arguments from the end
    assert a[-4:-2] == p[-4:-2] == tuple(reversed(cuda.decode_plan(
        2, 2, 2, 1024, 8)))
    assert a[-4:-2][1] > 1 and a[8] is not None and a[9] is not None
    fake_card.clear()
    cuda.kv_decode_attention(*_decode_args("contiguous", s=16), 8)
    (_, a), = fake_card
    assert a[-4:-2] == (16, 1) and a[8] is None and a[9] is None


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_wrappers_refuse_bad_shapes(fake_card, layout):
    """Shapes and types the kernels do not take raise ValueError before a
    launch: head_dim 96, 2-bit codes, H not a multiple of Hkv, int64
    positions, V scales of the wrong shape, codes off a 16-byte boundary,
    a non-int32 table."""
    from repro_torch.kernels import cuda
    fn = (cuda.kv_decode_attention if layout == "contiguous"
          else cuda.paged_kv_decode_attention)
    bad = [(_decode_args(layout, d=96), 8, "head_dim"),
           (_decode_args(layout), 2, "bits"),
           (_decode_args(layout, h=3), 8, "multiple")]
    args = _decode_args(layout)
    args[-1] = args[-1].long()
    bad.append((args, 8, "positions"))
    args = _decode_args(layout)
    args[4] = args[4][..., :1]
    bad.append((args, 8, "v_scale"))
    args = _decode_args(layout)  # K codes 4 bytes past a 16-byte boundary
    buf = torch.zeros(args[1].numel() + 4, dtype=args[1].dtype)
    args[1] = buf[4:].view(args[1].shape)
    bad.append((args, 8, "aligned"))
    if layout == "paged":
        args = _decode_args(layout)
        args[5] = args[5].long()
        bad.append((args, 8, "tbl"))
    for args, bits, match in bad:
        with pytest.raises(ValueError, match=match):
            fn(*args, bits)
    assert not fake_card


def test_lsq_wrapper_launch_args(fake_card):
    """The lsq wrapper's launch: one per call, the outputs and steps padded
    to LSQ_MAX_STEPS (a tensor step by pointer, a float by value), the step
    count, integer bits; a list in, a list out.  It refuses 4 steps,
    non-integer bits and an x off a 16-byte boundary before launching."""
    from repro_torch.kernels import cuda
    x = torch.zeros(37)
    st = torch.tensor(0.5)
    out = cuda.lsq_fakequant(x, [st, 0.25], 4.0)
    assert isinstance(out, list) and len(out) == 2
    (name, a), = fake_card
    assert name == "lsq_fakequant" and a[4] == 37
    assert a[1:3] == (out[0].data_ptr(), out[1].data_ptr()) and a[3] is None
    assert a[5:8] == (st.data_ptr(), None, None)
    assert a[8:11] == (0.0, 0.25, 0.0) and a[11:14] == (2, 4, 0)
    assert isinstance(cuda.lsq_fakequant(x, 0.5, 4), torch.Tensor)
    fake_card.clear()
    buf = torch.zeros(41)
    for args, match in (((x, [0.1] * 4, 4), "steps"), ((x, 0.1, 4.5), "bits"),
                        ((buf[1:], 0.1, 4), "aligned")):
        with pytest.raises(ValueError, match=match):
            cuda.lsq_fakequant(*args)
    assert not fake_card


def test_histogram_wrapper_uses_stream_counters(fake_card):
    """The histogram's one launch gets the stream's counters (n_bins + 1 of
    them at least, the buffer every split kernel shares) and allocates
    only its output."""
    from repro_torch.kernels import cuda
    codes = torch.zeros(10, dtype=torch.int32)
    cuda._COUNTERS.clear()
    try:
        out = cuda.histogram(codes, 2000)
        (name, a), = fake_card
        buf = cuda._COUNTERS[(None, 0)]
        assert name == "histogram" and a[1:3] == (10, 2000)
        assert a[3] == buf.data_ptr() and buf.numel() >= 2001
        assert a[4] == out.data_ptr() and out.shape == (2000,)
        cuda.histogram(codes, 16)
        assert fake_card[1][1][3] == buf.data_ptr()  # the same buffer
    finally:
        cuda._COUNTERS.clear()


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
