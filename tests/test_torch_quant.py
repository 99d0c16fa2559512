"""Port quantization primitives against the JAX package: packed bytes, KV
codes and integer codes must be equal, scales equal to the bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels import kv_quant as jkv  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import kv_quant as tkv  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("bits", [2.0, 4.0, 8.0])
def test_qrange_and_quantize_int_exact(bits):
    jmin, jmax = jq.qrange(jnp.float32(bits))
    assert tq.qrange(bits) == (float(jmin), float(jmax))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 33)).astype(np.float32)
    x[0, :3] = np.array([0.25, 0.75, -0.25], np.float32)   # half-step ties
    step = np.float32(0.5)
    _eq(tq.quantize_int(_t(x), _t(step), bits),
        jq.quantize_int(jnp.asarray(x), jnp.float32(step), jnp.float32(bits)))
    _eq(tq.lsq_fake_quant(_t(x), _t(step), bits),
        jq.lsq_fake_quant(jnp.asarray(x), jnp.float32(step),
                          jnp.float32(bits)))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("k", [64, 67])
def test_pack_codes_kmajor_byte_equal(bits, k):
    rng = np.random.default_rng(1)
    codes = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(k, 48))
    want = jq.pack_codes_kmajor(codes, bits)
    got = tq.pack_codes_kmajor(_t(codes), bits)
    assert got.dtype == torch.uint8
    _eq(got, want)
    _eq(tq.unpack_codes_kmajor(got, bits), jq.unpack_codes_kmajor(want, bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_linear_byte_equal(bits):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(130, 64)).astype(np.float32) * 0.1
    step, sa = np.float32(0.03), np.float32(0.7)
    jp = jq.pack_linear(jnp.asarray(w), jnp.float32(step), jnp.float32(sa),
                        bits)
    tp = tq.pack_linear(_t(w), _t(step), _t(sa), bits)
    assert (tp.bits, tp.k_dim, tp.k_padded) == (jp.bits, jp.k_dim,
                                                 jp.k_padded)
    assert tp.wp.dtype == (torch.int8 if bits == 8 else torch.uint8)
    _eq(tp.wp, jp.wp)
    _eq(tp.scale, jp.scale)
    _eq(tq.packed_weight_dense(tp), jq.packed_weight_dense(jp))


def test_kv_quant_codes_equal():
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
    lengths = np.array([9, 4], np.int32)
    for bits in (8, 4):
        ks_j = jkv.k_channel_scale(jnp.asarray(k), lengths, bits)
        ks_t = tkv.k_channel_scale(_t(k), _t(lengths), bits)
        _eq(ks_t, ks_j)
        vs_j = jkv.v_token_scale(jnp.asarray(v), bits)
        _eq(tkv.v_token_scale(_t(v), bits), vs_j)
        _eq(tkv.quantize_k(_t(k), ks_t, bits),
            jkv.quantize_k(jnp.asarray(k), ks_j, bits))
        _eq(tkv.quantize_v(_t(v), _t(vs_j), bits),
            jkv.quantize_v(jnp.asarray(v), vs_j, bits))
        got = tkv.quantize_prefill({"k": _t(k), "v": _t(v)}, _t(lengths),
                                   bits)
        want = jkv.quantize_prefill({"k": jnp.asarray(k),
                                     "v": jnp.asarray(v)}, lengths, bits)
        for key in ("kq", "k_scale", "vq", "v_scale"):
            assert got[key].dtype == {"kq": tkv.code_dtype(bits),
                                      "vq": tkv.code_dtype(bits)}.get(
                key, torch.float32)
            _eq(got[key], want[key])
        _eq(tkv.dequant_k(got["kq"], got["k_scale"], bits),
            jkv.dequant_k(want["kq"], want["k_scale"], bits))
        _eq(tkv.dequant_v(got["vq"], got["v_scale"], bits),
            jkv.dequant_v(want["vq"], want["v_scale"], bits))


def test_pack4_d_major_byte_equal():
    codes = np.random.default_rng(4).integers(-8, 8, size=(3, 5, 16))
    _eq(tkv.pack4(_t(codes)), jkv.pack4(jnp.asarray(codes)))
    _eq(tkv.unpack4(tkv.pack4(_t(codes))), codes)
    assert tkv.cache_bits({"kq": torch.zeros(1, dtype=torch.uint8)}) == 4
    assert tkv.cache_bits({"kq": torch.zeros(1, dtype=torch.int8)}) == 8
