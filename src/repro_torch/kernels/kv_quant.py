"""KV-cache quantization primitives, contiguous layout — port of
``repro/kernels/kv_quant.py`` (lines 1-141, 218-228).  Plain tensor code,
as in the reference; the paged primitives follow with ROADMAP Queue 1
item 9.

K uses per-channel scales (..., B, Hkv, D) calibrated once per request on
its valid prefill rows with a 1.5x headroom margin; V uses exact per-token
scales (..., B, S, Hkv).  Codes are symmetric (int8 ±127, int4 ±7); int4
codes pack two per byte along the LAST axis (D-major, even index in the low
nibble) — unlike the K-major weight packing.
"""
from __future__ import annotations

import torch

QMAX = {8: 127.0, 4: 7.0}
K_SCALE_MARGIN = 1.5
_EPS = 1e-8


def cache_bits(cache: dict) -> int:
    """Bit-width of a quantized cache dict, from its code container."""
    return 8 if cache["kq"].dtype == torch.int8 else 4


def code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits == 8 else torch.uint8


def packed_dim(d: int, bits: int) -> int:
    """Last-axis length of the code container for a head_dim of ``d``."""
    if bits == 8:
        return d
    if d % 2:
        raise ValueError(f"packed-int4 cache needs an even head_dim, got {d}")
    return d // 2


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes in [-8, 7] -> uint8, 2 codes/byte along the last
    axis (even index -> low nibble)."""
    if codes.shape[-1] % 2:
        raise ValueError(f"pack4 needs an even last axis, got {codes.shape}")
    c = (codes.to(torch.int32) & 0xF).to(torch.uint8)
    c = c.reshape(*codes.shape[:-1], codes.shape[-1] // 2, 2)
    return c[..., 0] | (c[..., 1] << 4)


def unpack4(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of pack4: uint8 (..., D//2) -> sign-extended codes (..., D)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    w = torch.stack([lo, hi], dim=-1)
    return w.reshape(*packed.shape[:-1], packed.shape[-1] * 2).to(dtype)


def k_channel_scale(k: torch.Tensor, lengths: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Per-channel K scale from each request's own valid prefill rows.

    k: (..., B, S, Hkv, D); lengths: (B,).  Rows >= lengths[i] are right-pad
    garbage and never reach the max.  Returns (..., B, Hkv, D) float32.
    """
    s = k.shape[-3]
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=k.device)
    valid = (torch.arange(s, dtype=torch.int32, device=k.device)[None, :]
             < lengths[:, None])
    mag = torch.where(valid[..., None, None], torch.abs(k.float()), 0.0)
    amax = torch.amax(mag, dim=-3)
    return torch.clamp(amax * K_SCALE_MARGIN, min=_EPS) / QMAX[bits]


def v_token_scale(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-token (per-head) V scale: (..., S, Hkv, D) -> (..., S, Hkv)."""
    amax = torch.amax(torch.abs(v.float()), dim=-1)
    return torch.clamp(amax, min=_EPS) / QMAX[bits]


def _encode(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    q = torch.clamp(torch.round(x.float() / scale), -QMAX[bits], QMAX[bits])
    if bits == 8:
        return q.to(torch.int8)
    return pack4(q.to(torch.int8))


def quantize_k(k: torch.Tensor, k_scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    """k (..., S, Hkv, D) with k_scale (..., Hkv, D) -> codes."""
    return _encode(k, k_scale[..., None, :, :], bits)


def quantize_v(v: torch.Tensor, v_scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    """v (..., S, Hkv, D) with v_scale (..., S, Hkv) -> codes."""
    return _encode(v, v_scale[..., None], bits)


def dequant_k(kq: torch.Tensor, k_scale: torch.Tensor, bits: int,
              dtype=torch.float32) -> torch.Tensor:
    codes = kq.float() if bits == 8 else unpack4(kq)
    return (codes * k_scale[..., None, :, :].float()).to(dtype)


def dequant_v(vq: torch.Tensor, v_scale: torch.Tensor, bits: int,
              dtype=torch.float32) -> torch.Tensor:
    codes = vq.float() if bits == 8 else unpack4(vq)
    return (codes * v_scale[..., None].float()).to(dtype)


def quantize_prefill(got: dict, lengths: torch.Tensor, bits: int) -> dict:
    """Full-precision prefill cache {'k','v'} (..., B, S_pad, Hkv, D) ->
    quantized leaves sized to the prefill; K scales calibrate on the valid
    rows only."""
    k, v = got["k"], got["v"]
    ks = k_channel_scale(k, lengths, bits)
    vs = v_token_scale(v, bits)
    return {"kq": quantize_k(k, ks, bits), "k_scale": ks,
            "vq": quantize_v(v, vs, bits), "v_scale": vs}
