"""KV-cache quantization primitives and the page read/write layout — port
of ``repro/kernels/kv_quant.py``.  Plain tensor code, as in the reference.

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
    """Bit-width of a quantized cache dict (contiguous ``kq`` or paged
    ``pkq``), from its code container."""
    codes = cache["kq"] if "kq" in cache else cache["pkq"]
    return 8 if codes.dtype == torch.int8 else 4


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


# ------------------------------------------------------------ page layout
# The paged cache stores K/V in pools (P, page, Hkv, X) addressed through a
# (B, n) int32 block table: logical row s of slot b is
# pool[tbl[b, s // page], s % page].  These functions are the one definition
# of that layout (attention writes and full-dtype reads, the paged plain
# attention, paging.splice_prefill).

def page_count(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` rows."""
    return -(-int(n_tokens) // int(page_size))


def gather_pages(pool: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """pool (P, page, ...), tbl (B, n) -> each slot's virtual sequence
    (B, n * page, ...).  Table entries clamp to [0, P - 1]: an unmapped
    entry (-1 or stale) resolves to some page whose rows sit at masked
    positions."""
    b, n = tbl.shape
    idx = torch.clamp(tbl.long(), 0, pool.shape[0] - 1)
    return pool[idx].reshape((b, n * pool.shape[1]) + pool.shape[2:])


def paged_write_rows(writes, positions: torch.Tensor,
                     tbl: torch.Tensor) -> None:
    """Write decode rows through the block table, in place — the
    reference's ``paged_write_row`` for several (pool, new) pairs of one
    page geometry (a layer's codes and scales), addressed once.

    pool (P, page, ...); new (B, S, ...); positions (B, S) logical
    positions; tbl (B, n).  Position ``pos`` of slot b lands in page
    ``tbl[b, pos // page]`` at row ``pos % page``.  A write through a table
    entry < 0 or at a position >= n * page is dropped, never redirected:
    it would land in another request's page.

    Sync-free: a dropped row is rewritten onto the target of the first
    kept row with that row's own value (duplicate targets then carry equal
    values, so the scatter's order does not matter); with no kept row at
    all, it rewrites its clamped target with the value already there.
    """
    b, n = tbl.shape
    n_pool, page = writes[0][0].shape[:2]
    s = positions.shape[1]
    pos = positions.reshape(b * s).long()
    rows = torch.arange(b, device=pos.device).repeat_interleave(s)
    phys = tbl[rows, torch.clamp(pos // page, 0, n - 1)].long()
    keep = (pos < n * page) & (phys >= 0)
    phys = torch.clamp(phys, 0, n_pool - 1)
    off = torch.clamp(pos, max=n * page - 1) % page
    # a (1,) index, not a 0-d one: indexing with a 0-d tensor reads it on
    # the host, a sync per call
    first = torch.argmax(keep.int()).reshape(1)   # 0 when nothing is kept
    any_kept = keep[first]
    phys = torch.where(keep | ~any_kept, phys, phys[first])
    off = torch.where(keep | ~any_kept, off, off[first])
    for pool, new in writes:
        vals = new.reshape((b * s,) + new.shape[2:]).to(pool.dtype)
        sel = keep.reshape((-1,) + (1,) * (vals.ndim - 1))
        fill = torch.where(any_kept, vals[first], pool[phys, off])
        pool[phys, off] = torch.where(sel, vals, fill)


def quantize_prefill(got: dict, lengths: torch.Tensor, bits: int) -> dict:
    """Full-precision prefill cache {'k','v'} (..., B, S_pad, Hkv, D) ->
    quantized leaves sized to the prefill; K scales calibrate on the valid
    rows only."""
    k, v = got["k"], got["v"]
    ks = k_channel_scale(k, lengths, bits)
    vs = v_token_scale(v, bits)
    return {"kq": quantize_k(k, ks, bits), "k_scale": ks,
            "vq": quantize_v(v, vs, bits), "v_scale": vs}
