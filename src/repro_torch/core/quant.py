"""Quantization primitives (forward only): LSQ fake-quant, integer codes,
K-major packing — the port of ``repro/core/quant.py``.

Arithmetic matches the reference bit for bit on the CPU: the quantizer is
``clamp(round(x / s), qmin, qmax)`` in float32 with a true IEEE division and
round-half-to-even (``torch.round``, like ``jnp.round``).  The LSQ custom
gradient is not ported yet (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def qrange(bits, signed: bool = True) -> Tuple[float, float]:
    """(qmin, qmax) for a bit-width.  Exact: powers of two in float."""
    b = float(bits)
    if signed:
        return -(2.0 ** (b - 1.0)), 2.0 ** (b - 1.0) - 1.0
    return 0.0, 2.0 ** b - 1.0


def _step_tensor(step, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32, device=like.device)


def quantize_int(x: torch.Tensor, step, bits, signed: bool = True
                 ) -> torch.Tensor:
    """Integer codes q = clamp(round(x / s)) (float tensor)."""
    qmin, qmax = qrange(bits, signed)
    return torch.clamp(torch.round(x / _step_tensor(step, x)), qmin, qmax)


def lsq_fake_quant(x: torch.Tensor, step, bits,
                   signed: bool = True) -> torch.Tensor:
    """LSQ quantize-dequantize forward; arithmetic in float32, result in
    ``x``'s dtype (``repro/core/quant.py:47-58``)."""
    qmin, qmax = qrange(bits, signed)
    s = torch.clamp(torch.abs(_step_tensor(step, x)), min=1e-9)
    q = torch.clamp(torch.round(x.float() / s), qmin, qmax)
    return (q * s).to(x.dtype)


def init_step_from_tensor(w: torch.Tensor, bits: float) -> torch.Tensor:
    """LSQ step-size init: 2*mean(|w|)/sqrt(qmax) (Esser et al., 2020)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    return 2.0 * torch.mean(torch.abs(w)).float() / math.sqrt(qmax)


@dataclasses.dataclass
class PackedLinear:
    """One dense projection in the packed serving layout.

    ``wp``: bits=4 -> uint8 (Kp//2, N), two K-rows per byte (low nibble
    first); bits=2 -> uint8 (Kp//4, N), four K-rows per byte (LSB pair
    first); bits=8 -> int8 (K, N).  Kp is ``k_dim`` rounded up to the pack
    factor; padding rows are zero codes.  ``scale``: (N,) float32
    per-output-channel; ``sa``: the activation LSQ step (0-d float32).
    """
    wp: torch.Tensor
    scale: torch.Tensor
    sa: torch.Tensor
    bits: int
    k_dim: int

    @property
    def pack(self) -> int:
        return 8 // self.bits

    @property
    def n_dim(self) -> int:
        return self.wp.shape[-1]

    @property
    def k_padded(self) -> int:
        return self.wp.shape[-2] * self.pack


def pack_codes_kmajor(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) integer codes -> K-major packed uint8 (ceil(K/pack), N), on
    the codes' device.  K is zero-padded up to the pack factor."""
    if bits not in (2, 4):
        raise ValueError(f"pack_codes_kmajor packs 2/4-bit codes, got {bits}")
    pack = 8 // bits
    c = codes.to(torch.int32)
    k, n = c.shape
    kp = -(-k // pack) * pack
    if kp != k:
        c = torch.cat([c, c.new_zeros((kp - k, n))], dim=0)
    u = (c & ((1 << bits) - 1)).reshape(kp // pack, pack, n)
    out = torch.zeros((kp // pack, n), dtype=torch.int32, device=c.device)
    for i in range(pack):
        out |= u[:, i, :] << (bits * i)
    return out.to(torch.uint8)


def unpack_codes_kmajor(wp: torch.Tensor, bits: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``pack_codes_kmajor``: (..., Kp//pack, N) uint8 ->
    (..., Kp, N) sign-extended codes."""
    if bits not in (2, 4):
        raise ValueError(f"unpack_codes_kmajor unpacks 2/4-bit codes, "
                         f"got {bits}")
    pack = 8 // bits
    parts = []
    for i in range(pack):
        c = ((wp >> (bits * i)) & ((1 << bits) - 1)).to(torch.int8)
        parts.append(torch.where(c >= (1 << (bits - 1)), c - (1 << bits), c))
    w = torch.stack(parts, dim=-2)               # (..., Kp//pack, pack, N)
    out_shape = wp.shape[:-2] + (wp.shape[-2] * pack, wp.shape[-1])
    return w.reshape(out_shape).to(dtype)


def pack_linear(w: torch.Tensor, step, sa, bits: int) -> PackedLinear:
    """Quantize + pack one (K, N) weight into the serving layout with the
    fake-quant arithmetic, so dequantizing reproduces
    ``lsq_fake_quant(w, step, bits)`` exactly."""
    if w.ndim != 2:
        raise ValueError(f"pack_linear takes a (K, N) weight, got {w.shape}")
    if bits not in (2, 4, 8):
        raise ValueError(f"packable bit-widths are 2/4/8, got {bits}")
    k, n = w.shape
    stepf = torch.clamp(torch.abs(_step_tensor(step, w)), min=1e-9)
    codes = quantize_int(w.float(), stepf, float(bits))
    scale = torch.broadcast_to(stepf.reshape(-1), (n,)).float().contiguous()
    if bits == 8:
        wp = codes.to(torch.int8)
    else:
        wp = pack_codes_kmajor(codes, bits)
    return PackedLinear(wp=wp, scale=scale, sa=_step_tensor(sa, w),
                        bits=int(bits), k_dim=int(k))


def packed_weight_dense(p: PackedLinear, dtype=torch.float32) -> torch.Tensor:
    """Dequantize a PackedLinear to its (k_dim, N) weight: codes * scale
    elementwise first, the fake-quant op order."""
    if p.bits == 8:
        codes = p.wp.float()[..., :p.k_dim, :]
    else:
        codes = unpack_codes_kmajor(p.wp, p.bits, torch.float32)[
            ..., :p.k_dim, :]
    return (codes * p.scale[..., None, :].float()).to(dtype)
