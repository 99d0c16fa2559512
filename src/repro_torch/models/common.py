"""Shared model building blocks: norms, RoPE, quantized dense — port of
``repro/models/common.py``.

Every projection goes through ``qproj`` (``qproj_group`` for the
projections that share an input): the input activation is
LSQ-fake-quantized at the unit's policy bits (``kernels/ops.lsq_fakequant``)
and multiplied by the packed low-bit codes (``kernels/ops.packed_matmul``),
or by a dequantized view of them (``{'wpre', 'sa'}``, the CPU decode path),
or by a fake-quantized float weight (``{'w', 'sw', 'sa'}``, the raw
checkpoint).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.quant import PackedLinear
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(dtype)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def apply_norm(kind: str, x: torch.Tensor, params: dict) -> torch.Tensor:
    """kind: 'rms' | 'ln' | 'nonparam_ln' (OLMo's parameter-free LN)."""
    if kind == "rms":
        return rms_norm(x, params["scale"])
    if kind == "ln":
        return layer_norm(x, params["scale"], params["bias"])
    if kind == "nonparam_ln":
        return layer_norm(x, None, None)
    raise ValueError(kind)


def init_norm(kind: str, d: int, dtype, device) -> dict:
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def rope_angles(positions: torch.Tensor, dim: int, base: float = 10_000.0):
    """positions (..., S) int -> cos, sin (..., S, dim // 2) float32.

    Frequencies and angles are the reference's float32 values; cos and sin
    are evaluated in float64 and rounded once, which agrees with XLA's
    float32 cos/sin far more often than PyTorch's float32 ones (a 1-ulp
    difference here can flip an activation code downstream).
    """
    half = dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = (positions.float()[..., None] * freqs).double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D) with cos/sin (B, S, D // 2).

    The rotation is [x1 cos - x2 sin, x2 cos + x1 sin] in float32, each
    term evaluated as a fused multiply-add (one rounding of x1 cos plus the
    rounded other product), which is what XLA compiles the reference's
    expression to.  The FMA is emulated exactly enough in float64: the
    product of two float32 values is exact there.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    a = x1.double() * cos.double() - (x2 * sin).double()
    b = x2.double() * cos.double() + (x1 * sin).double()
    return torch.cat([a, b], dim=-1).to(x.dtype)


def weight_of(p, bits) -> torch.Tensor:
    """The (de)quantized float weight of a param node."""
    if isinstance(p, PackedLinear):
        return quant.packed_weight_dense(p, torch.float32)
    if "wpre" in p:
        return p["wpre"]
    return quant.lsq_fake_quant(p["w"], p["sw"], bits)


def qproj(x: torch.Tensor, p, bits, impl: str = "auto") -> torch.Tensor:
    """Quantized projection: activation fake-quant at ``bits``, then the
    packed matmul (PackedLinear) or a float matmul (dict layouts)."""
    return qproj_group(x, (p,), bits, impl)[0]


def qproj_group(x: torch.Tensor, ps, bits, impl: str = "auto") -> list:
    """``qproj`` of one input through 1 to 3 projections at one bit-width
    (q/k/v, gate/up): one grouped fake-quant of ``x``, each at its own
    step, then each projection's matmul."""
    steps = [p.sa if isinstance(p, PackedLinear) else p["sa"] for p in ps]
    xqs = kops.lsq_fakequant(x, steps, bits, impl=impl)
    return [kops.packed_matmul(xq, p, impl=impl)
            if isinstance(p, PackedLinear)
            else kref.matmul(xq, weight_of(p, bits).to(xq.dtype))
            for xq, p in zip(xqs, ps)]


def init_qdense(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
                init_bits: float = 4.0, scale: Optional[float] = None
                ) -> dict:
    """Weight + LSQ step sizes (weight and activation)."""
    if scale is None:
        scale = d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=device) * scale
    return {
        "w": w,
        "sw": quant.init_step_from_tensor(w, init_bits),
        # activation step init: unit-variance activations
        "sa": torch.tensor(2.0 / math.sqrt(2.0 ** (init_bits - 1) - 1),
                           dtype=torch.float32, device=device),
    }
