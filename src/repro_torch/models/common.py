"""Shared model building blocks: norms, RoPE, quantized dense — port of
``repro/models/common.py``.

Every projection goes through ``qproj`` (``qproj_group`` for the
projections that share an input): the input activation is
LSQ-fake-quantized at the unit's policy bits (``core.quant.fake_quant_group``:
the ``lsq_fakequant`` kernel, with its backward kernel when a gradient is
recorded) and multiplied by the packed low-bit codes
(``kernels/ops.packed_matmul``), or by a weight fake-quantized once a step
(``{'wpre', 'sa'}``, from ``prequantize_params``: train mode), or by a
fake-quantized float weight (``{'w', 'sw', 'sa'}``, the raw checkpoint).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
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


def weight_of(p, bits, impl: str = "auto", hvp: bool = False
              ) -> torch.Tensor:
    """The (de)quantized float weight of a param node."""
    if isinstance(p, PackedLinear):
        return quant.packed_weight_dense(p, torch.float32)
    if "wpre" in p:
        return p["wpre"]
    return quant.fake_quant(p["w"], p["sw"], bits, impl, hvp)


def qproj(x: torch.Tensor, p, bits, impl: str = "auto", hvp: bool = False
          ) -> torch.Tensor:
    """Quantized projection: activation fake-quant at ``bits``, then the
    packed matmul (PackedLinear) or a float matmul (dict layouts).  ``hvp``
    picks the LSQ backward that a Hessian-vector product can differentiate
    (``quant.LsqFakeQuantHvp``)."""
    return qproj_group(x, (p,), bits, impl, hvp)[0]


def qproj_group(x: torch.Tensor, ps, bits, impl: str = "auto",
                hvp: bool = False) -> list:
    """``qproj`` of one input through 1 to 3 projections at one bit-width
    (q/k/v, gate/up): one grouped fake-quant of ``x``, each at its own
    step, then each projection's matmul.  Under a recorded gradient the
    grouped backward sums the projections' straight-through cotangents
    into one gx (one launch on the card)."""
    steps = [p.sa if isinstance(p, PackedLinear) else p["sa"] for p in ps]
    xqs = quant.fake_quant_group(x, steps, bits, impl, hvp)
    return [kops.packed_matmul(xq, p, impl=impl)
            if isinstance(p, PackedLinear)
            else kref.matmul(xq, weight_of(p, bits, impl, hvp).to(xq.dtype))
            for xq, p in zip(xqs, ps)]


def prequantize_params(params, policy_arrays, slot_of, impl: str = "auto",
                       hvp: bool = False):
    """Fake-quantize every projection weight once, before the layers run
    (``repro/models/transformer.py:380-412``): each ``{'w', 'sw', 'sa'}``
    node becomes ``{'wpre': fake_quant(w, sw, bits), 'sa': sa}``; the
    gradient reaches w and sw through ``LsqFakeQuant``.  ``params["pat"]``
    is the per-layer list; ``slot_of`` maps a node's path to its (group,
    slot) (``transformer.slot_index``), whose bits ``policy_arrays`` gives
    per layer (a node with no unit gets 4, as in the reference)."""
    def walk(node, path, layer):
        if isinstance(node, dict) and {"w", "sw", "sa"} <= node.keys():
            key = slot_of.get(path)
            bits = (4.0 if key is None else
                    float(np.asarray(policy_arrays[key[0]][key[1]])[layer]))
            return {"wpre": quant.fake_quant(node["w"], node["sw"], bits,
                                             impl, hvp),
                    "sa": node["sa"]}
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), layer) for k, v in node.items()}
        return node

    return dict(params, pat=[walk(layer, ("pat",), r)
                             for r, layer in enumerate(params["pat"])])


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
