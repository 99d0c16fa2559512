"""Shared model building blocks: norms, RoPE, quantized dense — port of
``repro/models/common.py``.

Every projection goes through ``qproj`` (``qproj_group`` for the
projections that share an input): the input activation is
LSQ-fake-quantized at the unit's policy bits (``core.quant.fake_quant_group``:
the ``lsq_fakequant`` kernel, with its backward kernel when a gradient is
recorded) and multiplied by the packed low-bit codes
(``kernels/ops.packed_matmul``), or by a weight fake-quantized once a step
(``{'wpre', 'sa'}``, from ``prequantize_params``: train mode), by int8
codes times their scale (``{'wq', 'scale', 'sa'}``, the fake-quant serve
layout of ``serve.engine.quantize_for_serving``: a plain matmul, as in the
reference, where no Pallas kernel takes it), or by a fake-quantized float
weight (``{'w', 'sw', 'sa'}``, the raw checkpoint).
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


def rope_freqs(half: int, base: float, device) -> torch.Tensor:
    """base ** (-i / half) for i < half, float32: the float32 exponents of
    the reference, the power taken in float64 and rounded once.  That is
    XLA's correctly rounded float32 power bit for bit at every head_dim and
    base of the ported configs (PyTorch's float32 ``pow`` is one ulp off at
    4 of head_dim 128's 64 columns at base 1e6, which moved cos and sin at
    position p by up to about 7.5e-9 p)."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(base, dtype=torch.float64, device=device),
                     exps.double()).float()


def rope_angles(positions: torch.Tensor, dim: int, base: float = 10_000.0):
    """positions (..., S) int -> cos, sin (..., S, dim // 2) float32.

    Frequencies (``rope_freqs``, the reference's bit for bit) and angles
    are float32 values; cos and sin are evaluated in float64 and
    rounded once, which agrees with XLA's float32 cos/sin far more often
    than PyTorch's float32 ones (a 1-ulp difference here can flip an
    activation code downstream).
    """
    freqs = rope_freqs(dim // 2, base, positions.device)
    ang = (positions.float()[..., None] * freqs).double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def mrope_angles(positions: torch.Tensor, dim: int,
                 sections=(16, 24, 24), base: float = 10_000.0):
    """Qwen2-VL's M-RoPE: positions (3, B, S) int, the (temporal, height,
    width) streams -> cos, sin (B, S, dim // 2) float32.  The head-dim
    halves split into ``sections`` (summing to dim // 2), each rotated by
    its own stream at the frequencies of its columns
    (``repro/models/common.py:86-103``).  Frequencies, angles, cos and sin
    are evaluated as ``rope_angles`` evaluates them, so three equal
    streams give ``rope_angles``' tensors exactly."""
    half = dim // 2
    if sum(sections) != half or positions.shape[0] != len(sections):
        raise ValueError(f"mrope_angles: sections {tuple(sections)} must sum "
                         f"to dim // 2 = {half}, one stream each; positions "
                         f"{tuple(positions.shape)}")
    freqs = rope_freqs(half, base, positions.device)
    ang_all = positions.float()[..., None] * freqs        # (3, B, S, half)
    bounds = np.cumsum((0,) + tuple(sections))
    ang = torch.cat([ang_all[axis, ..., lo:hi] for axis, (lo, hi) in
                     enumerate(zip(bounds[:-1], bounds[1:]))], dim=-1).double()
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
    """The (de)quantized float weight of a param node: a PackedLinear, a
    prequantized ``wpre``, the fake-quant serve layout's int8 codes ``wq``
    times their scale (float32, as ``repro/models/common.py:117-120``; the
    caller casts to the input's dtype), or LSQ fake-quant of a raw ``w``."""
    if isinstance(p, PackedLinear):
        return quant.packed_weight_dense(p, torch.float32)
    if "wpre" in p:
        return p["wpre"]
    if "wq" in p:
        return p["wq"].float() * p["scale"].float()
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


def fake_quant_bank(w: torch.Tensor, sw: torch.Tensor, bits,
                    impl: str = "auto", hvp: bool = False, grad_qmax=None
                    ) -> torch.Tensor:
    """LSQ fake-quant of an expert bank (E, d_in, d_out), each expert at
    its own step ``sw[e]`` and bits ``bits[e]``: the reference's one
    fake-quant of the bank with (E, 1, 1) steps and bits, expert by
    expert (``grad_qmax``: the mean qmax of the reference's stacked
    call).  The experts come out of the bank by ``unbind``, whose backward
    stacks their gradients once (indexing each would write a bank-sized
    gradient an expert)."""
    return torch.stack([quant.fake_quant(we, se, float(b), impl, hvp,
                                         grad_qmax)
                        for we, se, b in zip(w.unbind(0), sw.unbind(0),
                                             bits)])


def prequantize_params(params, policy_arrays, slot_of, impl: str = "auto",
                       hvp: bool = False):
    """Fake-quantize every projection weight once, before the layers run
    (``repro/models/transformer.py:380-412``): each ``{'w', 'sw', 'sa'}``
    node becomes ``{'wpre': fake_quant(w, sw, bits), 'sa': sa}``; the
    gradient reaches w and sw through ``LsqFakeQuant``.  ``params["pat"]``
    is the per-layer list; ``slot_of`` maps a node's path to its (group,
    slot) (``transformer.slot_index``), whose bits ``policy_arrays`` gives
    per layer (a node with no unit gets 4, as in the reference).  An
    expert bank (E, d_in, d_out) takes its layer's row of per-expert bits
    and steps (``fake_quant_bank``).  The reference quantizes a slot's
    layers stacked, so every layer's step gradient takes the slot's mean
    qmax (``quant.mean_qmax``), over the experts too.  A prefix block
    (``params["prefix{i}"]``) is walked as layer 0 of its own group."""
    def walk(node, path, layer):
        if isinstance(node, dict) and {"w", "sw", "sa"} <= node.keys():
            key = slot_of.get(path)
            bits, grad_qmax = 4.0, None
            if key is not None:
                slot = np.asarray(policy_arrays[key[0]][key[1]])
                bits, grad_qmax = slot[layer], quant.mean_qmax(slot)
            if node["w"].ndim == 3:
                wpre = fake_quant_bank(node["w"], node["sw"], np.broadcast_to(
                    bits, node["w"].shape[:1]), impl, hvp, grad_qmax)
            else:
                wpre = quant.fake_quant(node["w"], node["sw"], float(bits),
                                        impl, hvp, grad_qmax)
            return {"wpre": wpre, "sa": node["sa"]}
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), layer) for k, v in node.items()}
        return node

    out = dict(params, pat=[walk(layer, ("pat",), r)
                            for r, layer in enumerate(params["pat"])])
    for key in params:
        if key.startswith("prefix"):
            out[key] = walk(params[key], (key,), 0)
    return out


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
