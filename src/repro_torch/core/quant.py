"""Quantization primitives: LSQ fake-quant with its custom gradient, integer
codes, K-major packing — the port of ``repro/core/quant.py``.

Arithmetic matches the reference bit for bit on the CPU: the quantizer is
``clamp(round(x / s), qmin, qmax)`` in float32 with a true IEEE division and
round-half-to-even (``torch.round``, like ``jnp.round``).  ``LsqFakeQuant``
is the reference's ``jax.custom_vjp`` (``repro/core/quant.py:46-126``): the
straight-through estimator for x and the LSQ step gradient scaled by
``rsqrt(n * mean(qmax))`` (the mean over a stacked weight's layers),
forward and backward each through ``kernels/ops.py`` (the hand-written
CUDA kernels on the card, the plain versions in ``kernels/ref.py``
elsewhere).  ``fake_quant`` and
``fake_quant_group`` are the entry points: without a gradient to record
they call the forward alone.
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
    ``x``'s dtype (``repro/core/quant.py:47-58``).  ``torch.round`` has no
    gradient, so this plain forward refuses to record one: ``fake_quant``
    carries the LSQ gradient."""
    if _needs_grad(x, [step]):
        raise RuntimeError("lsq_fake_quant is the plain forward and has no "
                           "gradient: use quant.fake_quant (LsqFakeQuant)")
    qmin, qmax = qrange(bits, signed)
    s = torch.clamp(torch.abs(_step_tensor(step, x)), min=1e-9)
    q = torch.clamp(torch.round(x.float() / s), qmin, qmax)
    return (q * s).to(x.dtype)


def lsq_step_grad_scale(n: int, bits, grad_qmax=None) -> float:
    """The LSQ step gradient's scale rsqrt(max(n * qmax, 1)) in float32,
    for n elements of x per step element (``_lsq_bwd``'s ``gscale``).
    ``grad_qmax``, where given, stands for ``bits``' qmax: the reference
    takes the mean qmax over the layers of a stacked weight
    (``mean_qmax``)."""
    qmax = torch.tensor(qrange(bits)[1] if grad_qmax is None else grad_qmax,
                        dtype=torch.float32)
    prod = torch.tensor(float(max(1, n)), dtype=torch.float32) * qmax
    return float(torch.rsqrt(torch.clamp(prod, min=1.0)))


def mean_qmax(bits) -> float:
    """The mean qmax of per-layer bits in float32: the reference
    fake-quantizes a pattern slot's weights stacked over the layers at once,
    so its step gradient's scale takes ``jnp.mean(qmax)`` over them
    (``repro/core/quant.py:96-97``)."""
    b = torch.as_tensor(bits, dtype=torch.float32)
    return float(torch.mean(2.0 ** (b - 1.0) - 1.0))


def _needs_grad(x: torch.Tensor, steps) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        isinstance(s, torch.Tensor) and s.requires_grad for s in steps))


def _save_lsq(ctx, x, bits, impl, grad_qmax, steps) -> list:
    """Keeps what the LSQ backward needs on ``ctx``; returns the tensor
    steps."""
    ctx.bits, ctx.impl, ctx.grad_qmax = bits, impl, grad_qmax
    ctx.floats = [None if isinstance(s, torch.Tensor) else s for s in steps]
    tensors = [s for s in steps if isinstance(s, torch.Tensor)]
    ctx.save_for_backward(x, *tensors)
    return tensors


def _saved_lsq(ctx):
    """(x, steps) as ``_save_lsq`` kept them, float steps in place."""
    x, *tensor_steps = ctx.saved_tensors
    it = iter(tensor_steps)
    return x, [next(it) if f is None else f for f in ctx.floats]


def _lsq_input_grads(ctx, gx, gsteps) -> tuple:
    """The backward's result for ``apply(x, bits, impl, grad_qmax,
    *steps)``."""
    return (gx, None, None, None, *[
        g if f is None and need else None
        for g, f, need in zip(gsteps, ctx.floats, ctx.needs_input_grad[4:])])


class LsqFakeQuant(torch.autograd.Function):
    """LSQ fake-quant of one input at 1 to 3 steps (the projections that
    share an input: q/k/v, gate/up), one bit-width.

    forward: one output per step, bit for bit ``lsq_fake_quant``.
    backward: gx = sum_k where(in_range_k, g_k, 0), summed in float32 in k
    order and rounded once to x's dtype (one step: exactly the reference's
    ``where(in_range, g, 0)``); each tensor step gets
    gscale * sum(g_k * ds_k), ds = round(xs) - xs in range and
    clip(xs, qmin, qmax) outside, reduced to the step's shape
    (``lsq_step_grad_scale``'s gscale, at ``grad_qmax`` where it is not
    None); bits and float steps get none (``kernels/ops.lsq_fakequant_bwd``:
    the backward kernel on the card).  Arguments: ``apply(x, bits, impl,
    grad_qmax, *steps)``.
    ``LsqFakeQuantHvp`` is the same function in the form ``torch.func``
    transforms take.
    """

    @staticmethod
    def forward(ctx, x, bits, impl, grad_qmax, *steps):
        from repro_torch.kernels import ops as kops
        outs = kops.lsq_fakequant(x, list(steps), bits, impl=impl)
        _save_lsq(ctx, x, bits, impl, grad_qmax, steps)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.kernels import ops as kops
        x, steps = _saved_lsq(ctx)
        gx, gsteps = kops.lsq_fakequant_bwd(x, list(grads), steps, ctx.bits,
                                            impl=ctx.impl,
                                            grad_qmax=ctx.grad_qmax)
        return _lsq_input_grads(ctx, gx, gsteps)


class LsqFakeQuantHvp(torch.autograd.Function):
    """``LsqFakeQuant`` for ``torch.func.jvp`` of ``torch.func.grad``
    (HAWQ's Hessian-vector products pass ``hvp=True`` to reach it; nothing
    switches to it on its own).  ``torch.func`` needs the
    ``setup_context`` form, whose ``apply`` binds the forward's signature
    in Python on every call; the first-order class keeps the older form,
    which does not.

    forward: as ``LsqFakeQuant`` (``kernels/ops.lsq_fakequant``; the
    transforms hand it plain tensors, so the CUDA kernel runs on the card).
    backward: the same formulas in torch ops (``kernels/ref``), which the
    outer jvp differentiates, under ``torch.no_grad()``: forward mode still
    carries the jvp's tangents through it, and ``torch.func.grad``, which
    records every backward for a possible outer reverse pass, keeps no
    graph of its float64 temporaries (at olmo-1b's full width they held
    about 36 GiB on the H100).
    jvp: the reference's primal under ``jax.jvp``: ``round`` passes no
    tangent, so x's tangent gives 0 and a tensor step's tangent t gives
    clamp(round(x / s), qmin, qmax) * sign(step) * t (s = max(|step|,
    1e-9)), in x's dtype.
    """

    @staticmethod
    def forward(x, bits, impl, grad_qmax, *steps):
        from repro_torch.kernels import ops as kops
        return tuple(kops.lsq_fakequant(x, list(steps), bits, impl=impl))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, bits, impl, grad_qmax, *steps = inputs
        ctx.save_for_forward(x, *_save_lsq(ctx, x, bits, impl, grad_qmax,
                                           steps))

    @staticmethod
    def jvp(ctx, x_t, bits_t, impl_t, grad_qmax_t, *step_ts):
        x, steps = _saved_lsq(ctx)
        qmin, qmax = qrange(ctx.bits)
        outs = []
        for step, t in zip(steps, step_ts):
            if not isinstance(step, torch.Tensor) or t is None:
                outs.append(torch.zeros_like(x))
                continue
            s = torch.clamp(torch.abs(step.float()), min=1e-9)
            q = torch.clamp(torch.round(x.float() / s), qmin, qmax)
            outs.append((q * (torch.sign(step.float()) * t.float())
                         ).to(x.dtype))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.kernels import ref as kref
        x, steps = _saved_lsq(ctx)
        with torch.no_grad():
            gx, gsteps = kref.lsq_fakequant_bwd(x, list(grads), steps,
                                                ctx.bits, ctx.grad_qmax)
        return _lsq_input_grads(ctx, gx, gsteps)


def fake_quant_group(x: torch.Tensor, steps, bits, impl: str = "auto",
                     hvp: bool = False, grad_qmax=None) -> list:
    """``lsq_fake_quant`` of one input at each of 1 to 3 steps (a list of
    outputs), differentiable through ``LsqFakeQuant`` when a gradient is
    to be recorded (through ``LsqFakeQuantHvp`` with ``hvp=True``);
    otherwise the forward alone (serving).  ``grad_qmax``: the qmax of the
    step gradient's scale, where it is not ``bits``' own
    (``lsq_step_grad_scale``)."""
    if _needs_grad(x, steps):
        fn = LsqFakeQuantHvp if hvp else LsqFakeQuant
        return list(fn.apply(x, bits, impl, grad_qmax, *steps))
    from repro_torch.kernels import ops as kops
    return kops.lsq_fakequant(x, list(steps), bits, impl=impl)


def fake_quant(x: torch.Tensor, step, bits, impl: str = "auto",
               hvp: bool = False, grad_qmax=None) -> torch.Tensor:
    """``fake_quant_group`` at one step."""
    return fake_quant_group(x, [step], bits, impl, hvp, grad_qmax)[0]


def rescale_step_for_bits(step, old_bits: float, new_bits: float):
    """Paper §3.4.3: dropping 4-bit -> 2-bit starts the new step at 4x the
    old one; in general 2**(old_bits - new_bits), which keeps the
    representable range step * 2^(b-1)."""
    return step * (2.0 ** (old_bits - new_bits))


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
