"""Dispatch between the CUDA kernels and their plain PyTorch versions —
port of ``repro/kernels/ops.py``.

``impl`` semantics:
  - "auto": a CUDA tensor launches the hand-written kernel
    (``kernels/cuda.py``); a CPU tensor runs the plain version.  There is
    no fallback: a kernel that cannot take a CUDA tensor raises.
  - "ref":  the plain version on any device (tests and ``chip_smoke.py``).

The JAX wrapper's M-to-128 padding and block-divisor rules are TPU tiling
and have no counterpart: the CUDA kernels mask ragged edges themselves.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import PackedLinear
from repro_torch.kernels import cuda, ref

IMPLS = ("auto", "ref")


def use_kernel(t: torch.Tensor, impl: str) -> bool:
    """True when ``t`` should go through a CUDA kernel under ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "auto" and t.is_cuda


def histogram(codes: torch.Tensor, n_bins: int, impl: str = "auto"
              ) -> torch.Tensor:
    """Counts of int32 codes in [0, n_bins) -> (n_bins,) float32."""
    if use_kernel(codes, impl):
        return cuda.histogram(codes.contiguous(), n_bins)
    return ref.histogram(codes, n_bins)


def entropy_bits(codes: torch.Tensor, n_bins: int, impl: str = "auto"
                 ) -> torch.Tensor:
    """H(p) in bits of the codes' histogram.  Only the histogram
    dispatches; the counts-to-H formula is ``ref.entropy_from_counts`` on
    every path."""
    return ref.entropy_from_counts(histogram(codes, n_bins, impl=impl))


def lsq_fakequant(x: torch.Tensor, step, bits, impl: str = "auto"):
    """Forward-only LSQ fake-quant of an activation tensor.  ``step`` is
    one step, or a list or tuple of 1 to 3 steps for projections that share
    ``x`` (one launch on the card, x read once), which gives a list of
    outputs.  A view off a 16-byte boundary is copied for the kernel."""
    if use_kernel(x, impl):
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        return cuda.lsq_fakequant(x, step, bits)
    if isinstance(step, (list, tuple)):
        return ref.lsq_fakequant_grouped(x, step, bits)
    return ref.lsq_fakequant(x, step, bits)


def packed_matmul(x: torch.Tensor, p: PackedLinear, impl: str = "auto"
                  ) -> torch.Tensor:
    """x (..., K) @ PackedLinear -> (..., N) in x's dtype.

      - bits 4/2 on a CUDA tensor: the CUDA ``quant_matmul`` streams the
        packed codes (scale after the fp32 accumulator); with impl="ref"
        its plain version ``ref.quant_matmul_w4/_w2`` (same op order).
      - bits 4/2 on the CPU: ``ref.dequant_matmul`` — dequantize, then
        matmul in x's dtype, the op order of the JAX CPU path.
      - bits 8 (pinned edges): a plain dequantize-then-matmul everywhere.

    K not divisible by the pack factor is zero-padded up to the packed K;
    padding rows hold zero codes.
    """
    k = x.shape[-1]
    if k != p.k_dim:
        raise ValueError(f"packed_matmul: x has K={k}, weight k_dim="
                         f"{p.k_dim}")
    if p.bits == 8:
        w = p.wp.float() * p.scale[None, :].float()
        return x @ w.to(x.dtype)
    kp = p.k_padded
    if kp != k:
        x = torch.nn.functional.pad(x, (0, kp - k))
    if not x.is_cuda:
        return ref.dequant_matmul(x, p.wp, p.scale, p.bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kp)
    if use_kernel(x, impl):
        out = cuda.quant_matmul(x2.contiguous(), p.wp, p.scale, p.bits)
    else:
        f = ref.quant_matmul_w4 if p.bits == 4 else ref.quant_matmul_w2
        out = f(x2, p.wp, p.scale).to(x.dtype)
    return out.reshape(lead + (p.n_dim,))


def kv_cache_attention(q: torch.Tensor, kq: torch.Tensor,
                       k_scale: torch.Tensor, vq: torch.Tensor,
                       v_scale: torch.Tensor, positions: torch.Tensor,
                       bits: int, impl: str = "auto") -> torch.Tensor:
    """Decode attention over a quantized KV cache -> (B, H, D) float32."""
    if use_kernel(q, impl):
        return cuda.kv_decode_attention(
            q.contiguous(), kq, k_scale, vq, v_scale,
            positions.to(torch.int32).contiguous(), bits)
    return ref.kv_cache_attention(q, kq, k_scale, vq, v_scale, positions,
                                  bits)


def paged_kv_cache_attention(q: torch.Tensor, kq_pool: torch.Tensor,
                             k_scale: torch.Tensor, vq_pool: torch.Tensor,
                             v_scale_pool: torch.Tensor, tbl: torch.Tensor,
                             positions: torch.Tensor, bits: int,
                             impl: str = "auto") -> torch.Tensor:
    """Decode attention over a paged quantized cache -> (B, H, D) float32;
    on the card the kernel reads the pages through the block table and
    never gathers them."""
    if use_kernel(q, impl):
        return cuda.paged_kv_decode_attention(
            q.contiguous(), kq_pool, k_scale, vq_pool, v_scale_pool,
            tbl.to(torch.int32).contiguous(),
            positions.to(torch.int32).contiguous(), bits)
    return ref.paged_kv_cache_attention(q, kq_pool, k_scale, vq_pool,
                                        v_scale_pool, tbl, positions, bits)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) -> (B, H, S, D) in q's dtype."""
    if use_kernel(q, impl):
        return cuda.flash_attention(q, k, v, causal=causal)
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return ref.attention(q, k, v, causal=causal)
