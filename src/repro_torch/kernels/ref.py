"""Plain PyTorch versions of the six ported kernels (and the CPU serving
path) — port of ``repro/kernels/ref.py``.

Each CUDA kernel in ``repro_torch/csrc`` is held against the function here of
the same name: on the CPU by the tests, on the card by ``chip_smoke.py``.
They run on any device; ``kernels/ops.py`` picks them for CPU tensors or
when ``impl="ref"`` is asked for.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import kv_quant

NEG_INF = -1e30


# ------------------------------------------------------------- entropy_hist
def histogram(codes: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts of int codes in [0, n_bins); codes (n,) int32 -> (n_bins,)
    float32.  Codes outside the range fall in no bin."""
    bins = torch.arange(n_bins, dtype=codes.dtype, device=codes.device)
    return (codes[:, None] == bins[None, :]).sum(dim=0).float()


def entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """H(p) in bits (paper Eq. 3) with masked p*log2(p): empty bins add
    exactly 0, so H does not depend on how many unused bins the histogram
    carries.  ``kernels/ops.entropy_bits`` shares this formula."""
    p = counts / torch.clamp(counts.sum(), min=1.0)
    plogp = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-30)),
                        0.0)
    return -plogp.sum()


def entropy_bits(codes: torch.Tensor, n_bins: int) -> torch.Tensor:
    return entropy_from_counts(histogram(codes, n_bins))


# ------------------------------------------------------------ lsq_fakequant
def lsq_fakequant(x: torch.Tensor, step, bits) -> torch.Tensor:
    """clip(round(x / s), qmin, qmax) * s with s = max(|step|, 1e-9), in
    float32, result in x's dtype."""
    return quant.lsq_fake_quant(x, step, bits)


def lsq_fakequant_grouped(x: torch.Tensor, steps, bits) -> list:
    """The grouped kernel's plain version: one output per step, all at
    one bit-width."""
    return [lsq_fakequant(x, s, bits) for s in steps]


def _reduce_to_shape(t: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``t`` down to a step's (broadcast) shape."""
    if len(shape) == 0:
        return t.sum()
    while t.ndim > len(shape):
        t = t.sum(dim=0)
    for i, (td, sd) in enumerate(zip(t.shape, shape)):
        if sd == 1 and td != 1:
            t = t.sum(dim=i, keepdim=True)
    return t


def lsq_fakequant_bwd(x: torch.Tensor, grads, steps, bits):
    """The LSQ backward of ``lsq_fakequant_grouped`` (the reference's
    ``_lsq_bwd`` for each step): (gx, [gs_k]).

    gx = sum_k where(in_range_k, g_k, 0): the first term as it is, the
    others added in float32 in k order, rounded once to x's dtype.  gs_k =
    gscale_k * sum(g_k * ds_k) with ds = round(xs) - xs in range and
    clip(xs, qmin, qmax) outside; the products are exact in float64 and
    summed there, times gscale, rounded once to float32 (so the sum's order
    moves it by about float64's rounding, not float32's), reduced to the
    step's shape.  A step is a tensor (any shape broadcasting against x)
    or a float; gs_k is float32 of the step's shape (0-d for a float)."""
    qmin, qmax = quant.qrange(bits)
    xf = x.float()
    gx, gsteps = None, []
    for g, step in zip(grads, steps):
        st = torch.as_tensor(step, dtype=torch.float32, device=x.device)
        s = torch.clamp(torch.abs(st), min=1e-9)
        xs = xf / s
        in_range = (xs >= qmin) & (xs <= qmax)
        term = torch.where(in_range, g.float(), 0.0)
        gx = term if gx is None else gx + term
        ds = torch.where(in_range, torch.round(xs) - xs,
                         torch.clamp(xs, qmin, qmax))
        gscale = quant.lsq_step_grad_scale(x.numel() // max(st.numel(), 1),
                                           bits)
        total = _reduce_to_shape(g.double() * ds.double(), st.shape)
        gsteps.append((total * gscale).float())
    return gx.to(x.dtype), gsteps


# ------------------------------------------------------------- quant_matmul
def unpack_w4(w_packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(K//2, N) uint8 -> (K, N) sign-extended codes."""
    return quant.unpack_codes_kmajor(w_packed, 4, dtype)


def unpack_w2(w_packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(K//4, N) uint8 -> (K, N) sign-extended 2-bit codes in [-2, 1]."""
    return quant.unpack_codes_kmajor(w_packed, 2, dtype)


def pack_w4(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) codes in [-8, 7] -> (K//2, N) uint8 (K-major nibbles)."""
    if codes.shape[0] % 2:
        raise ValueError(f"pack_w4 needs an even K, got {codes.shape}")
    return quant.pack_codes_kmajor(codes, 4)


def pack_w2(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) codes in [-2, 1] -> (K//4, N) uint8 (K-major bit-pairs)."""
    if codes.shape[0] % 4:
        raise ValueError(f"pack_w2 needs K % 4 == 0, got {codes.shape}")
    return quant.pack_codes_kmajor(codes, 2)


def _quant_matmul(x, w, scale):
    # bf16(x) times integer codes: every product and partial sum is exact
    # in float32, so a float32 matmul is the fp32-accumulated bf16 product.
    acc = x.to(torch.bfloat16).float() @ w
    return acc * scale[None, :].float()


def quant_matmul_w4(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Kernel op order: bf16(x) @ int4 codes with fp32 accumulation, then
    the per-channel scale.  x (M, K); returns (M, N) float32."""
    return _quant_matmul(x, unpack_w4(w_packed, torch.float32), scale)


def quant_matmul_w2(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """As ``quant_matmul_w4`` for 2-bit codes."""
    return _quant_matmul(x, unpack_w2(w_packed, torch.float32), scale)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) whose rows do not depend on their batchmates.

    On the CPU PyTorch multiplies a single row with a GEMV that sums K in
    another order than its GEMM does for two or more rows, so a request
    decoded alone would round differently from the same request in a
    batch.  A lone row is multiplied as the first of two.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] == 1 and not x.is_cuda:
        return (torch.cat([x2, torch.zeros_like(x2)]) @ w)[:1].reshape(
            lead + (w.shape[-1],))
    return (x2 @ w).reshape(lead + (w.shape[-1],))


def dequant_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                   scale: torch.Tensor, bits: int) -> torch.Tensor:
    """The CPU serving path: dequantize codes * scale first, then matmul in
    x's dtype — the fake-quant op order, which the JAX CPU path uses."""
    unpack = unpack_w4 if bits == 4 else unpack_w2
    w = unpack(w_packed, torch.float32) * scale[None, :].float()
    return matmul(x, w.to(x.dtype))


# ------------------------------------------------------- kv-cache attention
def kv_cache_attention(q: torch.Tensor, kq: torch.Tensor,
                       k_scale: torch.Tensor, vq: torch.Tensor,
                       v_scale: torch.Tensor, positions: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """Decode attention over a quantized KV cache: dequantize to float32,
    then the full-dtype decode math (D^-0.5 scale, ``s <= position`` mask).

    q: (B, H, D); kq/vq: (B, S, Hkv, D or D//2); k_scale: (B, Hkv, D);
    v_scale: (B, S, Hkv); positions: (B,).  Returns (B, H, D) float32.
    """
    k = kv_quant.dequant_k(kq, k_scale, bits)
    v = kv_quant.dequant_v(vq, v_scale, bits)
    h, d = q.shape[1], q.shape[2]
    group = h // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k) * (d ** -0.5)
    s_pos = torch.arange(kq.shape[1], device=q.device)
    mask = s_pos[None, None, :] <= positions.to(q.device)[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v)


def paged_kv_cache_attention(q: torch.Tensor, kq_pool: torch.Tensor,
                             k_scale: torch.Tensor, vq_pool: torch.Tensor,
                             v_scale_pool: torch.Tensor, tbl: torch.Tensor,
                             positions: torch.Tensor,
                             bits: int) -> torch.Tensor:
    """Decode attention over a paged quantized cache: gather each slot's
    pages, zero the V rows past its position (their softmax weight is 0,
    but 0 * NaN from a poisoned free page would still smear), then the
    contiguous math above.

    q (B, H, D); kq_pool/vq_pool (P, page, Hkv, D or D//2); k_scale
    (B, Hkv, D) per slot; v_scale_pool (P, page, Hkv); tbl (B, n) int32;
    positions (B,).  Returns (B, H, D) float32.
    """
    kq = kv_quant.gather_pages(kq_pool, tbl)
    vq = kv_quant.gather_pages(vq_pool, tbl)
    vs = kv_quant.gather_pages(v_scale_pool, tbl)
    live = (torch.arange(kq.shape[1], device=q.device)[None, :]
            <= positions.to(q.device)[:, None])
    vq = torch.where(live[..., None, None], vq, 0).to(vq.dtype)
    vs = torch.where(live[..., None], vs, 0.0)
    return kv_cache_attention(q, kq, k_scale, vq, vs, positions, bits)


# ---------------------------------------------------------- flash_attention
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale=None) -> torch.Tensor:
    """Naive softmax attention.  q, k, v: (B, H, S, D) with K/V already at
    the query head count.  Scores in q's dtype, softmax in float32, output
    in v's dtype (the reference oracle's roundings)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
