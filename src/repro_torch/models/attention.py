"""GQA attention — port of the GQA branches of ``repro/models/attention.py``
(train/prefill; decode with one query per request over a full-dtype or
quantized cache, contiguous or paged).

Train mode runs ``chunked_attention`` on every device, the math of the
JAX model's XLA scan (q pre-scaled, 512-row chunks, causal mask), which is
what the reference's train mode runs too; autograd differentiates it (the
``flash_attention`` kernel has no backward, in either package).  Prefill
attention runs the CUDA ``flash_attention`` kernel on the card, and
``chunked_attention`` on the CPU (or with ``impl="ref"``), so the CPU
tests match the reference.  Decode over a quantized cache runs the
CUDA ``kv_decode_attention`` kernel on the card, over a paged quantized
cache ``paged_kv_decode_attention``.  Caches are updated in place (the
engine owns them); the JAX functions return new arrays.

A paged leaf holds page pools (P, page, ...) and, for the call, the block
table under ``"tbl"`` (``serve/paging.with_tables``).  A prefill over a
paged full-dtype leaf is the suffix prefill of a prefix-hit admission
(``ServeEngine.prefill_suffix``): the unshared suffix attends over the
shared prefix pages, through ``flash_attention`` with Sk > Sq on the card.
Paged S > 1 decode (speculative verify) and the chunked-prefill ``role``
staging wait for ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kv_quant as kvq
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import init_qdense, qproj, qproj_group

DEFAULT_CHUNK = 512
NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int, causal: bool, q_offset: int = 0,
                      scale=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the JAX scan's math).

    q: (B, S, H, D); k, v: (B, Sk, H, D) at the query head count; query
    row i sits at position ``q_offset + i``.  Rows past Sk in the last
    chunk are zero-padded and causally masked.  Returns (B, S, H, D) in
    q's dtype.
    """
    b, s, h, d = q.shape
    s_k = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    n_chunks = -(-s_k // chunk)
    pad = n_chunks * chunk - s_k
    if pad and not causal:
        raise ValueError("bidirectional attention requires S % chunk == 0")
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float() * scale
    q_pos = q_offset + torch.arange(s, device=q.device)
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        kf = k[:, i * chunk:(i + 1) * chunk].float()
        vf = v[:, i * chunk:(i + 1) * chunk].float()
        logits = torch.einsum("bshd,bchd->bhsc", qf, kf)
        if causal:
            k_pos = i * chunk + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhsc,bchd->bhsd", p, vf)
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def cache_write(cache_arr: torch.Tensor, new: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write one decode row per request into a (B, S_max, ...) cache, in
    place.  new: (B, 1, ...); positions: (B, 1).  A position >= S_max (an
    inactive slot) writes nothing.  Sync-free: the row at the clamped
    position is rewritten with its own value instead of being skipped."""
    if new.shape[1] != 1:
        raise NotImplementedError("multi-row cache writes (speculative "
                                  "verify, chunked prefill) are ROADMAP "
                                  "Queue 1 item 10")
    b, s_max = cache_arr.shape[:2]
    rows = torch.arange(b, device=cache_arr.device)
    pos = positions[:, 0].to(torch.long)
    valid = pos < s_max
    idx = torch.clamp(pos, max=s_max - 1)
    keep = cache_arr[rows, idx]
    sel = valid.reshape((b,) + (1,) * (keep.ndim - 1))
    cache_arr[rows, idx] = torch.where(sel, new[:, 0].to(cache_arr.dtype),
                                       keep)


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * group, D)."""
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def _dense_decode_attention(q, ck, cv, positions, group) -> torch.Tensor:
    """Masked dense softmax over a contiguous full-dtype cache (the JAX
    full-dtype decode math).  Returns (B, S, H, D) float32."""
    dh = q.shape[-1]
    kk = _repeat_kv(ck, group)
    vv = _repeat_kv(cv, group)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), kk.float()) \
        * (dh ** -0.5)
    s_pos = torch.arange(ck.shape[1], device=q.device)
    mask = s_pos[None, None, None, :] <= positions[:, None, :, None]
    logits = torch.where(mask, logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", pr, vv.float())


def _suffix_prefill(q, k, v, cache: dict, group: int, impl: str):
    """Attention of a prefix-hit admission's suffix (B = 1, full-dtype
    pages; the reference's ``attention.py:329-371``).  q, k, v: (1, S_pad,
    ·, D) at absolute positions [off, off + S_pad), where ``off`` =
    ``cache["prefix_len"]`` (page-aligned, a host int).

    On the card the keys are the gathered prefix rows [0, off) followed by
    the suffix's own K/V, and ``flash_attention`` aligns the queries
    bottom-right (q_offset = off); no stale row past the suffix is read.
    Elsewhere it is the reference's layout: the suffix written into the
    slot's whole gathered window at ``off``, 512-row chunks, rows past the
    suffix causally masked (and their V zeroed: 0 * NaN would smear)."""
    if q.shape[0] != 1:
        raise ValueError("the suffix prefill admits one request at a time")
    if "pk" not in cache:
        raise ValueError("a quantized prefix hit never prefills: it shares "
                         "the donor's whole prompt")
    if "prefix_len" not in cache:
        raise ValueError("a prefill over paged pages is a suffix prefill: "
                         "call it through ServeEngine.prefill_suffix")
    off, tbl = cache["prefix_len"], cache["tbl"]
    pk, pv = cache["pk"], cache["pv"]
    page = pk.shape[1]
    if off % page:
        raise ValueError(f"prefix_len {off} is not page-aligned ({page})")
    s = q.shape[1]
    if kops.use_kernel(q, impl):
        pre = tbl[:, :off // page]
        kk = torch.cat([kvq.gather_pages(pk, pre), k.to(pk.dtype)], dim=1)
        vv = torch.cat([kvq.gather_pages(pv, pre), v.to(pv.dtype)], dim=1)
        return kops.flash_attention(q.transpose(1, 2), kk.transpose(1, 2),
                                    vv.transpose(1, 2), causal=True,
                                    impl=impl).transpose(1, 2)
    kk = kvq.gather_pages(pk, tbl)
    vv = kvq.gather_pages(pv, tbl)
    kk[:, off:off + s] = k.to(kk.dtype)
    vv[:, off:off + s] = v.to(vv.dtype)
    vv[:, off + s:] = 0
    return chunked_attention(q, _repeat_kv(kk, group), _repeat_kv(vv, group),
                             min(DEFAULT_CHUNK, kk.shape[1]), True,
                             q_offset=off)


def _check_paged_call(cache: dict, mode: str, s: int) -> None:
    if mode != "decode":
        raise ValueError(f"a paged cache takes decode, or the suffix "
                         f"prefill of a prefix hit, not mode={mode!r}")
    if "role" in cache or s != 1:
        raise NotImplementedError("a paged decode takes one token per "
                                  "request: chunked-prefill staging and "
                                  "speculative verify are ROADMAP Queue 1 "
                                  "item 10")


def init_gqa(gen: torch.Generator, cfg, device) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {"wq": init_qdense(gen, d, h * dh, dt, device),
            "wk": init_qdense(gen, d, hkv * dh, dt, device),
            "wv": init_qdense(gen, d, hkv * dh, dt, device),
            "wo": init_qdense(gen, h * dh, d, dt, device)}


def gqa_apply(p: dict, x: torch.Tensor, bits: dict, cfg, mode: str, cache,
              positions: torch.Tensor, impl: str = "auto", hvp: bool = False):
    """x (B, S, d); bits {'attn_qkv', 'attn_wo'}; positions (B, S).
    Returns (y, cache): the prefill K/V in prefill mode, the (in place)
    updated cache in decode mode, None in train mode.  ``hvp`` (train
    mode): the LSQ backward in torch ops (``quant.LsqFakeQuantHvp``)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = h // hkv
    q, k, v = qproj_group(x, (p["wq"], p["wk"], p["wv"]), bits["attn_qkv"],
                          impl, hvp)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.rope == "rope":
        cos, sin = common.rope_angles(positions, dh, cfg.rope_base)
        q, k = common.apply_rope(q, cos, sin), common.apply_rope(k, cos, sin)

    if cache is not None and ("pk" in cache or "pkq" in cache) \
            and mode == "prefill":
        out = _suffix_prefill(q, k, v, cache, group, impl)
        y = qproj(out.reshape(b, s, h * dh), p["wo"], bits["attn_wo"], impl)
        # only the fresh suffix rows: the engine writes them into the
        # slot's own pages (paging.write_slot_pages)
        return y, {"k": k.to(cfg.cache_dtype), "v": v.to(cfg.cache_dtype)}

    if cache is not None and ("pk" in cache or "pkq" in cache):
        _check_paged_call(cache, mode, s)
        tbl = cache["tbl"]
        if "pkq" in cache:
            # the contiguous quantized semantics, rows addressed by table
            cbits = kvq.cache_bits(cache)
            vs_new = kvq.v_token_scale(v, cbits)
            kvq.paged_write_rows(
                [(cache["pkq"], kvq.quantize_k(k, cache["k_scale"], cbits)),
                 (cache["pvq"], kvq.quantize_v(v, vs_new, cbits)),
                 (cache["pv_scale"], vs_new)], positions, tbl)
            out = kops.paged_kv_cache_attention(
                q[:, 0], cache["pkq"], cache["k_scale"], cache["pvq"],
                cache["pv_scale"], tbl, positions[:, 0], cbits,
                impl=impl)[:, None]
        else:
            # gather, zero the V rows past the position (0 * NaN from a
            # free page would smear), then the contiguous full-dtype math
            kvq.paged_write_rows([(cache["pk"], k), (cache["pv"], v)],
                                 positions, tbl)
            kk = kvq.gather_pages(cache["pk"], tbl)
            vv = kvq.gather_pages(cache["pv"], tbl)
            live = (torch.arange(vv.shape[1], device=x.device)[None, :]
                    <= positions[:, -1:])
            vv = torch.where(live[..., None, None], vv, torch.zeros_like(vv))
            out = _dense_decode_attention(q, kk, vv, positions, group)
        out = out.to(x.dtype).reshape(b, s, h * dh)
        return qproj(out, p["wo"], bits["attn_wo"], impl), cache

    if mode == "decode" and "kq" in cache:
        # quantized cache: the new row quantizes against the request's
        # prefill-calibrated per-channel K grid and its own exact V scale
        if s != 1:
            raise NotImplementedError("quantized decode takes one token per "
                                      "request (speculative verify is "
                                      "ROADMAP Queue 1 item 10)")
        cbits = kvq.cache_bits(cache)
        vs_new = kvq.v_token_scale(v, cbits)
        cache_write(cache["kq"], kvq.quantize_k(k, cache["k_scale"], cbits),
                    positions)
        cache_write(cache["vq"], kvq.quantize_v(v, vs_new, cbits), positions)
        cache_write(cache["v_scale"], vs_new, positions)
        out = kops.kv_cache_attention(q[:, 0], cache["kq"], cache["k_scale"],
                                      cache["vq"], cache["v_scale"],
                                      positions[:, 0], cbits, impl=impl)
        out = out[:, None].to(x.dtype).reshape(b, s, h * dh)
        return qproj(out, p["wo"], bits["attn_wo"], impl), cache

    if mode == "decode":
        cache_write(cache["k"], k, positions)
        cache_write(cache["v"], v, positions)
        out = _dense_decode_attention(q, cache["k"], cache["v"], positions,
                                      group)
        out = out.to(x.dtype).reshape(b, s, h * dh)
        return qproj(out, p["wo"], bits["attn_wo"], impl), cache

    # train / prefill
    if mode == "prefill" and kops.use_kernel(q, impl):
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=cfg.causal,
                                   impl=impl).transpose(1, 2)
    else:
        out = chunked_attention(q, _repeat_kv(k, group), _repeat_kv(v, group),
                                min(DEFAULT_CHUNK, s), cfg.causal)
    y = qproj(out.reshape(b, s, h * dh), p["wo"], bits["attn_wo"], impl,
              hvp)
    new_cache = None
    if mode == "prefill":
        new_cache = {"k": k.to(cfg.cache_dtype), "v": v.to(cfg.cache_dtype)}
    return y, new_cache


def init_gqa_cache(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_gqa_quant_cache(cfg, batch: int, max_seq: int, bits: int,
                         device) -> dict:
    """Quantized GQA cache: codes (B, S_max, Hkv, D or D//2), per-request
    per-channel K scales (B, Hkv, D) and per-token V scales (B, S_max,
    Hkv).  K scales start at ones: a never-admitted slot's garbage decode
    writes divide by them, and 0/0 would smear NaN codes."""
    if bits not in (4, 8):
        raise ValueError(f"quantized cache bits must be 4 or 8, got {bits}")
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    dp = kvq.packed_dim(dh, bits)
    dt = kvq.code_dtype(bits)
    return {
        "kq": torch.zeros((batch, max_seq, hkv, dp), dtype=dt, device=device),
        "k_scale": torch.ones((batch, hkv, dh), dtype=torch.float32,
                              device=device),
        "vq": torch.zeros((batch, max_seq, hkv, dp), dtype=dt, device=device),
        "v_scale": torch.zeros((batch, max_seq, hkv), dtype=torch.float32,
                               device=device),
    }


def init_gqa_paged_cache(cfg, n_pages: int, page_size: int, dtype,
                         device) -> dict:
    """Paged full-dtype cache: pools (P, page, Hkv, D) with no batch axis;
    slots reach them through the engine's block table."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"pk": torch.zeros(shape, dtype=dtype, device=device),
            "pv": torch.zeros(shape, dtype=dtype, device=device)}


def init_gqa_paged_quant_cache(cfg, batch: int, n_pages: int,
                               page_size: int, bits: int, device) -> dict:
    """Paged quantized cache: codes and per-token V scales ride the pages
    (P, page, ...); the per-channel K scale stays per slot (B, Hkv, D), as
    in the contiguous layout, which keeps paged decode equal to contiguous
    decode.  K scales start at ones, as there."""
    if bits not in (4, 8):
        raise ValueError(f"quantized cache bits must be 4 or 8, got {bits}")
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (n_pages, page_size, hkv, kvq.packed_dim(dh, bits))
    dt = kvq.code_dtype(bits)
    return {
        "pkq": torch.zeros(shape, dtype=dt, device=device),
        "k_scale": torch.ones((batch, hkv, dh), dtype=torch.float32,
                              device=device),
        "pvq": torch.zeros(shape, dtype=dt, device=device),
        "pv_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
    }
