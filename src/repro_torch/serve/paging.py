"""Paged KV cache for solo serving — port of the cache part of
``repro/serve/paging.py``.

K/V live in fixed-size physical pages: per-layer pools (P, page, Hkv, X)
with no batch axis (``attention.init_gqa_paged_cache`` /
``init_gqa_paged_quant_cache``).  A (B, max_pages) int32 block table maps
each slot's logical pages to physical ones.  It lives once, on
``PagedServeCache``, and rides into each layer's leaf for a call
(``with_tables``).  Entries beyond a slot's mapped range hold the -1
sentinel: reads clamp it (those rows sit past the position and are never
read) and writes through it drop (``kv_quant.paged_write_rows``).

Paged decode equals contiguous decode bit for bit: the same quantization
(per-slot K grid, per-token V scales), the same math, only the row
addressing differs.  ``ServeEngine.generate`` maps slot i to pages
[i * max_pages, (i + 1) * max_pages) (``splice_prefill``), the capacity
of the contiguous layout.  The allocator, prefix sharing and
copy-on-write come with the scheduler (ROADMAP Queue 1 item 9).  Buffers
are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import kv_quant as kvq
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class PagedServeCache:
    layers: Any                    # transformer.init_caches(page_geom=...)
    block_tbl: torch.Tensor        # (B, max_pages) int32
    lengths: torch.Tensor          # (B,) int32


def is_paged_leaf(node) -> bool:
    return isinstance(node, dict) and ("pk" in node or "pkq" in node)


def init_paged_cache(cfg, batch: int, max_seq: int, n_pages: int,
                     page_size: int, dtype, device,
                     cache_bits: Optional[int] = None) -> PagedServeCache:
    """Fresh pools and an all -1 table.  A never-admitted slot must hold
    only the sentinel: its inactive decode writes are pinned at max_seq,
    which lies inside the table's range when max_seq % page != 0, and a
    zero entry would route them into page 0, another request's."""
    return PagedServeCache(
        layers=tf.init_caches(cfg, batch, max_seq, dtype, device, cache_bits,
                              page_geom=(n_pages, page_size)),
        block_tbl=torch.full((batch, kvq.page_count(max_seq, page_size)), -1,
                             dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def with_tables(layers: Any, tbl: torch.Tensor) -> Any:
    """The layer tree with ``tbl`` in every paged leaf, for one model call.
    The leaves are shallow copies: their pools are the cache's own, so the
    call's in-place writes land in the cache and no table is left behind
    in it."""
    if is_paged_leaf(layers):
        return dict(layers, tbl=tbl)
    if isinstance(layers, dict):
        return {k: with_tables(v, tbl) for k, v in layers.items()}
    if isinstance(layers, list):
        return [with_tables(v, tbl) for v in layers]
    return layers


def advance(cache: PagedServeCache, steps: int = 1,
            active=None) -> PagedServeCache:
    """Extend the valid lengths after decode steps; inactive slots stay."""
    delta = torch.full_like(cache.lengths, steps)
    if active is not None:
        delta = torch.where(active, delta, 0).to(torch.int32)
    return dataclasses.replace(cache, lengths=cache.lengths + delta)


def set_table_rows(cache: PagedServeCache, slot: int,
                   pages) -> PagedServeCache:
    """Map slot ``slot``'s logical pages [0, len(pages)) to ``pages`` and
    unmap the rest of its row (-1), in place."""
    row = torch.full((cache.block_tbl.shape[1],), -1, dtype=torch.int32)
    row[:len(pages)] = torch.as_tensor(pages, dtype=torch.int32)
    cache.block_tbl[slot] = row.to(cache.block_tbl.device)
    return cache


def set_length(cache: PagedServeCache, slot: int,
               length: int) -> PagedServeCache:
    cache.lengths[slot] = int(length)
    return cache


def n_pool_pages(cache: PagedServeCache) -> int:
    """Physical pool size P (the same in every layer)."""
    leaf, _ = next(_pairs(cache.layers, cache.layers))
    return leaf["pk" if "pk" in leaf else "pkq"].shape[0]


def _scatter_pages(pool: torch.Tensor, rows: torch.Tensor,
                   tbl: torch.Tensor) -> None:
    """rows (B, S, ...) into the pages ``tbl[:, :ceil(S / page)]``, in
    place; the last page's rows past S are zero."""
    b, s = rows.shape[:2]
    page = pool.shape[1]
    npw = kvq.page_count(s, page)
    padded = torch.zeros((b, npw * page) + tuple(rows.shape[2:]),
                         dtype=pool.dtype, device=pool.device)
    padded[:, :s] = rows.to(pool.dtype)
    pool[tbl[:, :npw].long()] = padded.reshape(
        (b, npw, page) + tuple(rows.shape[2:]))


def splice_prefill(cache: PagedServeCache, prefill_layers: Any,
                   lengths: torch.Tensor) -> PagedServeCache:
    """Write a batch prefill into sequentially mapped pages: slot i takes
    pages [i * max_pages, (i + 1) * max_pages), so the pool must hold
    B * max_pages.  Quantized leaves quantize on the way in exactly as the
    contiguous splice does (per-request K grids on the valid rows)."""
    b, max_pages = cache.block_tbl.shape
    if n_pool_pages(cache) < b * max_pages:
        raise ValueError(f"generate() needs a pool of at least B * "
                         f"max_pages = {b * max_pages} pages, got "
                         f"{n_pool_pages(cache)}")
    dev = cache.block_tbl.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    cache.block_tbl.copy_(torch.arange(b * max_pages, dtype=torch.int32,
                                       device=dev).reshape(b, max_pages))
    for leaf, got in _pairs(cache.layers, prefill_layers):
        if "pkq" in leaf:
            qc = kvq.quantize_prefill(got, lengths, kvq.cache_bits(leaf))
            leaf["k_scale"].copy_(qc["k_scale"])
            for pool, key in (("pkq", "kq"), ("pvq", "vq"),
                              ("pv_scale", "v_scale")):
                _scatter_pages(leaf[pool], qc[key], cache.block_tbl)
        else:
            _scatter_pages(leaf["pk"], got["k"], cache.block_tbl)
            _scatter_pages(leaf["pv"], got["v"], cache.block_tbl)
    return dataclasses.replace(cache, lengths=lengths)


def _pairs(node, got):
    """(paged leaf, the matching prefill leaf) over two trees of one
    structure."""
    if is_paged_leaf(node):
        yield node, got
    elif isinstance(node, dict):
        for k in node:
            yield from _pairs(node[k], got[k])
    elif isinstance(node, list):
        for n, g in zip(node, got):
            yield from _pairs(n, g)
