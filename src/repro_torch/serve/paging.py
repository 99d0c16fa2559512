"""Paged KV cache with refcounted prefix sharing — port of
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
of the contiguous layout.  The continuous-batching scheduler
(``serve/scheduler.py``) maps pages per request instead, through the
host-side ``PageAllocator`` (free list and refcounts) and
``PrefixRegistry``: requests whose prompts share a page-aligned prefix map
the same physical pages, and admission prefills only the unshared suffix
(``plan_admission``).  A shared page is never written through: the one
divergent write, the partial tail page of an identical-prompt hit, is
copied at admission (``AdmitPlan.cow_src``).  Quantized caches share only
identical whole prompts: the per-request K grid is calibrated over the
whole prompt, so only then are the donor's codes the sharer's.  Chunked
admission (``finalize_slot_pages``) waits for ROADMAP Queue 1 item 10.
Buffers are updated in place; the allocator and registry are plain Python
and never touch the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
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
                     cache_bits=None) -> PagedServeCache:
    """Fresh pools and an all -1 table.  ``cache_bits`` as in
    ``kv_cache.init_cache``: each layer's pools take its own code width
    (int8 rows of D, int4 rows of D / 2, or full dtype) behind the one
    table.  A never-admitted slot must hold only the sentinel: its inactive
    decode writes are pinned at max_seq, which lies inside the table's
    range when max_seq % page != 0, and a zero entry would route them into
    page 0, another request's."""
    return PagedServeCache(
        layers=tf.init_caches(cfg, batch, max_seq, dtype, device, cache_bits,
                              page_geom=(n_pages, page_size)),
        block_tbl=torch.full((batch, kvq.page_count(max_seq, page_size)), -1,
                             dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def with_tables(layers: Any, tbl: torch.Tensor, **extra) -> Any:
    """The layer tree with ``tbl`` (and ``extra``, e.g. the suffix
    prefill's host-side ``prefix_len``) in every paged leaf, for one model
    call.  The leaves are shallow copies: their pools are the cache's own,
    so the call's in-place writes land in the cache and no table is left
    behind in it."""
    if is_paged_leaf(layers):
        return dict(layers, tbl=tbl, **extra)
    if isinstance(layers, dict):
        return {k: with_tables(v, tbl, **extra) for k, v in layers.items()}
    if isinstance(layers, list):
        return [with_tables(v, tbl, **extra) for v in layers]
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


def _page_index(pages, device) -> torch.Tensor:
    """Host page ids -> an int64 index on ``device`` (one host-to-device
    copy, never a sync)."""
    return torch.as_tensor(np.asarray(pages, np.int64), device=device)


def _scatter_slot_pages(pool: torch.Tensor, rows: torch.Tensor,
                        phys: torch.Tensor) -> None:
    """One request's rows (S, ...) into the physical pages ``phys``, in
    place: zero-padded or trimmed to len(phys) * page rows first, as the
    reference does."""
    npw, page = phys.shape[0], pool.shape[1]
    fit = torch.zeros((npw * page,) + tuple(rows.shape[1:]),
                      dtype=pool.dtype, device=pool.device)
    n = min(rows.shape[0], npw * page)
    fit[:n] = rows[:n].to(pool.dtype)
    pool[phys] = fit.reshape((npw, page) + tuple(rows.shape[1:]))


def write_slot_pages(cache: PagedServeCache, got_layers: Any, slot: int,
                     n_valid: int, start_tok: int,
                     pages) -> PagedServeCache:
    """Write one request's prefill output into its mapped pages, in place.

    got_layers: batch-1 prefill layers ({'k','v'} per block, rows covering
    tokens [start_tok, start_tok + S_pad)); ``pages``: the physical pages
    covering those rows (``start_tok`` page-aligned, as admission plans
    guarantee).  A quantized pool quantizes on the way in with the slot's
    own K grid, calibrated on its ``n_valid`` rows (``start_tok`` is then
    0: a quantized admission prefills the whole prompt, or nothing for an
    identical-prompt hit).  Rows past ``n_valid`` inside an owned page are
    garbage until overwritten, and the decode mask never reads them."""
    page = _page_size_of(cache)
    if start_tok % page:
        raise ValueError(f"start_tok {start_tok} is not a multiple of the "
                         f"page size {page}")
    phys = _page_index(pages, cache.block_tbl.device)
    for leaf, got in _pairs(cache.layers, got_layers):
        if "pkq" in leaf:
            if start_tok:
                raise ValueError("a quantized admission prefills from "
                                 "token 0")
            qc = kvq.quantize_prefill(
                got, torch.tensor([n_valid], dtype=torch.int32),
                kvq.cache_bits(leaf))
            for pool, key in (("pkq", "kq"), ("pvq", "vq"),
                              ("pv_scale", "v_scale")):
                _scatter_slot_pages(leaf[pool], qc[key][0], phys)
            leaf["k_scale"][slot] = qc["k_scale"][0]
        else:
            _scatter_slot_pages(leaf["pk"], got["k"][0], phys)
            _scatter_slot_pages(leaf["pv"], got["v"][0], phys)
    return cache


def copy_pages(cache: PagedServeCache, src: int, dst: int) -> PagedServeCache:
    """Duplicate one physical page across every pool, in place: the
    admission-time copy-on-write of a shared partial tail page."""
    for leaf, _ in _pairs(cache.layers, cache.layers):
        for key in ("pk", "pv", "pkq", "pvq", "pv_scale"):
            if key in leaf:
                leaf[key][dst] = leaf[key][src]
    return cache


def get_slot_k_scales(cache: PagedServeCache, slot: int) -> Dict[tuple, Any]:
    """A copy of every layer's K grid of slot ``slot``, keyed by the
    leaf's path: the prefix registry keeps it so that an identical-prompt
    hit can restore the donor's grid after the donor's slot was reused."""
    return {path: leaf["k_scale"][slot].clone()
            for path, leaf in _paths(cache.layers, ()) if "k_scale" in leaf}


def set_slot_k_scales(cache: PagedServeCache, slot: int,
                      scales: Dict[tuple, Any]) -> PagedServeCache:
    """Restore a registry-held K grid into slot ``slot``, in place."""
    for path, leaf in _paths(cache.layers, ()):
        if "k_scale" in leaf and path in scales:
            leaf["k_scale"][slot] = scales[path]
    return cache


def _page_size_of(cache: PagedServeCache) -> int:
    leaf, _ = next(_pairs(cache.layers, cache.layers))
    return leaf["pk" if "pk" in leaf else "pkq"].shape[1]


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


def _paths(node, path):
    """(path, paged leaf) over a layer tree."""
    if is_paged_leaf(node):
        yield path, node
    elif isinstance(node, dict):
        for k in node:
            yield from _paths(node[k], path + (k,))
    elif isinstance(node, list):
        for i, n in enumerate(node):
            yield from _paths(n, path + (i,))


# ======================================================= host allocator
class PageAllocator:
    """Free list + per-page refcounts (host-side; numpy only).

    Invariants (the reference's property suite, and the port's seeded
    interleavings against it):
      * a page is on the free list iff its refcount is 0;
      * refcount == number of live mappings (slot block-table rows +
        prefix-registry holds);
      * pages are conserved: free + in-use == n_pages, always.
    ``peak_in_use`` records the high-water mark, the paged workload's
    actual residency.
    """

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(n_pages, np.int32)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.peak_in_use = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages (refcount 1 each) or None if short: the caller
        (scheduler admission) defers the request rather than over-map."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0, (p, int(self.refcount[p]))
            self.refcount[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def ref(self, pages) -> None:
        """Add one mapping per page (prefix sharing / registry holds)."""
        for p in pages:
            assert self.refcount[p] > 0, f"ref of free page {p}"
            self.refcount[p] += 1

    def release(self, pages) -> None:
        """Drop one mapping per page; pages at refcount 0 return to the
        free list (and only then: a still-shared page stays resident)."""
        for p in pages:
            assert self.refcount[p] > 0, f"release of free page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(int(p))

    def writable(self, page: int) -> bool:
        """A page may be written through only while it has exactly one
        mapping: the copy-on-write guard admission plans against."""
        return self.refcount[page] == 1

    def check(self) -> None:
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entries"
        for p in range(self.n_pages):
            if p in free:
                assert self.refcount[p] == 0, f"page {p} free AND mapped"
            else:
                assert self.refcount[p] > 0, f"page {p} leaked (no refs)"
        assert self.free_count + self.in_use == self.n_pages


@dataclasses.dataclass
class PrefixEntry:
    key: Tuple[int, ...]
    pages: List[int]               # registry-held refs (one per page)
    n_tokens: int                  # tokens the pages cover (key length)
    full_prompt: bool              # quantized entries: key == whole prompt
    last_logits: Optional[Any] = None    # (V,), set when key == prompt
    k_scales: Optional[Dict] = None      # per-layer grids (quantized only)


class PrefixRegistry:
    """Host-side prefix index: token prefix -> physical pages.

    Each entry holds ONE allocator ref per page, so registered pages
    survive their donor's eviction; LRU entries are dropped under pool
    pressure (``make_room``) and their pages return to the free list only
    when no live slot still maps them.
    """

    def __init__(self, allocator: PageAllocator, capacity: int = 64):
        self.allocator = allocator
        self.capacity = capacity
        self.entries: Dict[Tuple, PrefixEntry] = {}
        self._clock = 0
        self._lru: Dict[Tuple, int] = {}
        self.hits = 0
        self.misses = 0

    def _touch(self, key) -> None:
        self._clock += 1
        self._lru[key] = self._clock

    def register(self, entry: PrefixEntry) -> None:
        if not entry.pages or entry.key in self.entries:
            if entry.key in self.entries:
                self._touch(entry.key)
            return
        if len(self.entries) >= self.capacity:
            self.make_room(0)
        self.allocator.ref(entry.pages)
        self.entries[entry.key] = entry
        self._touch(entry.key)

    def lookup_aligned(self, prompt: Tuple[int, ...],
                       page: int) -> Optional[PrefixEntry]:
        """Longest registered page-aligned prefix of ``prompt``."""
        for k in range((len(prompt) // page) * page, 0, -page):
            e = self.entries.get(tuple(prompt[:k]))
            if e is not None and not e.full_prompt:
                self._touch(e.key)
                self.hits += 1
                return e
        self.misses += 1
        return None

    def lookup_full(self, prompt: Tuple[int, ...]) -> Optional[PrefixEntry]:
        """Identical-full-prompt entry (the quantized sharing rule)."""
        e = self.entries.get(tuple(prompt))
        if e is not None and e.full_prompt:
            self._touch(e.key)
            self.hits += 1
            return e
        self.misses += 1
        return None

    def drop(self, key) -> None:
        e = self.entries.pop(key, None)
        self._lru.pop(key, None)
        if e is not None:
            self.allocator.release(e.pages)

    def make_room(self, n_pages_needed: int) -> None:
        """Drop LRU entries until the allocator can serve the request (or
        the registry is empty).  Dropping releases only the registry's
        refs: pages still mapped by live slots stay resident."""
        while self.entries and (self.allocator.free_count < n_pages_needed
                                or len(self.entries) >= self.capacity):
            key = min(self._lru, key=self._lru.get)
            self.drop(key)


@dataclasses.dataclass
class AdmitPlan:
    """What one admission will do, from ``plan_admission`` (which touches
    only allocator and registry state, never the device).

    ``shared``: pages mapped read-only (one allocator ref each, already
    claimed); ``fresh``: newly allocated pages, the only pages this
    request will ever write; ``cow_src``: a still-shared partial tail page
    whose contents must be copied into ``fresh[0]`` before decode writes
    land there; ``suffix_start``: the first token admission must still
    prefill (the tokens ``shared`` covers); ``entry``: the registry hit
    (its memoized last logits and K grids), if any.
    """
    shared: List[int]
    fresh: List[int]
    cow_src: Optional[int]
    suffix_start: int
    entry: Optional[PrefixEntry]

    @property
    def pages(self) -> List[int]:
        return list(self.shared) + list(self.fresh)


def plan_admission(alloc: PageAllocator, registry: Optional[PrefixRegistry],
                   prompt: Tuple[int, ...], max_new_tokens: int,
                   quantized: bool) -> Optional[AdmitPlan]:
    """Plan one request's page mapping; None when the pool cannot cover
    its worst case (the scheduler then defers admission).

    Worst-case sizing is eager: every page the request can touch (prompt
    plus its whole token budget) is claimed at admission, so the block
    table never changes mid-decode.
    """
    page = alloc.page_size
    n_prompt = len(prompt)
    need = kvq.page_count(n_prompt + max_new_tokens, page)
    shared: List[int] = []
    cow_src: Optional[int] = None
    suffix_start = 0
    entry: Optional[PrefixEntry] = None

    if registry is not None:
        if quantized:
            e = registry.lookup_full(tuple(prompt))
            if e is not None:
                full_pages = n_prompt // page
                shared = list(e.pages[:full_pages])
                if n_prompt % page:
                    # the partial tail page WILL receive decode writes:
                    # copy-on-write, resolved here where it is known
                    cow_src = e.pages[full_pages]
                suffix_start = n_prompt           # nothing left to prefill
                entry = e
        else:
            e = registry.lookup_aligned(tuple(prompt), page)
            if e is not None:
                shared = list(e.pages)
                suffix_start = e.n_tokens
                entry = e
                if suffix_start == n_prompt and e.last_logits is None:
                    # nothing to prefill but no memoized logits: hand the
                    # last shared page back to the suffix so its tokens
                    # prefill again and give the sampling logits
                    shared = shared[:-1]
                    suffix_start -= page

    n_fresh = need - len(shared)
    if alloc.free_count < n_fresh and registry is not None:
        registry.make_room(n_fresh)
        # the sweep may have dropped the entry planned against: its pages
        # are safe only while still mapped somewhere; plan again
        if entry is not None and entry.key not in registry.entries \
                and any(alloc.refcount[p] == 0 for p in shared):
            return plan_admission(alloc, registry, prompt, max_new_tokens,
                                  quantized)
    fresh = alloc.alloc(n_fresh)
    if fresh is None:
        return None
    if shared:
        alloc.ref(shared)
    # the copy-on-write guard, enforced: every page this request will
    # write is its own
    assert all(alloc.writable(p) for p in fresh), "fresh pages not private"
    return AdmitPlan(shared=shared, fresh=fresh, cow_src=cow_src,
                     suffix_start=suffix_start, entry=entry)
