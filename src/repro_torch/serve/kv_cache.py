"""Preallocated KV cache with explicit valid lengths — port of the
contiguous part of ``repro/serve/kv_cache.py``.

``ServeCache`` holds the per-layer cache tree from
``transformer.init_caches`` (fixed (B, S_max) buffers, full-dtype or
quantized; an MLA layer's full-precision latent {'c_kv', 'k_rope'}, which
splices, admits and advances as any full-dtype leaf; the prefix blocks'
leaves under ``"prefix{i}"``) and ``lengths`` (B,) int32, the valid rows
per request.  Prefill
results are written at position 0; decode writes land at each request's
own ``lengths[i]``; rows at or beyond ``lengths[i]`` are garbage until
overwritten and are never read (the decode mask is ``s <= position``).
Buffers are updated in place.

Every leaf of the port's cache has its batch on axis 0, so the
reference's ``batch_axis_index`` (and ``ServeEngine.cache_batch_axes``,
which feeds it to ``write_slot``) has no counterpart here, as the bucketed
layout has none.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import kv_quant as kvq
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class ServeCache:
    layers: Any                    # transformer.init_caches tree
    lengths: torch.Tensor          # (B,) int32


def init_cache(cfg, batch: int, max_seq: int, dtype, device,
               cache_bits=None) -> ServeCache:
    """Fresh cache; every request starts empty.  ``cache_bits``: None (full
    dtype), an int, or {group: per-layer bits} (``tf.init_caches``)."""
    return ServeCache(
        layers=tf.init_caches(cfg, batch, max_seq, dtype, device, cache_bits),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def is_quant_leaf(node) -> bool:
    return isinstance(node, dict) and "kq" in node


def quantize_like(template: Any, got: Any, lengths: torch.Tensor) -> Any:
    """Full-precision prefill layers -> the structure of ``template``:
    where the template holds a quantized leaf, quantize the prefill K/V at
    its bit-width (K scales calibrated on the valid rows)."""
    if is_quant_leaf(template):
        return kvq.quantize_prefill(got, lengths, kvq.cache_bits(template))
    if isinstance(template, dict):
        return {k: quantize_like(template[k], got[k], lengths)
                for k in template}
    if isinstance(template, list):
        return [quantize_like(t, g, lengths) for t, g in zip(template, got)]
    return got


def _splice(full, got) -> None:
    """Write a prefill-sized leaf into its preallocated buffer at the
    origin (same-shape leaves, e.g. K scales, replace it)."""
    if isinstance(full, dict):
        for k in full:
            _splice(full[k], got[k])
    elif isinstance(full, list):
        for f, g in zip(full, got):
            _splice(f, g)
    else:
        full[tuple(slice(0, n) for n in got.shape)] = got.to(full.dtype)


def splice_prefill(cache: ServeCache, prefill_layers: Any,
                   lengths: torch.Tensor) -> ServeCache:
    """Write prefill caches (sized to the padded prompt) into the buffers
    at position 0, quantizing on the way in where the buffers are a
    quantized layout; ``lengths`` (B,) are the valid prompt rows."""
    lengths = lengths.to(device=cache.lengths.device, dtype=torch.int32)
    _splice(cache.layers, quantize_like(cache.layers, prefill_layers,
                                        lengths))
    return ServeCache(layers=cache.layers, lengths=lengths)


def set_length(cache: ServeCache, slot: int, length: int) -> ServeCache:
    """Pin one slot's valid length, in place (no host sync)."""
    cache.lengths[slot] = int(length)
    return cache


def _put_slot(full, got, slot: int) -> None:
    """A batch-1 leaf into row ``slot`` of its (B, ...) buffer, at the
    origin of the other axes."""
    if isinstance(full, dict):
        for k in full:
            _put_slot(full[k], got[k], slot)
    elif isinstance(full, list):
        for f, g in zip(full, got):
            _put_slot(f, g, slot)
    else:
        full[(slot,) + tuple(slice(0, n) for n in got.shape[1:])] = \
            got[0].to(full.dtype)


def write_slot(cache: ServeCache, slot_cache: Any, slot: int,
               length: int) -> ServeCache:
    """Admit one prefilled request (batch-1 prefill layers) into batch
    slot ``slot``, in place.  Stale rows past the new prompt stay garbage
    until overwritten, as after ``splice_prefill``.  On a quantized cache
    the slot's prefill is quantized first, with a fresh K grid for the
    slot, so a re-admitted slot never inherits the evicted request's."""
    _put_slot(cache.layers,
              quantize_like(cache.layers, slot_cache,
                            torch.tensor([length], dtype=torch.int32)),
              slot)
    return set_length(cache, slot, length)


def advance(cache: ServeCache, steps: int = 1, active=None) -> ServeCache:
    """Extend the valid lengths after decode steps; inactive slots stay."""
    delta = torch.full_like(cache.lengths, steps)
    if active is not None:
        delta = torch.where(active, delta, 0).to(torch.int32)
    return ServeCache(layers=cache.layers, lengths=cache.lengths + delta)
