"""The one definition of serving residency and roofline bytes — port of
``repro/serve/residency.py``.

Every resident-bytes number the port reports (``ServeEngine.residency``,
``chip_smoke.py``'s serve, schedule and joint phases, the tests) is summed
here over the tree's actual buffers: packed codes, scales, LSQ steps and
cache pools, never a bits x params formula.  The decode roofline is their
sum:

    bytes/token ~ resident weight bytes      (streamed once a step, the
                                              batch-1 view)
                + resident KV bytes / batch  (each decode step reads every
                                              slot's cache once)

An MLA layer's latent counts (kv_lora_rank + qk_rope_dim) elements a
token in the cache dtype, summed from its two buffers like any other.

The fake-quant layout's int4 and int2 codes are stored one a byte
(``torch.int8``), which is what the reference counts for its ``jnp.int4``
leaves, so the two packages report the same bytes for the same tree.  The
port has no mesh: ``per_device_bytes`` and the ``per_device_*`` keys equal
the whole tree's, as the reference's do on one device.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.core.quant import PackedLinear

# Physical page-pool leaves of the paged layout (serve/paging.py) and the
# dimensions of their core (pages lead); keyed by name, as in the reference.
_PAGED_POOL_KEYS = {"pk": 4, "pv": 4, "pkq": 4, "pvq": 4, "pv_scale": 3}


def _named_leaves(node, name: str = "") -> Iterator[Tuple[str, Any]]:
    """(the innermost dict key above the leaf, tensor) over a tree of
    dicts, lists, tuples and PackedLinear nodes."""
    if isinstance(node, torch.Tensor):
        yield name, node
    elif isinstance(node, PackedLinear):
        for t in (node.wp, node.scale, node.sa):
            yield name, t
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _named_leaves(v, str(k))
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _named_leaves(v, name)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resident_bytes(tree: Any) -> int:
    """Bytes a tree keeps resident: the sum of its buffers' sizes."""
    return int(sum(_nbytes(t) for _, t in _named_leaves(tree)))


def bf16_resident_bytes(tree: Any) -> int:
    """Bytes the same tree's buffers would take at 2 bytes an element.  A
    packed buffer counts its stored elements (two int4 or four int2 codes a
    byte count once); ``packing.bf16_weight_bytes`` counts logical
    weights instead."""
    return int(sum(2 * t.numel() for _, t in _named_leaves(tree)))


def per_device_bytes(tree: Any) -> int:
    """Bytes one device keeps resident.  The port shards nothing (tensor
    parallelism is ROADMAP Queue 1 item 14), so every leaf lies whole on
    one device and this is ``resident_bytes``."""
    return resident_bytes(tree)


def _layers(cache_or_layers: Any) -> Any:
    return getattr(cache_or_layers, "layers", cache_or_layers)


def resident_kv_bytes(cache_or_layers: Any) -> int:
    """Resident bytes of a KV cache (a ServeCache, a PagedServeCache or
    bare layers): codes and scales, or pools and per-slot K grids.  The
    lengths and the block table are bookkeeping, O(B), and excluded."""
    return resident_bytes(_layers(cache_or_layers))


def paged_page_bytes(cache_or_layers: Any) -> int:
    """Bytes one physical page keeps resident, over every layer (pool bytes
    over the pool size): a pool sized to a workload's peak page demand
    keeps ``peak_pages * paged_page_bytes + paged_slot_bytes``."""
    total, n_pages = 0, None
    for name, t in _named_leaves(_layers(cache_or_layers)):
        if name in _PAGED_POOL_KEYS:
            n_pages = t.shape[t.ndim - _PAGED_POOL_KEYS[name]]
            total += _nbytes(t)
    if n_pages is None:
        raise ValueError("not a paged cache: no page-pool leaves found")
    return total // int(n_pages)


def paged_slot_bytes(cache_or_layers: Any) -> int:
    """Resident bytes of the paged cache's per-slot state (the K grids),
    which the pool size does not change."""
    return int(sum(_nbytes(t) for name, t in
                   _named_leaves(_layers(cache_or_layers))
                   if name not in _PAGED_POOL_KEYS))


def _is_paged(layers: Any) -> bool:
    return any(name in _PAGED_POOL_KEYS for name, _ in _named_leaves(layers))


def kv_read_bytes_per_token(cache: Any) -> float:
    """Cache bytes one generated token pays at decode: a step reads the
    whole preallocated cache and emits a token a slot, so the resident KV
    bytes over the batch."""
    batch = int(cache.lengths.shape[0])
    return resident_kv_bytes(cache) / max(batch, 1)


def report(params: Any, cache: Optional[Any] = None) -> dict:
    """The residency summary, with the reference's keys: resident weight
    bytes and, with a cache, its resident bytes and the decode roofline's
    bytes a token (and, paged, the bytes a page and a slot's)."""
    out = {"resident_weight_bytes": resident_bytes(params),
           "per_device_weight_bytes": per_device_bytes(params)}
    if cache is not None:
        layers = _layers(cache)
        out["resident_kv_bytes"] = resident_kv_bytes(cache)
        out["per_device_kv_bytes"] = per_device_bytes(layers)
        out["kv_read_bytes_per_token"] = kv_read_bytes_per_token(cache)
        out["bytes_per_token_roofline"] = (
            out["resident_weight_bytes"] + out["kv_read_bytes_per_token"])
        if _is_paged(layers):
            out["paged_page_bytes"] = paged_page_bytes(layers)
            out["paged_slot_bytes"] = paged_slot_bytes(layers)
            out["per_device_paged_page_bytes"] = out["paged_page_bytes"]
            out["per_device_paged_slot_bytes"] = out["paged_slot_bytes"]
    return out
