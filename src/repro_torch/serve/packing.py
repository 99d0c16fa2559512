"""Packed-weight deployment pass — port of ``repro/serve/packing.py``.

``pack_params`` converts a raw QAT checkpoint, under a knapsack-selected
policy (``PrecisionPolicy.as_arrays()``), into the packed serving layout:
int4 units -> K-major uint8 (2 codes/byte), int2 -> 4 codes/byte, the
pinned 8-bit edges (the embedding, and an untied LM head) -> int8 codes
with a scalar scale, and the MoE router at its pinned 8 bits -> an int8
``PackedLinear``.  An expert bank (E, K, N) becomes a list of E
``PackedLinear``, each at its expert's own bits, step and activation step;
a shared expert, MLA's projections and the prefix blocks' pack as any
projection at their units' bits, and the MTP projection at 4 bits.
The pattern stays a per-layer list, byte-equal to the reference's
``pack_params(..., layout="unrolled")``.  Packing runs on the weights'
device.  ``serving_layout`` is the walk it shares with the fake-quant
layout (``serve.engine.quantize_for_serving``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import quant
from repro_torch.core.quant import PackedLinear
from repro_torch.models import transformer as tf
from repro_torch.serve import residency


def quantize_edge(p: dict) -> dict:
    """Pinned 8-bit edge (the embedding, an untied LM head): int8 codes +
    scalar scale, and the head's trained activation step ``sa`` where the
    node has one."""
    w = p["w"].float()
    step = torch.clamp(torch.abs(p["sw"]).float(), min=1e-9)
    out = {"wq": quant.quantize_int(w, step, 8.0).to(torch.int8),
           "scale": step}
    if "sa" in p:
        out["sa"] = p["sa"]
    return out


def _int_bits(b) -> int:
    bi = int(round(float(b)))
    if bi not in (2, 4, 8):
        raise ValueError(f"packable bit-widths are 2/4/8, got {b}")
    return bi


def _is_quant_node(node) -> bool:
    return isinstance(node, dict) and {"w", "sw", "sa"} <= set(node)


def _walk(node, path, layer, slot_of, policy_arrays, convert):
    """``convert(node, bits)`` on each quant node at its layer's bits: a
    float, or for an expert bank a row, a bit-width an expert."""
    if _is_quant_node(node):
        key = slot_of.get(path)
        bits = (4.0 if key is None      # no unit: the reference's default
                else np.asarray(policy_arrays[key[0]][key[1]])[layer])
        if node["w"].ndim == 3:
            return convert(node, np.broadcast_to(bits, node["w"].shape[:1]))
        return convert(node, float(bits))
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), layer, slot_of, policy_arrays,
                         convert)
                for k, v in node.items()}
    return node


def _to(node, dev: torch.device):
    if isinstance(node, torch.Tensor):
        return node.detach().to(dev)
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    return node


@torch.no_grad()
def serving_layout(params: dict, policy_arrays: Dict[str, Dict[str, Any]],
                   cfg, convert, device="cuda") -> dict:
    """Raw QAT params -> a serving layout on ``device``, detached: each
    projection's {'w','sw','sa'} node becomes ``convert(node, bits)`` at
    its unit's per-layer bits (``tf.slot_index``), the embedding and an
    untied head the pinned 8-bit ``quantize_edge``, and every other leaf is
    moved as it is.  A prefix block's nodes take its group's bits (layer
    0); a node with no unit (the MTP projection) takes 4 bits, the
    reference's default."""
    dev = resolve_device(device)
    slot_of = tf.slot_index(cfg)
    out: dict = {}
    for key, node in params.items():
        if key in ("embed", "head"):
            out[key] = quantize_edge(_to(node, dev))
        elif key == "pat":
            out[key] = [_walk(_to(layer, dev), ("pat",), r, slot_of,
                              policy_arrays, convert)
                        for r, layer in enumerate(node)]
        else:       # prefix blocks (layer 0 of their group), the MTP head
            out[key] = _walk(_to(node, dev), (key,), 0, slot_of,
                             policy_arrays, convert)
    return out


def pack_params(params: dict, policy_arrays: Dict[str, Dict[str, Any]], cfg,
                device="cuda") -> dict:
    """Raw QAT params -> packed serving layout on ``device``.

    params: ``init_params`` / ``convert.from_jax_params`` output (raw
    {'w','sw','sa'} nodes, a per-layer ``pat`` list).  policy_arrays: the
    knapsack outcome (host-side numpy; bit-widths pick buffer shapes).
    The reference's ``cache_bits=`` argument exists only to plan buckets
    that the packed weights and a mixed cache share; the port's per-layer
    list needs no plan, so it has no such argument, and any per-layer cache
    bits serve over any packed tree.
    """
    return serving_layout(params, policy_arrays, cfg, _pack_node, device)


def _pack_node(node: dict, bits):
    """One {'w','sw','sa'} node -> a PackedLinear; an expert bank (E, K, N)
    with (E,) steps -> a list of E, each at its own bits (``bits`` a row)
    (``repro/serve/packing.py:72-90``)."""
    if node["w"].ndim == 3:
        return [quant.pack_linear(node["w"][e], node["sw"][e],
                                  node["sa"][e], _int_bits(bits[e]))
                for e in range(node["w"].shape[0])]
    return quant.pack_linear(node["w"], node["sw"], node["sa"],
                             _int_bits(bits))


def decode_weight_view(params: dict) -> dict:
    """CPU decode path: each PackedLinear -> {'wpre': codes * scale (f32),
    'sa'}, dequantized once per dispatch (the reference's op order, so CPU
    decode stays greedy-parity with it).  The card never takes this view:
    there every decode step streams the packed codes through the kernel."""
    def conv(node):
        if isinstance(node, PackedLinear):
            return {"wpre": quant.packed_weight_dense(node, torch.float32),
                    "sa": node.sa}
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node
    return conv(params)


def params_are_packed(params) -> bool:
    """True if the tree holds any PackedLinear (the packed layout)."""
    if isinstance(params, PackedLinear):
        return True
    if isinstance(params, dict):
        return any(params_are_packed(v) for v in params.values())
    if isinstance(params, list):
        return any(params_are_packed(v) for v in params)
    return False


def resident_weight_bytes(params: dict) -> int:
    """Bytes the params tree keeps resident; delegates to
    ``serve/residency.py``, the one definition."""
    return residency.resident_bytes(params)


def bf16_weight_bytes(params: dict) -> int:
    """Bytes of the same weights held as bf16: every packed matrix, and
    every int8 code matrix (the embedding, and each projection of the
    fake-quant layout), at 2 bytes per logical weight; scales and steps
    excluded.  This is the "bf16" column of PERF.md, not the reference's
    ``bf16_resident_bytes`` (``residency.bf16_resident_bytes``), which
    counts 2 bytes per stored element of every buffer, packed or not."""
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, PackedLinear):
            total += 2 * node.k_dim * node.n_dim
        elif isinstance(node, dict):
            if isinstance(node.get("wq"), torch.Tensor):    # int8 codes
                total += 2 * node["wq"].numel()
                return
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
    visit(params)
    return total
