"""Packed-weight deployment pass — port of ``repro/serve/packing.py``.

``pack_params`` converts a raw QAT checkpoint, under a knapsack-selected
policy (``PrecisionPolicy.as_arrays()``), into the packed serving layout:
int4 units -> K-major uint8 (2 codes/byte), int2 -> 4 codes/byte, the
pinned 8-bit embedding -> int8 codes with a scalar scale.  The pattern
stays a per-layer list, byte-equal to the reference's
``pack_params(..., layout="unrolled")``.  Packing runs on the weights'
device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import quant
from repro_torch.core.quant import PackedLinear
from repro_torch.models import transformer as tf


def quantize_edge(p: dict) -> dict:
    """Pinned 8-bit edge (the tied embedding): int8 codes + scalar
    scale."""
    w = p["w"].float()
    step = torch.clamp(torch.abs(p["sw"]).float(), min=1e-9)
    return {"wq": quant.quantize_int(w, step, 8.0).to(torch.int8),
            "scale": step}


def _int_bits(b) -> int:
    bi = int(round(float(b)))
    if bi not in (2, 4, 8):
        raise ValueError(f"packable bit-widths are 2/4/8, got {b}")
    return bi


def _is_quant_node(node) -> bool:
    return isinstance(node, dict) and {"w", "sw", "sa"} <= set(node)


def _walk(node, path, layer, slot_of, policy_arrays):
    if _is_quant_node(node):
        key = slot_of.get(path)
        bits = (4.0 if key is None
                else np.asarray(policy_arrays[key[0]][key[1]])[layer])
        return quant.pack_linear(node["w"], node["sw"], node["sa"],
                                 _int_bits(bits))
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), layer, slot_of, policy_arrays)
                for k, v in node.items()}
    return node


def _to(node, dev: torch.device):
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    return node


def pack_params(params: dict, policy_arrays: Dict[str, Dict[str, Any]], cfg,
                device="cuda") -> dict:
    """Raw QAT params -> packed serving layout on ``device``.

    params: ``init_params`` / ``convert.from_jax_params`` output (raw
    {'w','sw','sa'} nodes, a per-layer ``pat`` list).  policy_arrays: the
    knapsack outcome (host-side numpy; bit-widths pick buffer shapes).
    """
    dev = resolve_device(device)
    slot_of = tf.slot_index(cfg)
    out: dict = {}
    for key, node in params.items():
        if key == "embed":
            out[key] = quantize_edge(_to(node, dev))
        elif key == "pat":
            out[key] = [_walk(_to(layer, dev), ("pat",), r, slot_of,
                              policy_arrays)
                        for r, layer in enumerate(node)]
        else:
            out[key] = _to(node, dev)
    return out


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


def _leaves(node):
    if isinstance(node, PackedLinear):
        yield from (node.wp, node.scale, node.sa)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    elif isinstance(node, torch.Tensor):
        yield node


def resident_weight_bytes(params: dict) -> int:
    """Bytes the params tree actually keeps resident (summed buffers)."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(params)))


def bf16_weight_bytes(params: dict) -> int:
    """Bytes of the same weights held as bf16: every packed or int8 matrix
    at 2 bytes per logical element (scales and steps excluded)."""
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, PackedLinear):
            total += 2 * node.k_dim * node.n_dim
        elif isinstance(node, dict):
            if isinstance(node.get("wq"), torch.Tensor):    # int8 edge
                total += 2 * node["wq"].numel()
                return
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
    visit(params)
    return total
