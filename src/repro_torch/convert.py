"""Move trees between the JAX package's layout and the port's: raw QAT
params, optimizer moments, serving caches.

The JAX model stacks the repeat pattern on a leading ``n_repeats`` axis
under ``"pat"``; the port keeps a per-layer list.  ``from_jax_params``
takes a tree of that layout as numpy arrays (``jax.tree.map(np.asarray,
tree)``, so this module never needs JAX) and returns torch tensors on
``device``; it takes any tree shaped like the params, so the optimizer's
moments load through it too.  ``to_jax_tree`` is the way back: numpy
leaves, the layers stacked.  ``serve.packing.pack_params`` packs the
params in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def from_jax_params(tree: dict, device="cuda") -> dict:
    """JAX raw param tree (numpy leaves) -> the port's raw params."""
    dev = resolve_device(device)
    out = {}
    for key, node in tree.items():
        if key == "pat":
            n = {np.asarray(leaf).shape[0] for leaf in _leaves(node)}
            if len(n) != 1:
                raise ValueError(f"'pat' leaves disagree on n_repeats: {n}")
            out[key] = [_map(node, lambda a, r=r: _tensor(np.asarray(a)[r],
                                                          dev))
                        for r in range(n.pop())]
        else:
            out[key] = _map(node, lambda a: _tensor(a, dev))
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def to_jax_tree(tree: dict) -> dict:
    """A port tree (params, or a tree shaped like them) -> the JAX
    layout with numpy leaves: each leaf of the per-layer ``"pat"`` list
    stacked over the layers; bf16 becomes float32 (exact)."""
    out = {}
    for key, node in tree.items():
        if key == "pat":
            out[key] = _stack([_map(layer, _numpy) for layer in node])
        else:
            out[key] = _map(node, _numpy)
    return out


def _stack(layers: list):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers)


def from_jax_cache(layers: dict, lengths, block_tbl=None, device="cuda"):
    """A JAX serving cache -> the port's ``ServeCache``, or its
    ``PagedServeCache`` when ``block_tbl`` is given.  ``layers`` is the
    cache's layer tree with numpy leaves and ``"pat"`` stacked on a leading
    layer axis (a bucketed JAX cache concatenated along it)."""
    from repro_torch.serve.kv_cache import ServeCache
    from repro_torch.serve.paging import PagedServeCache
    dev = resolve_device(device)
    tree = from_jax_params(layers, dev)
    lengths = _tensor(np.asarray(lengths, np.int32), dev)
    if block_tbl is None:
        return ServeCache(layers=tree, lengths=lengths)
    return PagedServeCache(layers=tree, lengths=lengths,
                           block_tbl=_tensor(np.asarray(block_tbl, np.int32),
                                             dev))


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
