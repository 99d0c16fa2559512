"""Load the JAX package's raw QAT param tree into the port's layout.

The JAX model stacks the repeat pattern on a leading ``n_repeats`` axis
under ``"pat"``; the port keeps a per-layer list.  ``from_jax_params``
takes the tree as numpy arrays (``jax.tree.map(np.asarray, params)``, so
this module never needs JAX) and returns torch tensors on ``device``;
``serve.packing.pack_params`` then packs it in the port.
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


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
