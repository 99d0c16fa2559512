"""EAGL: Entropy Approximation Guided Layer selection (paper §3.3, Alg. 2)
— port of ``repro/core/metrics/eagl.py``.

G_l = H(p^b): the entropy of the empirical distribution of layer l's
quantized weights at its current precision b.  A unit of several linked
tensors sums its members' entropies (paper §3.4.1).  It needs only the
checkpoint: no data, no gradients.  The histogram runs the CUDA
``histogram`` kernel on the card (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops as kops


def unit_entropy(w: torch.Tensor, step, bits: float,
                 impl: str = "auto") -> torch.Tensor:
    """H(p^b) in bits of one weight tensor (paper Eq. 1-3, Appendix E)."""
    codes = quant.quantize_int(w.float().reshape(-1),
                               torch.as_tensor(step, dtype=torch.float32,
                                               device=w.device), bits)
    n_bins = int(2 ** round(bits))
    offset = n_bins // 2                  # [-2^(b-1), 2^(b-1)-1] -> [0, 2^b)
    return kops.entropy_bits(codes.to(torch.int32) + offset, n_bins,
                             impl=impl)


def eagl_gains(policy, tensor_fn: Callable[[object, tuple],
                                           Tuple[torch.Tensor, object]],
               impl: str = "auto") -> Dict[str, float]:
    """Per selectable unit: G = sum over its tensors of H(p^b), at the
    unit's current policy bits.  ``tensor_fn(unit, path)`` returns the
    weight tensor and its LSQ step (``transformer.fetch_unit_tensor``)."""
    gains: Dict[str, float] = {}
    for u in policy.selectable_units():
        total = 0.0
        for t in u.tensors:
            w, step = tensor_fn(u, t)
            total += float(unit_entropy(w, step, policy.bits_of(u.name),
                                        impl=impl))
        gains[u.name] = total
    return gains
