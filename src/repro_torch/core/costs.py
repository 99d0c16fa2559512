"""Cost models for mixed-precision selection (paper §3.4.1) — port of
``repro/core/costs.py`` (numpy-free, the reference's numbers).

The paper's unit is the BMAC, bits x MACs, linear in the bit-width; its
budgets are fractions of the all-4-bit network's cost.  The paper's
hardware (NorthPole) runs low-bit MACs natively.  The H100's tensor cores
have no 4-bit or 2-bit MAC, and its decode cost is the weight bytes a
step streams (``policy.model_bits() / 8``, the packed ``quant_matmul``
GEMV reading every weight once), where low-bit weights pay off as
bandwidth.  Those bytes are linear in b as the BMAC is, so the knapsack
picks the same units under either when activations are negligible
(decode).

The reference's other cost axes (``bops``, ``hbm_bytes_per_token``,
``frontier_axis``) have no counterpart: nothing in the reference calls
them (its dead-code allowlist says so).
"""
from __future__ import annotations

from typing import Dict, List, Optional


def bmacs(policy, bits_override: Optional[Dict[str, float]] = None) -> float:
    """Sum of bits x MACs per token over the selectable units."""
    total = 0.0
    for u in policy.selectable_units():
        b = (bits_override or {}).get(u.name, policy.bits_of(u.name))
        total += b * u.macs_per_token
    return total


def budget_sweep(fracs: Optional[List[float]] = None) -> List[float]:
    """The paper's budgets: fractions of the all-4-bit network's cost."""
    return (list(fracs) if fracs
            else [0.95, 0.90, 0.85, 0.80, 0.75, 0.70, 0.65, 0.60])
