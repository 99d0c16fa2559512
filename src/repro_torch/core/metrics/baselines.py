"""The paper's baseline selections (§4.1, §4.3) — port of
``repro/core/metrics/baselines.py``.

  - uniform: every unit gets the same gain, so the knapsack keeps as many
    (cheap) units at b_hi as fit;
  - first-to-last: drop units to b_lo in topological order until the
    budget is met;
  - last-to-first: the reverse.

The greedy baselines are direct (``greedy_prefix_selection``), not a
knapsack: quantizing the gains to [1, 10000] would blur their strict order
in a deep network.
"""
from __future__ import annotations

from typing import Dict, List


def _ordered_keys(policy) -> List[str]:
    """Selectable unit names in topological (definition) order."""
    return [u.name for u in policy.selectable_units()]


def uniform_gains(policy) -> Dict[str, float]:
    return {k: 1.0 for k in _ordered_keys(policy)}


def first_to_last_gains(policy) -> Dict[str, float]:
    """Higher value = kept longer; the earliest units are dropped first."""
    return {k: float(i) for i, k in enumerate(_ordered_keys(policy))}


def last_to_first_gains(policy) -> Dict[str, float]:
    keys = _ordered_keys(policy)
    return {k: float(len(keys) - 1 - i) for i, k in enumerate(keys)}


def greedy_prefix_selection(policy, budget_frac: float,
                            reverse: bool = False) -> Dict[str, bool]:
    """Drop units to b_lo in topological (or reverse) order until the
    budget is met.  Returns unit name -> keep at b_hi."""
    units = policy.selectable_units()
    if reverse:
        units = units[::-1]
    total_hi = sum(policy.b_hi * u.macs_per_token for u in units)
    budget = budget_frac * total_hi
    cost = total_hi
    keep = {u.name: True for u in units}
    for u in units:
        if cost <= budget:
            break
        keep[u.name] = False
        cost -= (policy.b_hi - policy.b_lo) * u.macs_per_token
    return keep
