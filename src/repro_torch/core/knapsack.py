"""0-1 integer knapsack for layer selection (paper §3.1) — port of
``repro/core/knapsack.py`` (numpy only, identical arithmetic, so the port
picks the same ``take`` set as the reference).

Items are the selectable units; the value of an item is its gain G_l
quantized to integers in [1, 10000] (paper footnote 2), its weight the
extra cost of keeping it at b_hi instead of b_lo, and the capacity the
budget minus the all-b_lo floor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence

import numpy as np

VALUE_LEVELS = 10_000
DEFAULT_MAX_CAPACITY = 1 << 17


@dataclasses.dataclass
class KnapsackResult:
    take: Dict[str, bool]          # item key -> keep at higher precision?
    total_value: float
    total_weight: float
    capacity: float
    n_items: int
    weight_resolution: float
    solve_seconds: float


def quantize_values(values: np.ndarray,
                    levels: int = VALUE_LEVELS) -> np.ndarray:
    """Map non-negative float gains to integers in [1, levels] (scale only)."""
    v = np.clip(np.asarray(values, np.float64), 0.0, None)
    hi = float(v.max())
    if hi <= 0:
        return np.ones(v.shape, np.int64)
    return np.maximum(1, np.round(v / hi * levels)).astype(np.int64)


def solve(keys: Sequence[str], values: Sequence[float],
          weights: Sequence[float], capacity: float,
          max_capacity_buckets: int = DEFAULT_MAX_CAPACITY) -> KnapsackResult:
    """Solve the 0-1 knapsack; weights and capacity in one float unit.

    Weights are floored onto an integer grid of at most
    ``max_capacity_buckets`` buckets; items that floor to bucket 0 and fit
    the true capacity are free and always taken.
    """
    t0 = time.perf_counter()
    keys = list(keys)
    v_raw = np.asarray(values, np.float64)
    w_raw = np.asarray(weights, np.float64)
    n = len(keys)
    if v_raw.shape != (n,) or w_raw.shape != (n,):
        raise ValueError("keys, values and weights must have one length")
    if n == 0:
        return KnapsackResult({}, 0.0, 0.0, capacity, 0, 0.0,
                              time.perf_counter() - t0)
    if np.any(w_raw < 0):
        raise ValueError("negative weights not supported")
    if w_raw.sum() <= capacity:
        return KnapsackResult({k: True for k in keys}, float(v_raw.sum()),
                              float(w_raw.sum()), capacity, n, 0.0,
                              time.perf_counter() - t0)
    if capacity <= 0:
        take0 = (w_raw == 0.0) & (capacity >= 0)
        chosen0 = {k: bool(take0[i]) for i, k in enumerate(keys)}
        return KnapsackResult(chosen0, float(v_raw[take0].sum()), 0.0,
                              capacity, n, 0.0, time.perf_counter() - t0)

    v = quantize_values(v_raw)
    resolution = max(capacity / max_capacity_buckets,
                     max(w_raw.max() / max_capacity_buckets, 1e-30))
    w = np.floor(w_raw / resolution).astype(np.int64)
    cap = int(np.floor(capacity / resolution))
    free = (w == 0) & (w_raw <= capacity)

    dp = np.zeros(cap + 1, np.int64)
    take = np.zeros((n, cap + 1), np.bool_)
    for i in range(n):
        wi, vi = int(w[i]), int(v[i])
        if free[i] or wi == 0 or wi > cap:
            continue
        cand = dp[:-wi] + vi
        improved = cand > dp[wi:]
        dp[wi:] = np.where(improved, cand, dp[wi:])
        take[i, wi:] = improved

    chosen = {k: bool(free[i]) for i, k in enumerate(keys)}
    c = cap
    for i in range(n - 1, -1, -1):
        if take[i, c]:
            chosen[keys[i]] = True
            c -= int(w[i])
    tv = float(v_raw[[chosen[k] for k in keys]].sum())
    tw = float(w_raw[[chosen[k] for k in keys]].sum())
    return KnapsackResult(chosen, tv, tw, capacity, n, float(resolution),
                          time.perf_counter() - t0)


def synthetic_gains(policy) -> Dict[str, float]:
    """Deterministic pseudo-gains over a policy's selectable units (the
    reference's definition, so both packages select the same mix)."""
    return {u.name: float((i * 7919) % 13 + 1)
            for i, u in enumerate(policy.selectable_units())}


def select_for_budget(policy, gains: Dict[str, float],
                      budget_frac: float) -> KnapsackResult:
    """Paper's selection step: keep units at b_hi within ``budget_frac`` of
    the all-b_hi cost in bit-MACs per token."""
    units = policy.selectable_units()
    keys = [u.name for u in units]
    values = [gains[k] for k in keys]
    weights = [(policy.b_hi - policy.b_lo) * u.macs_per_token for u in units]
    total_hi = sum(policy.b_hi * u.macs_per_token for u in units)
    floor_lo = sum(policy.b_lo * u.macs_per_token for u in units)
    return solve(keys, values, weights, budget_frac * total_hi - floor_lo)
