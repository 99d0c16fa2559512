"""The budget-sweep frontier (paper Fig. 3/4/5) — port of
``repro/core/frontier.py``.

For each budget of the sweep and each gain metric under comparison:
select per-unit precisions with the 0-1 knapsack (or a greedy baseline),
build the mixed policy, fine-tune it (a callable the experiment supplies),
and record its task metrics: one point on the accuracy-cost frontier.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core import costs, knapsack
from repro_torch.core.metrics import baselines


@dataclasses.dataclass
class FrontierPoint:
    method: str
    budget_frac: float
    achieved_cost_frac: float     # realized BMACs / all-b_hi BMACs
    n_dropped: int                # units at b_lo
    task_metrics: Dict[str, float]
    compression_ratio: float


def select_policy(policy, method: str, gains: Optional[Dict[str, float]],
                  budget_frac: float):
    """One selection method at one budget: the mixed policy."""
    if method == "first_to_last":
        keep = baselines.greedy_prefix_selection(policy, budget_frac)
    elif method == "last_to_first":
        keep = baselines.greedy_prefix_selection(policy, budget_frac,
                                                 reverse=True)
    else:
        if gains is None:
            raise ValueError(f"method {method} needs gains")
        keep = knapsack.select_for_budget(policy, gains, budget_frac).take
    return policy.apply_selection(keep)


def sweep(policy, methods: Dict[str, Optional[Dict[str, float]]],
          finetune_eval: Callable[..., Dict[str, float]],
          budget_fracs: Optional[List[float]] = None) -> List[FrontierPoint]:
    """methods: name -> gains (None for the greedy baselines).

    finetune_eval(policy=<mixed policy>) -> task metrics, e.g. {"loss":
    ..., "accuracy": ...}; the callable owns fine-tuning from the b_hi
    state (the paper: to convergence; tests and chip_smoke.py: a few
    steps).  Points come budget by budget, methods in their order."""
    points: List[FrontierPoint] = []
    bmacs_hi = costs.bmacs(policy.uniform(policy.b_hi))
    for frac in costs.budget_sweep(budget_fracs):
        for name, gains in methods.items():
            mixed = select_policy(policy, name, gains, frac)
            dropped = sum(1 for u in mixed.selectable_units()
                          if mixed.bits_of(u.name) == mixed.b_lo)
            metrics = finetune_eval(policy=mixed)
            points.append(FrontierPoint(
                method=name, budget_frac=frac,
                achieved_cost_frac=costs.bmacs(mixed) / max(bmacs_hi, 1e-30),
                n_dropped=dropped, task_metrics=metrics,
                compression_ratio=mixed.compression_ratio()))
    return points
