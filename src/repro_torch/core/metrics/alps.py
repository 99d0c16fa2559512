"""ALPS — Accuracy-aware Layer Precision Selection (paper §3.2, Alg. 1) —
port of ``repro/core/metrics/alps.py``.

For each selectable link-group: drop it from b_hi to b_lo (all others stay
at b_hi), fine-tune briefly (``steps_per_probe`` optimizer steps, the
paper's single epoch), and record the average training metric over the
probe window: G_l = max_l(A) - A_l (metric_mode "accuracy") or G_l =
Loss_l ("loss", natural for LMs).

Every probe starts from the same b_hi state.  The reference gets that for
free, its state being immutable; the port's train step updates params and
moments in place, so ``make_probe`` keeps an in-memory copy of the b_hi
state (params, optimizer moments and count, step, policy) and restores it
before and after every probe.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree


@dataclasses.dataclass
class AlpsConfig:
    steps_per_probe: int = 32          # "1 epoch" equivalent in steps
    metric_mode: str = "loss"          # "loss" | "accuracy"
    log_every: int = 0                 # 0 = silent


def alps_gains(policy, *,
               probe_finetune: Callable[..., Dict[str, float]],
               cfg: Optional[AlpsConfig] = None,
               progress: Optional[Callable[[str, int, int, float], None]] = None,
               ) -> Dict[str, float]:
    """Run the ALPS probe loop over all selectable link-groups.

    probe_finetune(policy=<mixed policy>, steps=<int>) -> {"loss": float,
    "accuracy": float}: average training metrics over the probe window,
    starting from the b_hi state (``make_probe`` builds one).  Returns
    link-group name -> G_l.
    """
    cfg = cfg or AlpsConfig()
    units = policy.selectable_units()
    raw: Dict[str, Dict[str, float]] = {}
    for i, u in enumerate(units):
        t0 = time.perf_counter()
        probe_policy = policy.apply_selection(
            {v.name: (v.name != u.name) for v in units})
        metrics = probe_finetune(policy=probe_policy,
                                 steps=cfg.steps_per_probe)
        raw[u.name] = metrics
        if progress is not None:
            progress(u.name, i, len(units), time.perf_counter() - t0)

    if cfg.metric_mode == "accuracy":
        a_max = max(m["accuracy"] for m in raw.values())
        return {k: a_max - m["accuracy"] for k, m in raw.items()}
    if cfg.metric_mode == "loss":
        return {k: m["loss"] for k, m in raw.items()}
    raise ValueError(f"unknown metric_mode {cfg.metric_mode!r}")


class StateCopy:
    """An in-memory copy of a ``TrainState`` (params, optimizer moments
    and count, step, policy) on the params' device, and its restore in
    place, bit for bit."""

    @torch.no_grad()
    def __init__(self, state):
        self.params = [p.detach().clone() for p in tree.leaves(state.params)]
        opt = state.optimizer
        self.moments = [tree.map_tree(lambda t: t.clone(), opt.state[p])
                        for p in tree.leaves(state.params)]
        self.count = opt.count
        self.step = state.step
        self.policy = state.policy

    @torch.no_grad()
    def restore(self, state) -> None:
        opt = state.optimizer
        for p, saved, mom in zip(tree.leaves(state.params), self.params,
                                 self.moments):
            p.copy_(saved)
            opt.state[p] = tree.map_tree(lambda t: t.clone(), mom)
        opt.count = self.count
        state.step = self.step
        state.policy = self.policy


def make_probe(state, train_step: Callable, batch_at: Callable[[int], dict]
               ) -> Callable[..., Dict[str, float]]:
    """The ALPS probe of ``benchmarks/frontier_bench.py:36-46``: from the
    b_hi state, ``steps`` train steps under the probe's policy on batches
    ``batch_at(0), batch_at(1), ...``; returns the mean loss over the steps
    and the last step's accuracy.  The state is restored from its copy
    before and after each probe."""
    saved = StateCopy(state)

    def probe(policy=None, steps: int = 1) -> Dict[str, float]:
        saved.restore(state)
        state.policy = policy.as_arrays()
        losses, m = [], {}
        try:
            for i in range(steps):
                _, m = train_step(state, batch_at(i))
                losses.append(m["loss"])
            return {"loss": float(np.mean([float(x) for x in losses])),
                    "accuracy": float(m["accuracy"])}
        finally:
            saved.restore(state)

    return probe
