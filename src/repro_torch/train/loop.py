"""Training loop: checkpoint/restart, preemption, straggler monitoring —
port of ``repro/train/loop.py``.

  - auto-resume: ``try_resume`` restores the newest committed checkpoint
    (params, optimizer moments and count, policy bits, step) into the
    state and moves the data cursor to its step;
  - preemption: SIGTERM sets a flag; the loop saves a final checkpoint
    synchronously and stops after the step in flight;
  - stragglers: each step's wall time (to its loss on the host, a
    device sync) feeds an EWMA; a step slower than ``straggler_factor``
    times the EWMA is logged and listed;
  - the data pipeline is stateless-seeded, so resume is exact.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


class TrainLoop:
    def __init__(self, train_step: Callable, data, cfg: TrainLoopConfig,
                 ckpt_dir: Optional[str] = None,
                 log_fn: Callable[[str], None] = print):
        self.train_step = train_step
        self.data = data
        self.cfg = cfg
        self.log = log_fn
        self.manager = (CheckpointManager(ckpt_dir,
                                          keep=cfg.keep_checkpoints)
                        if ckpt_dir else None)
        self.metrics_history: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self._preempted = False

    # ---------------------------------------------------------------- resume
    def try_resume(self, state):
        if self.manager is None:
            return state
        step, restored = self.manager.restore_latest(state.to_tree())
        if restored is None:
            return state
        self.log(f"[resume] restored checkpoint at step {step}")
        state.load_tree(restored)
        self.data.step = int(step)
        return state

    # ------------------------------------------------------------------- run
    def run(self, state):
        old_term = signal.signal(signal.SIGTERM, self._on_preempt)
        old_int = signal.getsignal(signal.SIGINT)
        ewma = None
        try:
            start = int(state.step)
            for step in range(start, self.cfg.total_steps):
                t0 = time.perf_counter()
                batch = self.data.next()
                state, metrics = self.train_step(state, batch)
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0

                if ewma is None:
                    ewma = dt
                elif dt > self.cfg.straggler_factor * ewma and step > start + 2:
                    self.straggler_steps.append(step)
                    self.log(f"[straggler] step {step}: {dt:.3f}s "
                             f"(ewma {ewma:.3f}s)")
                    ewma = (1 - self.cfg.ewma_alpha) * ewma \
                        + self.cfg.ewma_alpha * dt
                else:
                    ewma = (1 - self.cfg.ewma_alpha) * ewma \
                        + self.cfg.ewma_alpha * dt

                rec["step"] = step
                rec["sec"] = dt
                self.metrics_history.append(rec)
                if self.cfg.log_every and step % self.cfg.log_every == 0:
                    self.log(f"[train] step {step} "
                             f"loss {rec.get('loss', float('nan')):.4f} "
                             f"({dt * 1e3:.0f} ms)")

                if self.manager and (step + 1) % self.cfg.checkpoint_every == 0:
                    self.manager.save(step + 1, state.to_tree(),
                                      extra_meta={"data": self.data.state()})
                if self._preempted:
                    self.log("[preempt] saving final checkpoint")
                    if self.manager:
                        self.manager.save(step + 1, state.to_tree(),
                                          block=True)
                    break
        finally:
            signal.signal(signal.SIGTERM, old_term)
            signal.signal(signal.SIGINT, old_int)
            if self.manager:
                self.manager.wait()
        return state

    def _on_preempt(self, signum, frame):
        self._preempted = True
