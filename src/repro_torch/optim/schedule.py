"""LR schedules: cosine decay with linear warmup (paper §3.4.3) — port of
``repro/optim/schedule.py``.  A schedule maps the update count (an int)
to a 0-d float32 CPU tensor, evaluated in float32 as the reference does."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, total_steps: int,
                       warmup_steps: int = 0, final_frac: float = 0.0):
    def lr(count) -> torch.Tensor:
        c = torch.tensor(float(count), dtype=torch.float32)
        warm = c / max(warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return peak_lr * torch.where(c < warmup_steps, warm, cos)
    return lr


def constant(peak_lr: float):
    def lr(count) -> torch.Tensor:
        return torch.tensor(peak_lr, dtype=torch.float32)
    return lr
