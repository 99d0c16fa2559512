"""Knowledge distillation (paper §3.4.3: the ResNet and BERT fine-tunes
with KD) — port of ``repro/optim/distill.py``.

The teacher is the same network at effectively unquantized precision
(16-bit LSQ: negligible quantization error); the student is the
mixed-precision policy being fine-tuned.  loss = alpha * CE + (1 - alpha)
* T^2 * KL.  The result is a ``loss_fn`` for
``train.step.make_train_step(cfg, loss_fn=...)``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def teacher_policy_arrays(policy_arrays: dict) -> dict:
    """Bits arrays at 16 everywhere (quantization error ~0 at LSQ
    steps)."""
    return {g: {k: np.full_like(np.asarray(v, np.float32), 16.0)
                for k, v in slots.items()}
            for g, slots in policy_arrays.items()}


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 2.0) -> torch.Tensor:
    """T^2 times the cross entropy of the student's tempered distribution
    under the teacher's, averaged over the positions (0-d float32)."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.softmax(teacher_logits.float() / t, dim=-1)
    return -torch.mean(torch.sum(tp * sp, dim=-1)) * t * t


def make_distill_loss(base_loss_fn: Callable, apply_fn: Callable,
                      alpha: float = 0.5, temperature: float = 2.0
                      ) -> Callable:
    """Wrap ``base_loss_fn(params, policy_arrays, batch, cfg, impl) ->
    (loss, metrics)`` (``transformer.loss_fn``) with KD.  ``apply_fn`` is
    ``transformer.apply`` (it returns (logits, caches)).  As in the
    reference, the student's logits are a second train-mode forward of
    the params, and the teacher's a forward at 16 bits that records no
    gradient (the reference's ``stop_gradient`` of params and logits)."""
    def loss(params, policy_arrays, batch, cfg, impl: str = "auto"):
        task, metrics = base_loss_fn(params, policy_arrays, batch, cfg, impl)
        s_logits, _ = apply_fn(params, policy_arrays, batch["tokens"], cfg,
                               mode="train", impl=impl)
        with torch.no_grad():
            t_logits, _ = apply_fn(params, teacher_policy_arrays(
                policy_arrays), batch["tokens"], cfg, mode="train",
                impl=impl)
        kd = kd_loss(s_logits, t_logits, temperature)
        metrics = dict(metrics, kd_loss=kd.detach())
        return alpha * task + (1 - alpha) * kd, metrics
    return loss
