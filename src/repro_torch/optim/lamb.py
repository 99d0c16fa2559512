"""LAMB (the paper's BERT fine-tuning recipe, §3.4.3) — port of
``repro/optim/lamb.py`` as a ``torch.optim.Optimizer``.

Adam moments in float32 and a trust ratio ||w|| / ||update|| for each
parameter.  The reference takes the ratio over each leaf of its tree, in
which the pattern's layers are stacked; the port's leaves are the layers'
own tensors, so each layer gets its own ratio (the per-layer LAMB of You
et al.).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.optim.adamw import bias_corrections, learning_rate_at


class Lamb(torch.optim.Optimizer):
    def __init__(self, params, learning_rate: Union[float, Callable] = 3.8e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01):
        super().__init__(params, {})
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        for p in self.leaves():
            self.state[p] = {"m": torch.zeros_like(p, dtype=torch.float32),
                             "v": torch.zeros_like(p, dtype=torch.float32)}

    def leaves(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.leaves()
        grads = [p.grad for p in params] if grads is None else list(grads)
        self.count += 1
        lr = learning_rate_at(self.learning_rate, self.count)
        bc1, bc2 = bias_corrections(self.b1, self.b2, self.count)
        for p, g in zip(params, grads):
            st = self.state[p]
            gf = g.float()
            st["m"] = self.b1 * st["m"] + (1 - self.b1) * gf
            st["v"] = self.b2 * st["v"] + (1 - self.b2) * gf * gf
            u = (st["m"] / bc1) / (
                torch.sqrt(st["v"] / bc2) + self.eps)
            if self.weight_decay and p.ndim >= 2:
                u = u + self.weight_decay * p.float()
            w_norm = torch.linalg.vector_norm(p.float())
            u_norm = torch.linalg.vector_norm(u)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, 1.0)
            p.copy_((p.float() - lr * trust * u).to(p.dtype))
        return loss
