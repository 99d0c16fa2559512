"""AdamW with float32, bf16 or rowwise-int8 moments — port of
``repro/optim/adamw.py`` as a ``torch.optim.Optimizer``.

One ``step`` equals the reference's ``AdamW.update``: an optional global
norm clip (the gradients scaled by min(1, clip / (norm + 1e-9)) in their
own dtype), the moments updated in float32 (in bf16 when stored as int8),
bias-corrected with the count's powers in float32, decoupled weight decay
on matrices only (ndim >= 2), and the parameter rounded once to its dtype.
Parameters are updated in place; the moments are the optimizer's state.

int8 storage (the paper's quantization applied to the optimizer): m as
int8 codes with one float32 scale per last-dim row, v in sqrt space as
uint8 codes, ``{'q', 's'}`` per leaf.  The reference stacks the layers of
the pattern on one leaf, so the layers' scalars at one path (the LSQ steps
``sw``, ``sa``) are one 1-D leaf with one scale, the largest over the
layers.  The port keeps the layers apart; ``share_scales`` names each such
set of 0-d leaves (``train.step.stacked_scalars``), and a step encodes the
set's moments stacked, as the reference does, so codes and scales are the
reference's.  Each leaf of a set keeps its own 0-d code and the shared 0-d
scale.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

STATE_DTYPES = ("f32", "bf16", "int8")


def _q8_encode(x: torch.Tensor, signed: bool = True) -> dict:
    xf = x.float()
    if xf.ndim == 0:
        amax = torch.clamp(xf.abs(), min=1e-30)
    else:
        amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-30)
    if signed:
        q = torch.clamp(torch.round(xf / amax * 127.0), -127, 127).to(
            torch.int8)
    else:
        q = torch.clamp(torch.round(torch.sqrt(torch.clamp(xf, min=0.0)
                                               / amax) * 255.0),
                        0, 255).to(torch.uint8)
    return {"q": q, "s": amax}


def _q8_decode(e: dict) -> torch.Tensor:
    q = e["q"]
    if q.dtype == torch.uint8:
        c = q.float() / 255.0
        return c * c * e["s"]
    return q.float() / 127.0 * e["s"]


def encode(x: torch.Tensor, dtype: str, signed: bool = True):
    """A moment in its storage form."""
    if dtype == "int8":
        return _q8_encode(x, signed)
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    return x.float()


def decode(e, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _q8_decode(e)
    return e.float()


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in float32, in order."""
    sq = torch.zeros((), dtype=torch.float32,
                     device=tensors[0].device if tensors else None)
    for t in tensors:
        sq = sq + torch.sum(torch.square(t.float()))
    return torch.sqrt(sq)


def learning_rate_at(lr, count: int) -> torch.Tensor:
    """The learning rate (a float or a schedule of the count) as a 0-d
    float32 tensor."""
    if callable(lr):
        return torch.as_tensor(lr(count), dtype=torch.float32)
    return torch.tensor(lr, dtype=torch.float32)


def bias_corrections(b1: float, b2: float, count: int):
    """1 - b^count for both betas, in float32 as the reference computes
    them."""
    c = torch.tensor(float(count), dtype=torch.float32)
    return (1 - torch.tensor(b1, dtype=torch.float32) ** c,
            1 - torch.tensor(b2, dtype=torch.float32) ** c)


class AdamW(torch.optim.Optimizer):
    """``torch.optim.Optimizer`` over a list of tensors; ``state[p]`` holds
    ``{'m', 'v'}`` in the storage form (a tensor, or ``{'q', 's'}`` for
    int8) and ``count`` the number of updates taken."""

    def __init__(self, params, learning_rate: Union[float, Callable] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, state_dtype: str = "f32",
                 grad_clip: float = 0.0):
        if state_dtype not in STATE_DTYPES:
            raise ValueError(f"state_dtype must be one of {STATE_DTYPES}, "
                             f"got {state_dtype!r}")
        super().__init__(params, {})
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.state_dtype = state_dtype
        self.grad_clip = grad_clip
        self.count = 0
        self.shared: list = []
        for p in self.leaves():
            z = torch.zeros_like(p, dtype=torch.float32)
            self.state[p] = {"m": encode(z, state_dtype, signed=True),
                             "v": encode(z, state_dtype, signed=False)}

    def leaves(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def share_scales(self, sets: Sequence[Sequence[int]]) -> None:
        """Each set (indices into ``leaves()``, all 0-d) is one stacked 1-D
        leaf of the reference: its int8 moments share one scale.  Float32
        and bf16 moments are the same either way."""
        params = self.leaves()
        for idx in sets:
            if any(params[i].ndim != 0 for i in idx):
                raise ValueError(f"share_scales takes 0-d leaves, got "
                                 f"{[tuple(params[i].shape) for i in idx]}")
        self.shared = [list(idx) for idx in sets]

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence] = None):
        """One update from ``grads`` (one a parameter, any float dtype;
        default each parameter's ``.grad``)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.leaves()
        grads = [p.grad for p in params] if grads is None else list(grads)
        self.count += 1
        lr = learning_rate_at(self.learning_rate, self.count)
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
        bc1, bc2 = bias_corrections(self.b1, self.b2, self.count)
        q8 = self.state_dtype == "int8"
        mdt = torch.bfloat16 if q8 else torch.float32
        stacked = {i for idx in self.shared for i in idx} if q8 else set()
        new = {}
        for i, (p, g) in enumerate(zip(params, grads)):
            st = self.state[p]
            gf = g.float()
            m = (self.b1 * decode(st["m"], self.state_dtype)
                 + (1 - self.b1) * gf).to(mdt)
            v = (self.b2 * decode(st["v"], self.state_dtype)
                 + (1 - self.b2) * gf * gf).to(mdt)
            upd = (m.float() / bc1) / (
                torch.sqrt(v.float() / bc2) + self.eps)
            if self.weight_decay and p.ndim >= 2:
                upd = upd + self.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
            if i in stacked:
                new[i] = (m, v)
            else:
                st["m"] = encode(m, self.state_dtype, signed=True)
                st["v"] = encode(v, self.state_dtype, signed=False)
        for idx in (self.shared if q8 else ()):
            for name, k, signed in (("m", 0, True), ("v", 1, False)):
                e = _q8_encode(torch.stack([new[i][k] for i in idx]), signed)
                for r, i in enumerate(idx):
                    self.state[params[i]][name] = {"q": e["q"][r],
                                                   "s": e["s"][0]}
        return loss
