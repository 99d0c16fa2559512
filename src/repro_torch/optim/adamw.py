"""AdamW with float32, bf16 or rowwise-int8 moments — port of
``repro/optim/adamw.py`` as a ``torch.optim.Optimizer``.

One ``step`` equals the reference's ``AdamW.update``: an optional global
norm clip (the gradients scaled by min(1, clip / (norm + 1e-9)) in their
own dtype), the moments updated in float32 (in bf16 when stored as int8),
bias-corrected with the count's powers in float32, decoupled weight decay
on matrices only (ndim >= 2, counted on the reference's stacked leaf: a
pattern layer's LayerNorm scale or bias is a row of an (L, d) matrix
there, and decays), and the parameter rounded once to its dtype.
Parameters are updated in place; the moments are the optimizer's state.

int8 storage (the paper's quantization applied to the optimizer): m as
int8 codes with one float32 scale per last-dim row, v in sqrt space as
uint8 codes, ``{'q', 's'}`` per leaf.  The reference stacks the layers of
the pattern on one leaf, so the layers' scalars at one path (the LSQ steps
``sw``, ``sa``) are one 1-D leaf with one scale, the largest over the
layers.  The port keeps the layers apart; ``stack_layers`` names each set
of leaves that is one stacked leaf there (``train.step.stacked_leaves``),
and a step encodes the moments of a set of 0-d leaves stacked, as the
reference does, so codes and scales are the reference's.  Each leaf of
such a set keeps its own 0-d code and the shared 0-d scale.
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
        self.shared: list = []          # sets of 0-d leaves: one scale
        self.layered: set = set()       # leaves of a stacked leaf
        for p in self.leaves():
            # each moment its own storage: a bank's update writes its slices
            # in place
            self.state[p] = {
                "m": encode(torch.zeros_like(p, dtype=torch.float32),
                            state_dtype, signed=True),
                "v": encode(torch.zeros_like(p, dtype=torch.float32),
                            state_dtype, signed=False)}

    def leaves(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def stack_layers(self, sets: Sequence[Sequence[int]]) -> None:
        """Each set (indices into ``leaves()``, one shape) is one leaf of
        the reference that stacks the layers: its leaves decay as a leaf
        of one more dimension, and the int8 moments of a set of 0-d leaves
        share one scale (float32 and bf16 moments are the same either
        way)."""
        params = self.leaves()
        for idx in sets:
            shapes = [tuple(params[i].shape) for i in idx]
            if len(set(shapes)) != 1:
                raise ValueError(f"stack_layers takes leaves of one shape, "
                                 f"got {shapes}")
        self.shared = [list(idx) for idx in sets
                       if params[idx[0]].ndim == 0]
        self.layered = {i for idx in sets for i in idx}

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence] = None):
        """One update from ``grads`` (one a parameter, any float dtype;
        default each parameter's ``.grad``).  A leaf of 3 or more
        dimensions (an expert bank) updates one slice of its first
        dimension at a time, as the reference's ``upd_leaf`` scans its
        stacked leaves, so that only one slice's float32 temporaries are
        live; the clipped gradient is made one leaf at a time too."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.leaves()
        grads = [p.grad for p in params] if grads is None else list(grads)
        self.count += 1
        lr = learning_rate_at(self.learning_rate, self.count)
        scale = None
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        bc1, bc2 = bias_corrections(self.b1, self.b2, self.count)
        q8 = self.state_dtype == "int8"
        stacked = {i for idx in self.shared for i in idx} if q8 else set()
        new = {}
        for i, (p, g) in enumerate(zip(params, grads)):
            st = self.state[p]
            if scale is not None:
                g = g * scale.to(g.dtype)
            decay = bool(self.weight_decay) and \
                p.ndim + (i in self.layered) >= 2
            if p.ndim >= 3 and p.shape[0] > 1:
                for j in range(p.shape[0]):
                    m, v = self._update(p[j], g[j], _row(st["m"], j),
                                        _row(st["v"], j), lr, bc1, bc2,
                                        decay)
                    _set_row(st["m"], j, encode(m, self.state_dtype,
                                                signed=True))
                    _set_row(st["v"], j, encode(v, self.state_dtype,
                                                signed=False))
                continue
            m, v = self._update(p, g, st["m"], st["v"], lr, bc1, bc2, decay)
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

    def _update(self, p, g, m_e, v_e, lr, bc1, bc2, decay: bool):
        """One tensor's update in place: the new moments m, v (float32, or
        bf16 when stored as int8) from their stored forms, and p moved."""
        mdt = torch.bfloat16 if self.state_dtype == "int8" else torch.float32
        gf = g.float()
        m = (self.b1 * decode(m_e, self.state_dtype)
             + (1 - self.b1) * gf).to(mdt)
        v = (self.b2 * decode(v_e, self.state_dtype)
             + (1 - self.b2) * gf * gf).to(mdt)
        upd = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + self.eps)
        if decay:
            upd = upd + self.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        return m, v


def _row(e, j):
    """Slice ``j`` of a stored moment's first dimension (a tensor, or an
    int8 moment's ``{'q', 's'}``, whose scales are per last-dim row)."""
    return {k: t[j] for k, t in e.items()} if isinstance(e, dict) else e[j]


def _set_row(e, j, new) -> None:
    if isinstance(e, dict):
        for k in e:
            e[k][j] = new[k]
    else:
        e[j] = new
