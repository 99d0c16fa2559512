"""Train step of the port: microbatched gradient accumulation and LSQ QAT
— port of ``repro/train/step.py``.

One step serves every mixed-precision policy: the bits arrays ride in the
``TrainState`` and pick each layer's fake-quant bits at run time.  Each
microbatch's forward and backward checkpoints every layer
(``models/transformer.apply``), so live activation memory is about one
microbatch times one layer.  Unlike the reference's functional step, the
port updates in place: the optimizer (a ``torch.optim.Optimizer`` over
the param leaves) writes the new params and moments into the state's
tensors, and the step returns the same state.

The reference's int8 gradient all-reduce (``grad_compression='int8'``)
needs a mesh: it waits for ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import convert, tree
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW, global_norm


@dataclasses.dataclass
class TrainState:
    """step: updates taken; params: the model's leaves (requires grad);
    optimizer: built over ``tree.leaves(params)``, in that order; policy:
    the bits arrays ``{group: {slot: (L,) float32}}`` (host numpy)."""
    step: int
    params: dict
    optimizer: torch.optim.Optimizer
    policy: Dict[str, Dict[str, np.ndarray]]
    grad_error: Any = None

    def moments(self, name: str) -> dict:
        """The optimizer's ``name`` moments as a tree shaped like params."""
        return tree.map_tree(lambda p: self.optimizer.state[p][name],
                             self.params)

    def to_tree(self) -> dict:
        """The state as the reference's ``TrainState`` pytree (numpy
        leaves, layers stacked): step, params, opt_state {count, m, v},
        policy — the keys its checkpoints use.  An int8 moment of the
        layers' 0-d leaves is the reference's stacked one: codes (L,) and
        the one shared scale (1,)."""
        return {"step": np.int32(self.step),
                "params": convert.to_jax_tree(self.params),
                "opt_state": {"count": np.int32(self.optimizer.count),
                              "m": _shared_scales(convert.to_jax_tree(
                                  self.moments("m"))),
                              "v": _shared_scales(convert.to_jax_tree(
                                  self.moments("v")))},
                "policy": {g: {k: np.asarray(v, np.float32)
                               for k, v in slots.items()}
                           for g, slots in self.policy.items()}}

    @torch.no_grad()
    def load_tree(self, t: dict) -> None:
        """Take a tree of ``to_tree``'s layout (from either package's
        checkpoint) into this state, in place."""
        dev = tree.leaves(self.params)[0].device
        for p, new in zip(tree.leaves(self.params),
                          tree.leaves(convert.from_jax_params(t["params"],
                                                              dev))):
            p.copy_(new)
        for name in ("m", "v"):
            loaded = convert.from_jax_params(
                _per_layer_scales(t["opt_state"][name]), dev)
            for p, new in zip(tree.leaves(self.params),
                              _per_leaf(loaded, self.params)):
                st = self.optimizer.state[p]
                cur = st[name]
                st[name] = ({k: new[k].to(v.dtype) for k, v in cur.items()}
                            if isinstance(cur, dict) else new.to(cur.dtype))
        self.optimizer.count = int(np.asarray(t["opt_state"]["count"]))
        self.step = int(np.asarray(t["step"]))
        self.policy = {g: {k: np.asarray(v, np.float32)
                           for k, v in slots.items()}
                       for g, slots in t["policy"].items()}


def _q8_nodes(node, fn):
    """``node`` with ``fn`` applied to each int8 moment ``{'q', 's'}``
    under ``"pat"`` whose codes are one per layer (a stacked 0-d leaf)."""
    if isinstance(node, dict):
        if set(node) == {"q", "s"} and np.ndim(node["q"]) == 1:
            return fn(node)
        return {k: _q8_nodes(v, fn) for k, v in node.items()}
    return node


def _shared_scales(t: dict) -> dict:
    def one(e):
        s = np.asarray(e["s"])
        if np.any(s != s[0]):
            raise ValueError("the layers' scales of a stacked int8 moment "
                             "differ: the optimizer was not given "
                             "stack_layers(stacked_leaves(params))")
        return {"q": e["q"], "s": s[:1]}
    return dict(t, pat=_q8_nodes(t["pat"], one)) if "pat" in t else t


def _per_layer_scales(t: dict) -> dict:
    def one(e):
        return {"q": e["q"], "s": np.broadcast_to(np.asarray(e["s"]),
                                                  np.shape(e["q"]))}
    return dict(t, pat=_q8_nodes(t["pat"], one)) if "pat" in t else t


def stacked_leaves(params: dict) -> list:
    """Index sets into ``tree.leaves(params)``: for each path inside the
    pattern's layers, that leaf in every layer.  The reference stacks each
    set on one leaf (the LSQ steps on a 1-D one)."""
    at = {}
    for i, (path, _) in enumerate(tree.flatten(params)):
        if path[:1] == ("pat",):
            at.setdefault(path[2:], []).append(i)
    return list(at.values())


def _per_leaf(moments, params) -> list:
    """The node of ``moments`` at each param leaf's path, in the params'
    order (a tensor, or an int8 moment's ``{'q', 's'}`` dict)."""
    if isinstance(params, dict):
        return [m for k in sorted(params)
                for m in _per_leaf(moments[k], params[k])]
    if isinstance(params, list):
        return [m for i, v in enumerate(params)
                for m in _per_leaf(moments[i], v)]
    return [moments]


def train_state_from_params(params: dict, optimizer: Callable, policy,
                            step: int = 0) -> TrainState:
    """A state over existing params (e.g. ``convert.from_jax_params``):
    every leaf is set to require grad and ``optimizer(leaves)`` builds the
    optimizer (``functools.partial(AdamW, learning_rate=...)``); an AdamW
    is told which leaves the reference stacks (``stacked_leaves``), for
    its weight decay and its int8 scales."""
    leaves = tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    pa = policy.as_arrays() if hasattr(policy, "as_arrays") else policy
    opt = optimizer(leaves)
    if isinstance(opt, AdamW):
        opt.stack_layers(stacked_leaves(params))
    return TrainState(step=step, params=params, optimizer=opt, policy=pa)


def init_train_state(cfg, optimizer: Callable, seed: int, policy,
                     device="cuda") -> TrainState:
    """Fresh params from ``seed`` (``transformer.init_params``) and the
    optimizer over them."""
    return train_state_from_params(tf.init_params(cfg, seed, device),
                                   optimizer, policy)


def _split_microbatches(batch: Dict, n: int) -> list:
    """``n`` slices of the batch's rows: dim 0 of every entry, dim 1 of
    M-RoPE's (3, B, S) streams (``repro/train/step.py:42-50``)."""
    dims = {k: 1 if k == "mrope_positions" else 0 for k in batch}
    for k, v in batch.items():
        if v.shape[dims[k]] % n:
            raise ValueError(f"batch[{k!r}] of {v.shape[dims[k]]} rows does "
                             f"not split into {n} microbatches")
    return [{k: v.chunk(n, dim=dims[k])[i] for k, v in batch.items()}
            for i in range(n)]


def grad_compress_norm(grads) -> torch.Tensor:
    """Global L2 norm of the gradients (the reference's metric)."""
    return global_norm(list(grads))


def make_train_step(cfg, *, loss_fn: Optional[Callable] = None,
                    n_microbatches: int = 1, accum_dtype=torch.float32,
                    grad_compression: str = "none",
                    impl: str = "auto") -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): the loss's
    gradient with respect to every param leaf, averaged over
    ``n_microbatches`` slices of the batch (summed in ``accum_dtype``), then
    one optimizer update in place.  metrics: loss, accuracy, aux_loss
    (averaged over the microbatches) and grad_norm, as 0-d tensors on the
    params' device (reading them syncs; the step itself does not)."""
    loss_fn = loss_fn or tf.loss_fn
    if grad_compression == "int8":
        raise NotImplementedError("int8 gradient compression needs a mesh "
                                  "and its all-reduce: ROADMAP Queue 1 item "
                                  "14")
    if grad_compression != "none":
        raise ValueError(grad_compression)

    def grads_of(params, leaves, policy, mb):
        loss, metrics = loss_fn(params, policy, mb, cfg, impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, leaves)], metrics

    def train_step(state: TrainState, batch):
        leaves = tree.leaves(state.params)
        opt_leaves = state.optimizer.leaves()
        if len(leaves) != len(opt_leaves) or any(
                a is not b for a, b in zip(leaves, opt_leaves)):
            raise ValueError("the optimizer was not built over "
                             "tree.leaves(state.params)")
        if n_microbatches == 1:
            grads, metrics = grads_of(state.params, leaves, state.policy,
                                      batch)
        else:
            acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for p in leaves]
            history = []
            for mb in _split_microbatches(batch, n_microbatches):
                g, m = grads_of(state.params, leaves, state.policy, mb)
                acc = [a + gi.to(accum_dtype) for a, gi in zip(acc, g)]
                history.append(m)
            grads = [a / n_microbatches for a in acc]
            metrics = {k: torch.stack([m[k] for m in history]).mean()
                       for k in history[0]}
        state.optimizer.step(grads=grads)
        state.step += 1
        metrics = dict(metrics, grad_norm=grad_compress_norm(grads))
        return state, metrics

    return train_step
