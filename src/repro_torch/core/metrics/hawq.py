"""HAWQ-v3 (paper Appendix C), the commensurate baseline — port of
``repro/core/metrics/hawq.py``.

G_l = avg Hessian trace(l) x ||Q_4(W_l) - Q_2(W_l)||^2, summed over a
unit's member tensors.  The average trace of each tensor's diagonal block
is Hutchinson's estimate: for Rademacher v, E[v_l . (Hv)_l] = trace(H_ll),
and one Hessian-vector product of the whole model gives every block's
estimate at once.  The products are forward over reverse, as the
reference's ``jax.jvp`` of ``jax.grad``: ``torch.func.jvp`` of
``torch.func.grad``.  The model's loss for them is ``hvp_loss``: train
mode with ``hvp=True``, which runs the layers without checkpointing
(``torch.func.grad`` refuses its saved-tensor hooks) and gives the LSQ
fake-quant its backward in torch ops, which the jvp differentiates
(``core.quant.LsqFakeQuantHvp``).  Under that jvp the
LSQ forward's ``round`` passes no tangent from x, only from the steps,
exactly as in the reference.

The reference reads each entry of ``tensor_paths`` whole; its callers pass
whole-leaf paths, so each layer of a stacked slot gets the trace and the
perturbation of all its layers together.  The port keeps its layers apart
and computes HAWQ per layer, and per expert in an expert bank:
``unit_tensor_paths`` gives each unit's member tensors their own layer's
paths (``("pat", r, "p0", "attn", "wq", "w")``, the reference's ``t +
(u.layer,)``), and an expert's its own expert of the bank (``("pat", r,
"p0", "moe", "gate", "w", e)``, the reference's ``t + (u.layer, u.sub)``),
so each expert reads its own trace and its own ``||Q4 - Q2||^2`` at its
own range.

The probes are drawn from a ``torch.Generator`` on the params' device,
seeded with ``HawqConfig.seed``: the same distribution as the reference's
``jax.random.rademacher``, not the same bits (threefry is ROADMAP Queue 1
item 11).  ``probes=`` takes the vectors from the caller instead (the
tests inject JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.core import quant


@dataclasses.dataclass
class HawqConfig:
    n_probes: int = 8
    seed: int = 0


def hvp_loss(cfg, policy_arrays, impl: str = "auto") -> Callable:
    """loss(params, batch) -> the model's scalar LM loss, in the form the
    Hessian-vector products differentiate: ``transformer.loss_fn`` with
    ``hvp=True``."""
    from repro_torch.models import transformer as tf

    def loss(params, batch):
        return tf.loss_fn(params, policy_arrays, batch, cfg, impl,
                          hvp=True)[0]
    return loss


def unit_tensor_paths(policy) -> Dict[str, tuple]:
    """"<unit name>/<tensor path>" -> the member tensor's path in the
    port's params, each selectable unit's layer picked out of the
    per-layer list and a per-expert unit's expert (``u.sub``) out of its
    bank: ``("pat", r, "p0", "moe", "gate", "w", e)``, the counterpart of
    the reference's ``t + (u.layer, u.sub)`` on its stacked leaves (the
    keys are the reference's)."""
    def path(u, t):
        if t[0] != "pat":
            return t
        sub = () if u.sub is None else (u.sub,)
        return t[:1] + (u.layer,) + t[1:] + sub
    return {f"{u.name}/{t}": path(u, t)
            for u in policy.selectable_units() for t in u.tensors}


def rademacher_probes(params, cfg: HawqConfig) -> Iterator[dict]:
    """``cfg.n_probes`` trees shaped like ``params``, one at a time: +-1
    in each floating leaf's dtype, zeros elsewhere, drawn leaf by leaf in
    ``tree.flatten`` order from one generator on the params' device."""
    flat = tree.flatten(params)
    gen = torch.Generator(flat[0][1].device).manual_seed(cfg.seed)
    for _ in range(cfg.n_probes):
        vals = {}
        for path, leaf in flat:
            if leaf.is_floating_point():
                bit = torch.randint(0, 2, leaf.shape, generator=gen,
                                    device=leaf.device)
                vals[path] = (2 * bit - 1).to(leaf.dtype)
            else:
                vals[path] = torch.zeros_like(leaf)
        yield _rebuild(params, vals)


def _rebuild(node, vals: dict, prefix: tuple = ()):
    if isinstance(node, dict):
        return {k: _rebuild(v, vals, prefix + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, vals, prefix + (i,))
                          for i, v in enumerate(node))
    return vals[prefix]


def _get_path(node, path):
    for p in path:
        node = node[p]
    return node


def hutchinson_traces(loss_fn: Callable, params,
                      unit_paths: Dict[str, Sequence], cfg: HawqConfig,
                      *batches, probes: Optional[List[dict]] = None
                      ) -> Dict[str, float]:
    """Per-entry average diagonal-block Hessian trace estimates.

    loss_fn(params, *batches) -> 0-d loss; unit_paths: name -> path of a
    leaf (or of one layer's leaf) in ``params``.  Each probe is one
    ``torch.func.jvp`` of ``torch.func.grad``; the products v . Hv add up
    on the device in float64 (the reference adds Python floats), and the
    host reads them once.  Returns name -> trace(H_ll) / n_l."""
    params = tree.map_tree(lambda t: t.detach(), params)
    if probes is None:
        probes = rademacher_probes(params, cfg)
    grad_fn = torch.func.grad(lambda p: loss_fn(p, *batches))
    names = list(unit_paths)
    acc, n_probes = None, 0
    for v in probes:
        _, hv = torch.func.jvp(grad_fn, (params,), (v,))
        dots = torch.stack([
            torch.vdot(_get_path(v, unit_paths[n]).float().reshape(-1),
                       _get_path(hv, unit_paths[n]).float().reshape(-1))
            for n in names]).double()
        acc = dots if acc is None else acc + dots
        n_probes += 1
        del v, hv
    sums = acc.tolist()
    return {n: sums[i] / (n_probes
                          * _get_path(params, unit_paths[n]).numel())
            for i, n in enumerate(names)}


def quant_perturbation_l2sq(w: torch.Tensor, b_hi: float, b_lo: float
                            ) -> float:
    """||Q_hi(W) - Q_lo(W)||^2 with HAWQ's range-based steps (Appendix
    C): step = max(|min W|, |max W|) / 2^(b-1), in float32."""
    w = w.detach().float()
    rng = torch.maximum(torch.abs(w.min()), torch.abs(w.max()))
    deq = {}
    for b in (b_hi, b_lo):
        step = rng / (2.0 ** (b - 1.0))
        deq[b] = quant.quantize_int(w, step, float(b)) * step
    return float(torch.sum((deq[b_hi] - deq[b_lo]) ** 2))


def hawq_gains(policy, loss_fn: Callable, params,
               tensor_paths: Optional[Dict[str, Sequence]],
               cfg: HawqConfig, *batches,
               probes: Optional[List[dict]] = None) -> Dict[str, float]:
    """Per-unit gains: sum over member tensors of trace(H_tt)/n_t x
    ||Q_hi(W_t) - Q_lo(W_t)||^2.  tensor_paths: "<unit name>/<tensor
    path>" -> path of the tensor in ``params`` (None: per layer,
    ``unit_tensor_paths``); loss_fn as ``hvp_loss`` builds it."""
    if tensor_paths is None:
        tensor_paths = unit_tensor_paths(policy)
    traces = hutchinson_traces(loss_fn, params, tensor_paths, cfg, *batches,
                               probes=probes)
    gains: Dict[str, float] = {}
    for u in policy.selectable_units():
        total = 0.0
        for t in u.tensors:
            key = f"{u.name}/{t}"
            w = _get_path(params, tensor_paths[key])
            total += traces[key] * quant_perturbation_l2sq(
                w, policy.b_hi, policy.b_lo)
        gains[u.name] = total
    return gains
