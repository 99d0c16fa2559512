"""Model stack and LM loss for the olmo family — port of
``repro/models/transformer.py``.

The JAX model stacks the repeat pattern and runs it under ``lax.scan`` (or
bucketed scans) to bound XLA compile time; eager PyTorch needs neither, so
the port keeps the pattern as a per-layer list, ``params["pat"][r]["p0"]``
— the layout of the reference's ``pack_params(..., layout="unrolled")`` —
and runs it as a Python loop.  ``models/layout.py`` therefore has no
counterpart.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import quant
from repro_torch.core.policy import (PIN_EDGE_BITS, PIN_MIN_IN_FEATURES,
                                     PIN_NARROW_BITS, CacheUnit,
                                     PrecisionPolicy, QuantUnit)
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp

HEAD_ACT_STEP = 0.05       # tied LM head's activation step (pinned 8-bit)


def _check_supported(cfg) -> None:
    for bdef in tuple(cfg.prefix) + tuple(cfg.pattern):
        if bdef.mixer != "gqa" or bdef.ffn != "swiglu":
            raise NotImplementedError(
                f"block {bdef} is not ported: the port runs GQA + SwiGLU "
                f"blocks (the rest of the zoo is ROADMAP Queue 1 item 13)")
    if cfg.prefix or not cfg.tie_embeddings or cfg.activation != "silu":
        raise NotImplementedError("prefix blocks, an untied LM head and "
                                  "non-SiLU gates are ROADMAP Queue 1 "
                                  "item 13")


def init_block(gen: torch.Generator, cfg, device) -> dict:
    return {"norm1": common.init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                      device),
            "attn": attn.init_gqa(gen, cfg, device),
            "norm2": common.init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                      device),
            "mlp": mlp.init_dense_mlp(gen, cfg, device)}


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Random raw (QAT-layout) params with the reference's shapes and init
    formulas, drawn on ``device`` from ``torch.Generator(device)`` seeded
    with ``seed``.  (The numbers differ from JAX's: tests feed JAX params
    through ``repro_torch.convert.from_jax_params`` instead.)  For
    training, ``train.step.init_train_state`` sets every leaf (weights and
    LSQ steps) to require grad."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                        dtype=cfg.param_dtype, device=dev) * 0.02
    params: dict = {"embed": {"w": table,
                              "sw": quant.init_step_from_tensor(table, 8.0)}}
    params["pat"] = [{f"p{j}": init_block(gen, cfg, dev)
                      for j, _ in enumerate(cfg.pattern)}
                     for _ in range(cfg.n_repeats)]
    params["final_norm"] = common.init_norm(cfg.norm, cfg.d_model,
                                            cfg.param_dtype, dev)
    return params


def block_apply(p: dict, x: torch.Tensor, bits: dict, cfg, mode: str, cache,
                positions: torch.Tensor, impl: str = "auto",
                hvp: bool = False):
    """One GQA + SwiGLU block.  Returns (x, new_cache)."""
    h = common.apply_norm(cfg.norm, x, p["norm1"])
    y, new_cache = attn.gqa_apply(p["attn"], h, bits, cfg, mode, cache,
                                  positions, impl, hvp)
    x = x + y
    h = common.apply_norm(cfg.norm, x, p["norm2"])
    return x + mlp.dense_mlp_apply(p["mlp"], h, bits, impl, hvp), new_cache


def init_caches(cfg, batch: int, max_seq: int, cache_dtype, device,
                cache_bits: Optional[int] = None,
                page_geom: Optional[tuple] = None) -> dict:
    """Preallocated per-layer decode caches: {"pat": [{"p0": leaf}, ...]}
    with full-dtype {'k','v'} leaves, or quantized code+scale leaves at
    ``cache_bits`` (4 or 8) in every layer.  ``page_geom`` = (n_pages,
    page_size) gives page pools in place of the (B, S_max) buffers."""
    def leaf():
        if page_geom is not None:
            n_pages, page_size = page_geom
            if cache_bits is None:
                return attn.init_gqa_paged_cache(cfg, n_pages, page_size,
                                                 cache_dtype, device)
            return attn.init_gqa_paged_quant_cache(cfg, batch, n_pages,
                                                   page_size, cache_bits,
                                                   device)
        if cache_bits is None:
            return attn.init_gqa_cache(cfg, batch, max_seq, cache_dtype,
                                       device)
        return attn.init_gqa_quant_cache(cfg, batch, max_seq, cache_bits,
                                         device)
    return {"pat": [{f"p{j}": leaf() for j, _ in enumerate(cfg.pattern)}
                    for _ in range(cfg.n_repeats)]}


def _embed(params: dict, cfg, tokens: torch.Tensor, impl: str = "auto",
           hvp: bool = False) -> torch.Tensor:
    p = params["embed"]
    if "wq" in p:               # serve layout: int8 codes, gather first
        rows = p["wq"][tokens]
        x = rows.to(cfg.compute_dtype) * p["scale"].to(cfg.compute_dtype)
    else:
        table = quant.fake_quant(p["w"], p["sw"], PIN_EDGE_BITS, impl, hvp)
        # embedding's backward gave the same bits on every run on the
        # card (chip_smoke's train and alps repeat gates)
        x = torch.nn.functional.embedding(tokens, table)
    return x.to(cfg.compute_dtype)


def _head(params: dict, cfg, x: torch.Tensor, impl: str = "auto",
          hvp: bool = False) -> torch.Tensor:
    """Tied LM head, weights and input activations pinned 8-bit.  A plain
    product (the JAX package leaves it to XLA), here ``torch.matmul``.  As
    in the reference, the table is fake-quantized here and in ``_embed``
    (two fake-quant sites; their gradients add)."""
    p = params["embed"]
    if "wq" in p:
        w = (p["wq"].to(x.dtype) * p["scale"].to(x.dtype)).t()
    else:
        w = quant.fake_quant(p["w"], p["sw"], PIN_EDGE_BITS, impl, hvp).t()
    xq = quant.fake_quant(x, HEAD_ACT_STEP, PIN_EDGE_BITS, impl, hvp)
    return kref.matmul(xq, w.to(x.dtype))


def layer_bits(policy_arrays: dict, cfg, r: int) -> List[Dict[str, float]]:
    """Per-slot bits dicts of pattern layer ``r`` (host-side floats)."""
    return [{k: float(np.asarray(v)[r])
             for k, v in policy_arrays[f"pat{j}"].items()}
            for j in range(len(cfg.pattern))]


def apply(params: dict, policy_arrays: dict, tokens: torch.Tensor, cfg,
          mode: str = "train", caches: Optional[dict] = None,
          positions: Optional[torch.Tensor] = None, impl: str = "auto",
          logits_at: Optional[torch.Tensor] = None, hvp: bool = False):
    """Returns (logits, new_caches).

    tokens (B, S) int; positions (B, S) absolute positions (default
    arange); ``logits_at`` (B,) picks one position per row before the LM
    head (prefill needs only each request's last valid logits).  Prefill
    returns the per-layer K/V; decode updates ``caches`` in place.

    Train mode fake-quantizes every projection weight once
    (``common.prequantize_params``) and, when a gradient is recorded,
    checkpoints each layer (``torch.utils.checkpoint``, non-reentrant: the
    backward recomputes the layer's forward), the counterpart of the
    reference's ``jax.checkpoint(body)``.  ``hvp=True`` is the form that
    ``torch.func.jvp`` of ``torch.func.grad`` differentiates (HAWQ's
    Hessian-vector products, ``core/metrics/hawq.py``): it runs the layers
    without checkpointing, whose saved-tensor hooks ``torch.func.grad``
    refuses, and gives every LSQ fake-quant the backward in torch ops that
    forward mode can differentiate (``quant.LsqFakeQuantHvp``).  The default
    checkpoints and keeps the backward kernel.
    """
    _check_supported(cfg)
    x = _embed(params, cfg, tokens, impl, hvp)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    remat = not hvp and mode == "train" and torch.is_grad_enabled()
    if mode == "train":
        params = common.prequantize_params(params, policy_arrays,
                                           slot_index(cfg), impl, hvp)
    new_pat = []
    for r in range(cfg.n_repeats):
        bits = layer_bits(policy_arrays, cfg, r)
        out = {}
        for j, _ in enumerate(cfg.pattern):
            cache = None if caches is None else caches["pat"][r][f"p{j}"]
            args = (params["pat"][r][f"p{j}"], x, bits[j], cfg, mode, cache,
                    positions, impl, hvp)
            x, out[f"p{j}"] = (checkpoint(block_apply, *args,
                                          use_reentrant=False) if remat
                               else block_apply(*args))
        new_pat.append(out)
    x = common.apply_norm(cfg.norm, x, params["final_norm"])
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at][:, None]
    return _head(params, cfg, x, impl, hvp), {"pat": new_pat}


# ===================================================================== loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_weight: float = 1e-4):
    """Mean next-token cross entropy plus the z-loss z_weight * lse^2, over
    the tokens ``mask`` keeps, and the argmax accuracy
    (``repro/models/transformer.py:560-581``).  Returns (loss, accuracy),
    0-d float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    per_tok = (lse - label_logit) + z_weight * lse ** 2
    mask = torch.ones_like(lse) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).float() * mask).sum() / denom
    return loss, acc


def loss_fn(params: dict, policy_arrays: dict, batch: dict, cfg,
            impl: str = "auto", hvp: bool = False):
    """Next-token LM loss of ``batch`` ({'tokens', 'labels'[, 'loss_mask']},
    (B, S) tensors): (loss, metrics) with metrics {'loss', 'accuracy',
    'aux_loss'} (0-d tensors, no host sync).  The olmo family has no
    auxiliary loss and no multi-token head, so aux_loss is 0 and the loss
    is the cross entropy, as in ``repro/models/transformer.py:584-612``.
    ``hvp`` as in ``apply``."""
    logits, _ = apply(params, policy_arrays, batch["tokens"], cfg,
                      mode="train", impl=impl, hvp=hvp)
    loss, acc = cross_entropy(logits, batch["labels"],
                              batch.get("loss_mask"))
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux, {"loss": loss.detach(), "accuracy": acc,
                        "aux_loss": aux}


# ============================================================ policy builder
def _unit(group, layer, slot, tensors, n_params, macs, in_features,
          pinned=None) -> QuantUnit:
    name = f"{group}.{slot}.L{layer}"
    if pinned is None and in_features < PIN_MIN_IN_FEATURES:
        pinned = PIN_NARROW_BITS
    return QuantUnit(name=name, group=group, layer=layer, slot=slot,
                     tensors=tuple(tensors), n_params=int(n_params),
                     macs_per_token=float(macs), in_features=int(in_features),
                     pinned_bits=pinned)


def _block_units(cfg, bdef, group: str, layer: int, base: tuple):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ff = bdef.d_ff or cfg.d_ff
    nqkv = d * (h * dh + 2 * hkv * dh)
    n_up = 2 * d * ff
    return [
        _unit(group, layer, "attn_qkv",
              [base + ("attn", w, "w") for w in ("wq", "wk", "wv")],
              nqkv, nqkv, d),
        _unit(group, layer, "attn_wo", [base + ("attn", "wo", "w")],
              h * dh * d, h * dh * d, h * dh),
        _unit(group, layer, "mlp_gateup",
              [base + ("mlp", "gate", "w"), base + ("mlp", "up", "w")],
              n_up, n_up, d),
        _unit(group, layer, "mlp_down", [base + ("mlp", "down", "w")],
              ff * d, ff * d, ff),
    ]


def build_policy(cfg, b_hi: float = 4.0, b_lo: float = 2.0
                 ) -> PrecisionPolicy:
    """Every quant unit of the model (with the pinned 8-bit embedding) and
    every per-layer KV-cache unit, named as in the reference."""
    _check_supported(cfg)
    units = [_unit("embed", 0, "embed", [("embed", "w")],
                   cfg.vocab * cfg.d_model, 0.0, cfg.vocab,
                   pinned=PIN_EDGE_BITS)]
    cache_units = []
    for r in range(cfg.n_repeats):
        for j, bdef in enumerate(cfg.pattern):
            units.extend(_block_units(cfg, bdef, f"pat{j}", r,
                                      ("pat", f"p{j}")))
            cache_units.append(CacheUnit(
                name=f"pat{j}.cache.L{r}", group=f"pat{j}", layer=r,
                kv_elems_per_token=2 * cfg.n_kv_heads * cfg.head_dim))
    return PrecisionPolicy(units, b_hi=b_hi, b_lo=b_lo,
                           cache_units=cache_units)


def fetch_unit_tensor(params: dict, unit: QuantUnit, path: tuple):
    """Weight tensor and LSQ step of one member tensor of a unit (the
    reference's, for the port's layout: pattern layer ``r`` is
    ``params["pat"][r]``, not index ``r`` of a stacked leaf)."""
    node = params
    for key in path[:-1]:
        node = node[key]
        if key == "pat":
            node = node[unit.layer]
    if "sw" not in node:
        raise KeyError(f"no step size for {path}")
    return node[path[-1]], node["sw"]


def slot_index(cfg) -> Dict[tuple, tuple]:
    """Param path of a projection (inside a layer) -> (group, slot)."""
    index = {}
    for u in build_policy(cfg).units:
        for t in u.tensors:
            index[t[:-1] if t[-1] == "w" else t] = (u.group, u.slot)
    return index
