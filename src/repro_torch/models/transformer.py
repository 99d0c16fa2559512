"""Model stack and LM loss of the dense zoo (the olmo family,
internlm2, deepseek, granite, qwen2-vl's M-RoPE backbone, and the encoders
bert-base and hubert-xlarge), of dbrx's mixture of experts and of
deepseek-v3 (MLA, its dense prefix blocks, the shared expert and the
multi-token-prediction loss) — port of ``repro/models/transformer.py``.

The JAX model stacks the repeat pattern and runs it under ``lax.scan`` (or
bucketed scans) to bound XLA compile time; eager PyTorch needs neither, so
the port keeps the pattern as a per-layer list, ``params["pat"][r]["p0"]``
— the layout of the reference's ``pack_params(..., layout="unrolled")`` —
and runs it as a Python loop.  ``models/layout.py`` therefore has no
counterpart.  The ``prefix`` blocks run first, unrolled as in the
reference: ``params["prefix{i}"]``, policy group ``prefix{i}`` (one layer,
layer 0) and cache ``caches["prefix{i}"]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import quant
from repro_torch.core.policy import (CACHE_FULL_BITS, PIN_EDGE_BITS,
                                     PIN_MIN_IN_FEATURES, PIN_NARROW_BITS,
                                     CacheUnit,
                                     PrecisionPolicy, QuantUnit)
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp

HEAD_ACT_STEP = 0.05       # LM head's activation step (pinned 8-bit): the
                           # tied head's constant, the untied head's init
MTP_BITS = 4.0             # the MTP projection has no unit: the reference's
                           # default bits for such a node


def _check_supported(cfg) -> None:
    for bdef in tuple(cfg.prefix) + tuple(cfg.pattern):
        if (bdef.mixer, bdef.ffn) not in (
                ("gqa", "swiglu"), ("gqa", "gelu"), ("bidir", "swiglu"),
                ("bidir", "gelu"), ("gqa", "moe"), ("mla", "swiglu"),
                ("mla", "moe")):
            raise NotImplementedError(
                f"block {bdef} is not ported: the port runs GQA (causal or "
                f"bidirectional) blocks with a SwiGLU or GeLU FFN, causal "
                f"GQA with routed experts, and MLA with a SwiGLU FFN or "
                f"routed experts (the SSMs are ROADMAP Queue 1 item 13.4)")
    if cfg.activation not in ("silu", "gelu"):
        raise NotImplementedError("activations other than SiLU and GeLU are "
                                  "not a ported config's")
    if cfg.rope not in ("rope", "mrope", "none"):
        raise NotImplementedError(f"rope={cfg.rope!r} is not a rope of the "
                                  f"reference")


def init_block(gen: torch.Generator, cfg, bdef, device) -> dict:
    """norm1, attn (GQA or MLA), norm2 and the FFN of one block: ``mlp``
    (gated for SwiGLU, {up, down} for GeLU) or ``moe`` (router, expert
    banks and any shared expert)."""
    init_attn = attn.init_mla if bdef.mixer == "mla" else attn.init_gqa
    p = {"norm1": common.init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                   device),
         "attn": init_attn(gen, cfg, device),
         "norm2": common.init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                   device)}
    if bdef.ffn == "moe":
        p["moe"] = mlp.init_moe(gen, cfg, device)
    else:
        p["mlp"] = mlp.init_dense_mlp(gen, cfg, device, d_ff=bdef.d_ff,
                                      gated=bdef.ffn != "gelu")
    return p


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
    params: dict = {}
    if not cfg.embed_input:     # frame embeddings come in: no token table
        table = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                            dtype=cfg.param_dtype, device=dev) * 0.02
        params["embed"] = {"w": table,
                           "sw": quant.init_step_from_tensor(table, 8.0)}
    for i, bdef in enumerate(cfg.prefix):
        params[f"prefix{i}"] = init_block(gen, cfg, bdef, dev)
    params["pat"] = [{f"p{j}": init_block(gen, cfg, bdef, dev)
                      for j, bdef in enumerate(cfg.pattern)}
                     for _ in range(cfg.n_repeats)]
    params["final_norm"] = common.init_norm(cfg.norm, cfg.d_model,
                                            cfg.param_dtype, dev)
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                           dtype=cfg.param_dtype, device=dev) \
            * cfg.d_model ** -0.5
        # the untied head's activation step is a trained leaf
        params["head"] = {"w": head,
                          "sw": quant.init_step_from_tensor(head, 8.0),
                          "sa": torch.tensor(HEAD_ACT_STEP,
                                             dtype=torch.float32,
                                             device=dev)}
    if cfg.mtp:
        # the multi-token head: a norm of h_t and a projection of
        # [h_t ; embed(tok_{t+1})] into the shared LM head
        params["mtp"] = {
            "norm": common.init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                     dev),
            "proj": common.init_qdense(gen, 2 * cfg.d_model, cfg.d_model,
                                       cfg.param_dtype, dev)}
    return params


def block_apply(p: dict, x: torch.Tensor, bits: dict, cfg, bdef,
                mode: str, cache, positions: torch.Tensor, impl: str = "auto",
                hvp: bool = False, mrope_positions=None):
    """One block: GQA (causal or not, as ``cfg.causal`` says) or MLA,
    then its FFN: the routed experts for ``bdef.ffn == "moe"``, GeLU for
    "gelu", else ``cfg.activation`` (the reference's choice).
    ``mrope_positions``: the (3, B, S) M-RoPE streams of an M-RoPE config.
    Returns (x, new_cache, aux): the MoE's load-balance loss, None for a
    dense FFN."""
    h = common.apply_norm(cfg.norm, x, p["norm1"])
    mixer = attn.mla_apply if bdef.mixer == "mla" else attn.gqa_apply
    y, new_cache = mixer(p["attn"], h, bits, cfg, mode, cache, positions,
                         impl, hvp, mrope_positions)
    x = x + y
    h = common.apply_norm(cfg.norm, x, p["norm2"])
    if bdef.ffn == "moe":
        y, aux = mlp.moe_apply(p["moe"], h, bits, cfg, impl, hvp)
        return x + y, new_cache, aux
    act = "gelu" if bdef.ffn == "gelu" else cfg.activation
    return (x + mlp.dense_mlp_apply(p["mlp"], h, bits, act, impl, hvp),
            new_cache, None)


def _cache_bits_for(cache_bits, group: str, layer: int) -> Optional[int]:
    """One layer's cache bit-width (``repro/models/transformer.py:201-225``):
    ``cache_bits`` is an int (every layer) or {group: per-layer array}
    (``PrecisionPolicy.cache_bits_arrays()``).  Returns 4 or 8, or None for
    a full-dtype layer (16, or a group the dict leaves out)."""
    if cache_bits is None:
        return None
    if isinstance(cache_bits, (int, float)):
        b = int(round(float(cache_bits)))
    else:
        arr = cache_bits.get(group)
        if arr is None:
            return None
        a = np.asarray(arr, np.float32).reshape(-1)
        if layer >= a.shape[0]:
            raise ValueError(
                f"cache_bits[{group!r}] has {a.shape[0]} entries but layer "
                f"{layer} was requested: the array must cover every layer "
                f"of the group (PrecisionPolicy.cache_bits_arrays() does)")
        b = int(round(float(a[layer])))
    if b not in (4, 8, 16):
        raise ValueError(f"cache bits must be 4, 8 or 16(full), got {b}")
    return None if b == 16 else b


def init_caches(cfg, batch: int, max_seq: int, cache_dtype, device,
                cache_bits=None, page_geom: Optional[tuple] = None) -> dict:
    """Preallocated per-layer decode caches: {"prefix{i}": leaf, ...,
    "pat": [{"p0": leaf}, ...]}.  A GQA layer's leaf is full-dtype
    {'k','v'}, or quantized codes and scales at that layer's bits
    (``_cache_bits_for``: an int for every layer, or {group: per-layer
    bits}, 16 or a missing group meaning full dtype); an MLA layer's is its
    full-precision latent {'c_kv','k_rope'} at any bits, as the policy pins
    it.  The list is the reference's ``plan="unrolled"`` layout, so layers
    of different bits need no buckets.  ``page_geom`` = (n_pages,
    page_size) gives page pools in place of the (B, S_max) buffers; MLA's
    latent has no pages (ValueError, as in the reference)."""
    def leaf(bdef, bits):
        if bdef.mixer == "mla":
            if page_geom is not None:
                raise ValueError(
                    "paged KV cache supports GQA attention only; 'mla' "
                    "state has no per-token page structure (serve paged "
                    "configs with cache_layout='contiguous')")
            return attn.init_mla_cache(cfg, batch, max_seq, cache_dtype,
                                       device)
        if page_geom is not None:
            n_pages, page_size = page_geom
            if bits is None:
                return attn.init_gqa_paged_cache(cfg, n_pages, page_size,
                                                 cache_dtype, device)
            return attn.init_gqa_paged_quant_cache(cfg, batch, n_pages,
                                                   page_size, bits, device)
        if bits is None:
            return attn.init_gqa_cache(cfg, batch, max_seq, cache_dtype,
                                       device)
        return attn.init_gqa_quant_cache(cfg, batch, max_seq, bits, device)
    caches = {f"prefix{i}": leaf(bdef, _cache_bits_for(cache_bits,
                                                       f"prefix{i}", 0))
              for i, bdef in enumerate(cfg.prefix)}
    caches["pat"] = [{f"p{j}": leaf(bdef, _cache_bits_for(cache_bits,
                                                          f"pat{j}", r))
                      for j, bdef in enumerate(cfg.pattern)}
                     for r in range(cfg.n_repeats)]
    return caches


def _embed(params: dict, cfg, tokens: Optional[torch.Tensor],
           embeds: Optional[torch.Tensor], impl: str = "auto",
           hvp: bool = False) -> torch.Tensor:
    if embeds is not None:      # frame embeddings (the reference's batch
        return embeds.to(cfg.compute_dtype)      # "embeds"), as they are
    if tokens is None:
        raise ValueError(f"{cfg.name} takes tokens: pass tokens (B, S), or "
                         f"embeds= (B, S, d_model) for an embed_input model")
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
    """LM head, weights and input activations pinned 8-bit.  A plain
    product (the JAX package leaves it to XLA), here ``torch.matmul``.
    Tied: the embedding table, fake-quantized here and in ``_embed`` (two
    fake-quant sites; their gradients add), and the constant activation
    step HEAD_ACT_STEP.  Untied: ``params["head"]`` (d, vocab) with its
    trained activation step ``sa``.  The serve layouts hold int8 codes
    times a scale (``serve.packing.quantize_edge``)."""
    p = params["embed"] if cfg.tie_embeddings else params["head"]
    if "wq" in p:
        w = p["wq"].to(x.dtype) * p["scale"].to(x.dtype)
    else:
        w = quant.fake_quant(p["w"], p["sw"], PIN_EDGE_BITS, impl, hvp)
    if cfg.tie_embeddings:
        w, sa = w.t(), HEAD_ACT_STEP
    else:
        sa = p["sa"]
    xq = quant.fake_quant(x, sa, PIN_EDGE_BITS, impl, hvp)
    return kref.matmul(xq, w.to(x.dtype))


def _row(bits, r: int):
    row = np.asarray(bits)[r]
    return float(row) if row.ndim == 0 else tuple(float(b) for b in row)


def layer_bits(policy_arrays: dict, cfg, r: int) -> List[Dict[str, Any]]:
    """Per-slot bits dicts of pattern layer ``r`` (host-side floats; a
    per-expert slot gives a tuple, a bit-width an expert)."""
    return [{k: _row(v, r) for k, v in policy_arrays[f"pat{j}"].items()}
            for j in range(len(cfg.pattern))]


def prefix_bits(policy_arrays: dict, i: int) -> Dict[str, Any]:
    """The bits dict of prefix block ``i`` (group ``prefix{i}``, layer 0)."""
    return {k: _row(v, 0) for k, v in policy_arrays[f"prefix{i}"].items()}


def apply(params: dict, policy_arrays: dict, tokens: Optional[torch.Tensor],
          cfg, mode: str = "train", caches: Optional[dict] = None,
          positions: Optional[torch.Tensor] = None, impl: str = "auto",
          logits_at: Optional[torch.Tensor] = None, hvp: bool = False,
          embeds: Optional[torch.Tensor] = None,
          mrope_positions: Optional[torch.Tensor] = None):
    """Returns (logits, new_caches).

    tokens (B, S) int, or None with ``embeds`` (B, S, d_model): frame
    embeddings that take the token table's place (the reference's
    ``batch["embeds"]``; hubert-xlarge's ``embed_input``), cast to the
    compute dtype; positions (B, S) absolute positions (default
    arange), which address the cache; ``mrope_positions`` (3, B, S) int,
    the (temporal, height, width) streams that rotate q and k under
    M-RoPE (the reference's ``batch["mrope_positions"]``): an M-RoPE
    config requires them (``ValueError`` without), any other refuses
    them; ``logits_at`` (B,) picks one position per row before the LM
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
    logits, new_caches, _, _ = _forward(params, policy_arrays, tokens, cfg,
                                        mode, caches, positions, impl,
                                        logits_at, hvp, embeds,
                                        mrope_positions)
    return logits, new_caches


def _check_streams(cfg, mrope_positions, b: int, s: int) -> None:
    """M-RoPE's (3, B, S) integer streams are required under
    ``rope="mrope"`` and refused otherwise (shapes only: no host read)."""
    if cfg.rope != "mrope":
        if mrope_positions is not None:
            raise ValueError(f"{cfg.name} has rope={cfg.rope!r}: it takes "
                             f"no mrope_positions")
        return
    if mrope_positions is None:
        raise ValueError(f"{cfg.name} rotates by M-RoPE: pass "
                         f"mrope_positions= (3, B, S) position streams "
                         f"(text: the 1-D positions three times)")
    if (tuple(mrope_positions.shape) != (3, b, s)
            or mrope_positions.is_floating_point()):
        raise ValueError(f"mrope_positions must be (3, {b}, {s}) integers, "
                         f"got {tuple(mrope_positions.shape)} "
                         f"{mrope_positions.dtype}")


def _forward(params, policy_arrays, tokens, cfg, mode, caches, positions,
             impl, logits_at, hvp, embeds, mrope_positions=None):
    """``apply``'s forward; returns (logits, new_caches, aux, hidden): the
    MoE blocks' load-balance losses summed over the layers (0-d float32),
    or None where no block has experts, and the final norm's output (B, S,
    d), which the multi-token head reads."""
    _check_supported(cfg)
    x = _embed(params, cfg, tokens, embeds, impl, hvp)
    b, s, _ = x.shape
    _check_streams(cfg, mrope_positions, b, s)
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    remat = not hvp and mode == "train" and torch.is_grad_enabled()
    if mode == "train":
        params = common.prequantize_params(params, policy_arrays,
                                           slot_index(cfg), impl, hvp)
    new_caches, aux_total = {}, None

    def run(p, bits, bdef, cache):
        nonlocal x, aux_total
        args = (p, x, bits, cfg, bdef, mode, cache, positions, impl, hvp,
                mrope_positions)
        x, new_cache, aux = (checkpoint(block_apply, *args,
                                        use_reentrant=False) if remat
                             else block_apply(*args))
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        return new_cache

    for i, bdef in enumerate(cfg.prefix):      # unrolled, before the pattern
        key = f"prefix{i}"
        new_caches[key] = run(params[key], prefix_bits(policy_arrays, i),
                              bdef, None if caches is None else caches[key])
    new_caches["pat"] = []
    for r in range(cfg.n_repeats):
        bits = layer_bits(policy_arrays, cfg, r)
        new_caches["pat"].append({
            f"p{j}": run(params["pat"][r][f"p{j}"], bits[j], bdef,
                         None if caches is None
                         else caches["pat"][r][f"p{j}"])
            for j, bdef in enumerate(cfg.pattern)})
    hidden = common.apply_norm(cfg.norm, x, params["final_norm"])
    x = hidden
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at][:, None]
    return _head(params, cfg, x, impl, hvp), new_caches, aux_total, hidden


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
    """Next-token LM loss of ``batch`` ({'tokens' or 'embeds', 'labels'[,
    'loss_mask', 'mrope_positions']}, (B, S) tensors, embeds (B, S, d),
    M-RoPE's streams (3, B, S)): (loss, metrics) with
    metrics {'loss', 'accuracy', 'aux_loss'} (0-d tensors, no host sync).
    The loss is the cross entropy plus the MoE blocks' load-balance losses
    summed over the layers (0 for a dense model), as in
    ``repro/models/transformer.py:582-611``.  A model with a multi-token
    head (``cfg.mtp``) on tokens longer than 2 also predicts token t + 2
    from [norm(h_t) ; embed(tok_{t+1})] through ``params["mtp"]["proj"]``
    (at MTP_BITS) and the shared LM head, adds ``mtp_weight`` times that
    cross entropy and reports it as ``metrics["mtp_loss"]``.  ``hvp`` as
    in ``apply``."""
    tokens = batch.get("tokens")
    logits, _, aux, hidden = _forward(params, policy_arrays, tokens, cfg,
                                      "train", None, None, impl, None, hvp,
                                      batch.get("embeds"),
                                      batch.get("mrope_positions"))
    labels, mask = batch["labels"], batch.get("loss_mask")
    loss, acc = cross_entropy(logits, labels, mask)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    total = loss + aux
    metrics = {"loss": loss.detach(), "accuracy": acc, "aux_loss": aux}
    if cfg.mtp and tokens is not None and labels.shape[1] > 2:
        e = _embed(params, cfg, tokens, None, impl, hvp)
        hh = common.apply_norm(cfg.norm, hidden[:, :-1],
                               params["mtp"]["norm"])
        hm = common.qproj(torch.cat([hh, e[:, 1:]], dim=-1),
                          params["mtp"]["proj"], MTP_BITS, impl, hvp)
        mtp_loss, _ = cross_entropy(_head(params, cfg, hm, impl, hvp),
                                    labels[:, 1:],
                                    None if mask is None else mask[:, 1:])
        total = total + cfg.mtp_weight * mtp_loss
        metrics["mtp_loss"] = mtp_loss.detach()
    return total, metrics


# ============================================================ policy builder
def _unit(group, layer, slot, tensors, n_params, macs, in_features,
          sub=None, pinned=None) -> QuantUnit:
    name = f"{group}.{slot}" + (f".e{sub}" if sub is not None else "") \
        + f".L{layer}"
    if pinned is None and in_features < PIN_MIN_IN_FEATURES:
        pinned = PIN_NARROW_BITS
    return QuantUnit(name=name, group=group, layer=layer, slot=slot,
                     tensors=tuple(tensors), n_params=int(n_params),
                     macs_per_token=float(macs), in_features=int(in_features),
                     sub=sub, pinned_bits=pinned)


def _attn_units(cfg, bdef, group: str, layer: int, base: tuple) -> list:
    """GQA's q/k/v and o; or MLA's wq_a with wkv_a (linked: one input),
    wq_b, wk_b with wv_b, and wo."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if bdef.mixer != "mla":
        nqkv = d * (h * dh + 2 * hkv * dh)
        return [_unit(group, layer, "attn_qkv",
                      [base + ("attn", w, "w") for w in ("wq", "wk", "wv")],
                      nqkv, nqkv, d),
                _unit(group, layer, "attn_wo", [base + ("attn", "wo", "w")],
                      h * dh * d, h * dh * d, h * dh)]
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    n_a = d * ql + d * (kvl + dr)
    n_qb = ql * h * (dn + dr)
    n_kvb = kvl * h * (dn + dv)
    return [_unit(group, layer, "attn_q_a",
                  [base + ("attn", "wq_a", "w"),
                   base + ("attn", "wkv_a", "w")],
                  n_a, n_a, d),
            _unit(group, layer, "attn_q_b", [base + ("attn", "wq_b", "w")],
                  n_qb, n_qb, ql),
            _unit(group, layer, "attn_kv_b",
                  [base + ("attn", "wk_b", "w"),
                   base + ("attn", "wv_b", "w")],
                  n_kvb, n_kvb, kvl),
            _unit(group, layer, "attn_wo", [base + ("attn", "wo", "w")],
                  h * dv * d, h * dv * d, h * dv)]


def _block_units(cfg, bdef, group: str, layer: int, base: tuple):
    """Quant units of one block: the attention's (``_attn_units``); then
    the FFN's gate/up and down, or the MoE's pinned 8-bit router, each
    expert's gate/up and down (``sub`` = the expert, MACs a token k / E of
    the expert's) and the shared expert's gate/up and down."""
    d = cfg.d_model
    ff = bdef.d_ff or cfg.d_ff
    units = _attn_units(cfg, bdef, group, layer, base)
    if bdef.ffn == "moe":
        e, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff
        units.append(_unit(group, layer, "moe_router",
                           [base + ("moe", "router", "w")], d * e, d * e, d,
                           pinned=PIN_EDGE_BITS))
        for ei in range(e):
            n_gu = 2 * d * f
            units.append(_unit(group, layer, "moe_gateup",
                               [base + ("moe", "gate", "w"),
                                base + ("moe", "up", "w")], n_gu,
                               n_gu * k / e, d, sub=ei))
            units.append(_unit(group, layer, "moe_down",
                               [base + ("moe", "down", "w")], f * d,
                               f * d * k / e, f, sub=ei))
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            units.append(_unit(group, layer, "mlp_gateup",
                               [base + ("moe", "shared", "gate", "w"),
                                base + ("moe", "shared", "up", "w")],
                               2 * d * fs, 2 * d * fs, d))
            units.append(_unit(group, layer, "mlp_down",
                               [base + ("moe", "shared", "down", "w")],
                               fs * d, fs * d, fs))
        return units
    ups = ("up",) if bdef.ffn == "gelu" else ("gate", "up")
    n_up = len(ups) * d * ff
    return units + [
        _unit(group, layer, "mlp_gateup",
              [base + ("mlp", w, "w") for w in ups], n_up, n_up, d),
        _unit(group, layer, "mlp_down", [base + ("mlp", "down", "w")],
              ff * d, ff * d, ff),
    ]


def _block_cache_unit(cfg, bdef, group: str, layer: int):
    """A block's KV-cache unit: selectable for causal GQA; MLA's latent
    (kv_lora_rank + qk_rope_dim elements a token) pinned at
    CACHE_FULL_BITS; None for a bidirectional block, which keeps no
    cache."""
    name = f"{group}.cache.L{layer}"
    if bdef.mixer == "gqa":
        return CacheUnit(name=name, group=group, layer=layer,
                         kv_elems_per_token=2 * cfg.n_kv_heads * cfg.head_dim)
    if bdef.mixer == "mla":
        return CacheUnit(name=name, group=group, layer=layer,
                         kv_elems_per_token=cfg.kv_lora_rank
                         + cfg.qk_rope_dim, pinned_bits=CACHE_FULL_BITS)
    return None


def build_policy(cfg, b_hi: float = 4.0, b_lo: float = 2.0
                 ) -> PrecisionPolicy:
    """Every quant unit of the model (the pinned 8-bit embedding first,
    where the model has a token table, then the prefix blocks' groups
    ``prefix{i}`` and the pattern's, and, untied, the pinned 8-bit head
    last) and each block's KV-cache unit (``_block_cache_unit``), named as
    in the reference."""
    _check_supported(cfg)
    units = []
    if not cfg.embed_input:
        units.append(_unit("embed", 0, "embed", [("embed", "w")],
                           cfg.vocab * cfg.d_model, 0.0, cfg.vocab,
                           pinned=PIN_EDGE_BITS))
    blocks = [(bdef, f"prefix{i}", 0, (f"prefix{i}",))
              for i, bdef in enumerate(cfg.prefix)]
    blocks += [(bdef, f"pat{j}", r, ("pat", f"p{j}"))
               for r in range(cfg.n_repeats)
               for j, bdef in enumerate(cfg.pattern)]
    cache_units = []
    for bdef, group, layer, base in blocks:
        units.extend(_block_units(cfg, bdef, group, layer, base))
        cu = _block_cache_unit(cfg, bdef, group, layer)
        if cu is not None:
            cache_units.append(cu)
    if not cfg.tie_embeddings:
        n_head = cfg.d_model * cfg.vocab
        units.append(_unit("head", 0, "head", [("head", "w")], n_head,
                           n_head, cfg.d_model, pinned=PIN_EDGE_BITS))
    return PrecisionPolicy(units, b_hi=b_hi, b_lo=b_lo,
                           cache_units=cache_units)


def fetch_unit_tensor(params: dict, unit: QuantUnit, path: tuple):
    """Weight tensor and LSQ step of one member tensor of a unit (the
    reference's, for the port's layout: pattern layer ``r`` is
    ``params["pat"][r]``, not index ``r`` of a stacked leaf; a prefix
    block's path starts at ``params["prefix{i}"]``); a per-expert unit's
    expert ``unit.sub`` of its bank, with that expert's step."""
    node = params
    for key in path[:-1]:
        node = node[key]
        if key == "pat":
            node = node[unit.layer]
    if "sw" not in node:
        raise KeyError(f"no step size for {path}")
    w, step = node[path[-1]], node["sw"]
    if unit.sub is not None:
        w = w[unit.sub]
        step = step[unit.sub] if step.ndim >= 1 else step
    return w, step


def slot_index(cfg) -> Dict[tuple, tuple]:
    """Param path of a projection (inside a layer) -> (group, slot)."""
    index = {}
    for u in build_policy(cfg).units:
        for t in u.tensors:
            index[t[:-1] if t[-1] == "w" else t] = (u.group, u.slot)
    return index
