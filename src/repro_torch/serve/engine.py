"""Serving engine: low-bit weights, prefill + greedy decode over a
contiguous or paged, full or quantized KV cache — port of
``repro/serve/engine.py``.

Two weight layouts, as in the reference:

  * packed (``serve.packing.pack_params``, the port's default): K-major
    uint8 codes.  On the card every projection streams them through the
    CUDA ``quant_matmul`` (prefill and every decode step; nothing is
    dequantized per dispatch).  On the CPU the engine runs the reference's
    CPU path: prefill through ``ref.dequant_matmul`` and decode over a
    per-dispatch dequantized view (``packing.decode_weight_view``), the op
    order that keeps it greedy-parity with the JAX engine.
  * fake_quant (``quantize_for_serving``): int8 codes and a scalar scale a
    projection, dequantized at use (``models/common.weight_of``) and
    multiplied by a plain matmul, as in the reference, whose Pallas kernels
    never take this layout.  Codes equal the packed layout's, so both
    layouts serve the same tokens on the CPU.

Each projection's input goes through the CUDA ``lsq_fakequant`` (one launch
for q/k/v and one for gate/up, which share their input), prefill attention
through ``flash_attention`` and quantized-cache decode attention through
``kv_decode_attention`` (``paged_kv_decode_attention`` over a paged
cache), each layer at its own cache bits; a full-dtype layer decodes by
plain attention.

An MLA model (deepseek-v3) keeps its full-precision latent cache
(c_kv and k_rope a token a layer) in the contiguous layout at any
``cache_bits`` (the policy pins it at 16 bits; a paged layout is refused):
prefill runs ``flash_attention`` at head_dim 192 on the card, and decode
is the absorbed form in plain products, no decode attention kernel.

An M-RoPE model (qwen2-vl-7b) serves text: every call of the model gets
the three (temporal, height, width) position streams equal to the 1-D
positions it runs at, as the reference's ``_positions_batch`` builds them,
in prefill, suffix prefill and decode (idle slots at ``max_seq``).

The reference's decode is one ``lax.scan`` per chunk of ``decode_chunk``
steps; eager PyTorch needs no scan, so a chunk is a Python loop of
``decode_step`` calls that never syncs with the host.  The
continuous-batching scheduler (``serve/scheduler.py``) drives the engine
one request at a time at admission (``prefill``, or ``prefill_suffix``
for a prefix hit) and all slots together in decode, idle slots masked by
``active``.  The reference's
bucket-boundary checks exist to bound XLA compile time and have no
counterpart.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import quant
from repro_torch.kernels import kv_quant as kvq
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_cache, packing, paging, residency, sampling
from repro_torch.serve.config import EngineSpec
from repro_torch.serve.paging import PagedServeCache


def _quantize_qdense(p: dict, bits) -> dict:
    """{'w','sw','sa'} -> {'wq','scale','sa'}: codes clamped to ``bits``'
    signed range, stored as int8 whatever the bits (PyTorch has no usable
    int4 dtype; the reference's int4 container also counts a byte a code),
    and the step as the scale.  An expert bank (E, K, N) takes a step and
    a bit-width an expert (``bits`` a row), each over its expert's codes
    (``repro/serve/engine.py:121-133``)."""
    step = torch.clamp(torch.abs(p["sw"]).float(), min=1e-9)
    if p["w"].ndim == 3:
        codes = torch.stack([quant.quantize_int(
            p["w"][e].float(), step[e], float(b)).to(torch.int8)
            for e, b in enumerate(bits)])
    else:
        codes = quant.quantize_int(p["w"].float(), step, float(bits))
    return {"wq": codes.to(torch.int8), "scale": step, "sa": p["sa"]}


def quantize_for_serving(params: dict, policy_arrays: dict, cfg,
                         device="cuda") -> dict:
    """Raw QAT params -> the fake-quant serve layout on ``device``
    (``repro/serve/engine.py:121-185``): each projection at its unit's
    per-layer bits from ``policy_arrays`` (a node with no unit at 4), the
    pinned 8-bit embedding (and an untied head) through
    ``packing.quantize_edge``, as the packed layout's."""
    return packing.serving_layout(params, policy_arrays, cfg,
                                  _quantize_qdense, device)


class ServeEngine:
    """Batched greedy decoding with a prefilled, length-tracked KV cache.

    ``params``: ``pack_params`` output on ``device`` (``spec.weights=
    "packed"``), or ``quantize_for_serving`` output (``"fake_quant"``).
    ``impl="ref"`` runs every kernel's plain PyTorch version instead (on
    the card it is the end-to-end yardstick of ``chip_smoke.py``).
    """

    def __init__(self, cfg, params: dict, policy_arrays: dict, max_seq: int,
                 spec: Optional[EngineSpec] = None, device="cuda",
                 impl: str = "auto"):
        self.spec = spec if spec is not None else EngineSpec()
        if not isinstance(self.spec, EngineSpec):
            raise ValueError(f"spec must be an EngineSpec, got "
                             f"{type(self.spec).__name__}")
        self.spec.validate(cfg, params)
        if impl not in kops.IMPLS:
            raise ValueError(f"impl must be one of {kops.IMPLS}, got {impl!r}")
        self.device = resolve_device(device)
        table = params["embed"].get("wq", params["embed"].get("w"))
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}: pack_params(..., device=...) "
                             f"or quantize_for_serving(..., device=...) "
                             f"them there")
        self.cfg = cfg
        self.params = params
        self.policy_arrays = policy_arrays
        self.max_seq = int(max_seq)
        self.impl = impl
        self.weights = self.spec.weights
        self.cache = self.spec.cache
        self.cache_bits = self.spec.cache_bits
        self.cache_layout = self.spec.cache_layout
        self.page_size = self.spec.page_size
        self.n_pages = self.spec.n_pages
        self.max_pages = kvq.page_count(self.max_seq, self.page_size)
        self.decode_chunk = self.spec.decode_chunk
        self.sampler = self.spec.sampler
        self.cache_dtype = (self.spec.cache_dtype
                            if self.spec.cache_dtype is not None
                            else cfg.compute_dtype)
        # the model emits cache entries in the engine's cache dtype, so the
        # prefill->decode handoff never narrows below the compute dtype
        self._cfg = cfg.replace(cache_dtype=self.cache_dtype)

    # ------------------------------------------------------------- prefill
    def _streams(self, positions: torch.Tensor) -> dict:
        """The model's position streams at ``positions`` (B, S): for an
        M-RoPE config the text streams, the 1-D positions three times
        (Qwen2-VL's convention for text); nothing for another rope."""
        if self._cfg.rope != "mrope":
            return {}
        return {"mrope_positions": positions[None].expand(
            3, *positions.shape)}

    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Prompt batch (B, S), left-aligned and right-padded -> (each
        request's last valid logits (B, V), prefill K/V layers)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32)
        lengths = torch.as_tensor(lengths, device=self.device)
        positions = torch.arange(s, device=self.device).expand(b, s)
        logits, pre = tf.apply(self.params, self.policy_arrays, tokens,
                               self._cfg, mode="prefill",
                               positions=positions, impl=self.impl,
                               logits_at=lengths.long() - 1,
                               **self._streams(positions))
        return logits[:, 0], pre

    def prefill_suffix(self, tokens: torch.Tensor, length: int,
                       prefix_len: int, cache: PagedServeCache, slot: int
                       ) -> Tuple[torch.Tensor, Any]:
        """Prefill only a request's unshared suffix against slot ``slot``'s
        already-mapped prefix pages (a prefix-hit admission over a paged
        full-dtype cache; a quantized hit never prefills).  ``tokens``:
        (1, S_pad) suffix tokens at positions [prefix_len, prefix_len +
        S_pad); ``length``: valid suffix tokens; ``prefix_len``: shared rows
        (page-aligned).  Returns (the last valid logits (1, V), the suffix
        K/V rows)."""
        if not isinstance(cache, PagedServeCache) or self.cache != "full":
            raise ValueError("prefill_suffix runs over a paged full-dtype "
                             "cache")
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        positions = prefix_len + torch.arange(
            s, device=self.device).expand(b, s)
        layers = paging.with_tables(cache.layers,
                                    cache.block_tbl[slot:slot + 1],
                                    prefix_len=int(prefix_len))
        logits, suf = tf.apply(
            self.params, self.policy_arrays, tokens, self._cfg,
            mode="prefill", caches=layers, positions=positions,
            impl=self.impl,
            logits_at=torch.full((b,), int(length) - 1, device=self.device),
            **self._streams(positions))
        return logits[:, 0], suf

    def new_cache(self, batch: int):
        """Preallocated cache in this engine's layout: (B, S_max) buffers,
        or page pools of ``n_pages`` (default B * max_pages, the contiguous
        capacity) behind a block table."""
        bits = self.cache_bits if self.cache == "quantized" else None
        if self.cache_layout == "paged":
            n_pages = (self.n_pages if self.n_pages is not None
                       else batch * self.max_pages)
            if int(n_pages) < batch:
                raise ValueError(
                    f"n_pages={int(n_pages)} cannot back a {batch}-slot "
                    f"batch: every slot needs >= 1 page (worst case "
                    f"{self.max_pages}/slot at max_seq={self.max_seq}, "
                    f"page_size={self.page_size})")
            return paging.init_paged_cache(
                self._cfg, batch, self.max_seq, int(n_pages), self.page_size,
                self.cache_dtype, self.device, bits)
        return kv_cache.init_cache(self._cfg, batch, self.max_seq,
                                   self.cache_dtype, self.device, bits)

    def splice_prefill(self, prefill_layers, lengths: torch.Tensor):
        """A fresh batch cache holding the prefill K/V at position 0 (paged:
        slot i on pages [i * max_pages, (i + 1) * max_pages))."""
        cache = self.new_cache(lengths.shape[0])
        if isinstance(cache, PagedServeCache):
            return paging.splice_prefill(cache, prefill_layers, lengths)
        return kv_cache.splice_prefill(cache, prefill_layers, lengths)

    # -------------------------------------------------------------- decode
    def decode_params(self) -> dict:
        """The weights one decode dispatch runs on: the packed tree on the
        card, a dequantized view of it on the CPU (once per dispatch); the
        fake-quant tree as it is on either."""
        if self.weights == "packed" and self.device.type == "cpu":
            return packing.decode_weight_view(self.params)
        return self.params

    def decode_step(self, cache, tok: torch.Tensor,
                    active: Optional[torch.Tensor] = None,
                    params: Optional[dict] = None
                    ) -> Tuple[Any, torch.Tensor]:
        """Feed ``tok`` (B, 1) at each slot's valid length; returns the
        advanced cache and the logits (B, V).  Inactive slots write nothing
        (their position is pinned at max_seq) and do not advance."""
        b = cache.lengths.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=self.device)
        if params is None:
            params = self.decode_params()
        pos = torch.where(active, cache.lengths, self.max_seq)[:, None]
        paged = isinstance(cache, PagedServeCache)
        layers = (paging.with_tables(cache.layers, cache.block_tbl) if paged
                  else cache.layers)
        logits, _ = tf.apply(params, self.policy_arrays,
                             tok.to(self.device).long(), self._cfg,
                             mode="decode", caches=layers,
                             positions=pos, impl=self.impl,
                             **self._streams(pos))
        step = paging.advance if paged else kv_cache.advance
        return step(cache, 1, active), logits[:, -1]

    def decode_chunk_step(self, cache, tok: torch.Tensor, *,
                          active: Optional[torch.Tensor] = None,
                          n_steps: Optional[int] = None
                          ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """Advance every slot by ``n_steps`` (default ``decode_chunk``)
        greedy steps.  Returns (cache, next feed token (B, 1), emitted
        tokens (B, n_steps)).  The reference's sampling-key arguments come
        with sampled decoding (ROADMAP Queue 1 item 11); ``EngineSpec``
        refuses every sampler but greedy."""
        n_steps = self.decode_chunk if n_steps is None else int(n_steps)
        params = self.decode_params()
        toks = []
        for _ in range(n_steps):
            cache, logits = self.decode_step(cache, tok, active, params)
            nxt = sampling.sample(logits, self.sampler)
            toks.append(nxt)
            tok = nxt[:, None]
        return cache, tok, torch.stack(toks, dim=1)

    # ------------------------------------------------------------ generate
    def generate(self, tokens, n_new: int, lengths=None) -> torch.Tensor:
        """Prompts (B, S_prompt), left-aligned and right-padded ->
        (B, n_new) int32 greedy continuation."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s_prompt = tokens.shape
        if n_new <= 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        if s_prompt + n_new > self.max_seq:
            raise ValueError(f"prompt {s_prompt} + n_new {n_new} exceeds "
                             f"max_seq {self.max_seq}")
        host_lengths = (np.full((b,), s_prompt) if lengths is None
                        else np.asarray(torch.as_tensor(lengths).cpu()))
        if np.any(host_lengths < 1) or np.any(host_lengths > s_prompt):
            raise ValueError("per-request lengths must be in [1, S_prompt]")
        lengths = torch.as_tensor(host_lengths, dtype=torch.int32,
                                  device=self.device)
        last, pre = self.prefill(tokens, lengths)
        cache = self.splice_prefill(pre, lengths)
        tok = sampling.sample(last, self.sampler)[:, None]
        out = [tok]
        remaining = n_new - 1
        while remaining > 0:
            n_steps = min(self.decode_chunk, remaining)
            cache, tok, toks = self.decode_chunk_step(cache, tok,
                                                      n_steps=n_steps)
            out.append(toks)
            remaining -= n_steps
        return torch.cat(out, dim=1)

    # ------------------------------------------------------------ residency
    def residency(self, cache=None) -> dict:
        """Resident and roofline bytes of the weights and, given one, a
        cache (``serve/residency.py``, the one definition)."""
        return residency.report(self.params, cache)
