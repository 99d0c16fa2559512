"""Serving engine: packed low-bit weights, prefill + greedy decode over a
contiguous or paged, full or quantized KV cache — port of
``repro/serve/engine.py``.

On the card every projection streams its packed codes through the CUDA
``quant_matmul`` (prefill and every decode step; nothing is dequantized per
dispatch), each projection's input goes through the CUDA ``lsq_fakequant``
(one launch for q/k/v and one for gate/up, which share their input),
prefill attention through ``flash_attention`` and quantized-cache decode
attention through ``kv_decode_attention`` (``paged_kv_decode_attention``
over a paged cache).  On the CPU the engine runs the
reference's CPU path: prefill through ``ref.dequant_matmul`` and decode
over a per-dispatch dequantized view (``packing.decode_weight_view``), the
op order that keeps it greedy-parity with the JAX engine.

The reference's decode is one ``lax.scan`` per chunk of ``decode_chunk``
steps; eager PyTorch needs no scan, so a chunk is a Python loop of
``decode_step`` calls that never syncs with the host.  The reference's
bucket-boundary checks exist to bound XLA compile time and have no
counterpart.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.quant import PackedLinear
from repro_torch.kernels import kv_quant as kvq
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_cache, packing, paging, sampling
from repro_torch.serve.config import EngineSpec
from repro_torch.serve.paging import PagedServeCache


def _has_packed(node) -> bool:
    if isinstance(node, PackedLinear):
        return True
    if isinstance(node, dict):
        return any(_has_packed(v) for v in node.values())
    if isinstance(node, list):
        return any(_has_packed(v) for v in node)
    return False


class ServeEngine:
    """Batched greedy decoding with a prefilled, length-tracked KV cache.

    ``params``: ``pack_params`` output on ``device``.  ``impl="ref"`` runs
    every kernel's plain PyTorch version instead (on the card it is the
    end-to-end yardstick of ``chip_smoke.py``).
    """

    def __init__(self, cfg, params: dict, policy_arrays: dict, max_seq: int,
                 spec: Optional[EngineSpec] = None, device="cuda",
                 impl: str = "auto"):
        self.spec = spec if spec is not None else EngineSpec()
        if not isinstance(self.spec, EngineSpec):
            raise ValueError(f"spec must be an EngineSpec, got "
                             f"{type(self.spec).__name__}")
        self.spec.validate(cfg)
        if impl not in kops.IMPLS:
            raise ValueError(f"impl must be one of {kops.IMPLS}, got {impl!r}")
        self.device = resolve_device(device)
        if not _has_packed(params):
            raise ValueError("params are not in the packed layout: build them "
                             "with serve.packing.pack_params")
        if params["embed"]["wq"].device != self.device:
            raise ValueError(f"params live on {params['embed']['wq'].device}, "
                             f"the engine on {self.device}: pack_params(..., "
                             f"device=...) them there")
        self.cfg = cfg
        self.params = params
        self.policy_arrays = policy_arrays
        self.max_seq = int(max_seq)
        self.impl = impl
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
        logits, pre = tf.apply(self.params, self.policy_arrays, tokens,
                               self._cfg, mode="prefill", impl=self.impl,
                               logits_at=lengths.long() - 1)
        return logits[:, 0], pre

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
        card, a dequantized view on the CPU (once per dispatch)."""
        if self.device.type == "cpu":
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
                             positions=pos, impl=self.impl)
        step = paging.advance if paged else kv_cache.advance
        return step(cache, 1, active), logits[:, -1]

    def decode_chunk_step(self, cache, tok: torch.Tensor, *,
                          active: Optional[torch.Tensor] = None,
                          n_steps: Optional[int] = None
                          ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """Advance every slot by ``n_steps`` (default ``decode_chunk``)
        greedy steps.  Returns (cache, next feed token (B, 1), emitted
        tokens (B, n_steps))."""
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
    def weight_bytes(self) -> dict:
        """Resident packed weight bytes beside the bf16 bytes of the same
        weights."""
        return {"packed": packing.resident_weight_bytes(self.params),
                "bf16": packing.bf16_weight_bytes(self.params)}
