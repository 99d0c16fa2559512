"""EngineSpec: every serving knob of ``ServeEngine`` in one validated spec
(port of ``repro/serve/config.py``).

The port serves packed weights over a contiguous or paged, full or
quantized KV cache with greedy sampling.  Every other value the reference
accepts is refused here with ``NotImplementedError`` naming the ROADMAP
item that ports it, so a request the port cannot honour never runs as
something else.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.serve import sampling


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    weights: str = "packed"         # the port serves the packed layout
    cache: str = "full"             # "full" | "quantized"
    cache_bits: int = 8             # 8 or 4 (quantized cache)
    cache_layout: str = "contiguous"  # "contiguous" | "paged"
    page_size: int = 16             # tokens per physical page (paged)
    n_pages: Optional[int] = None   # pool size; None -> B * max_pages
    decode_chunk: int = 16          # decode steps per decode_chunk_step
    prefill_chunk: Optional[int] = None
    sampler: sampling.SamplerConfig = sampling.GREEDY
    cache_dtype: Any = None         # None -> cfg.compute_dtype
    mesh: Any = None
    draft: Any = None

    def validate(self, cfg=None) -> None:
        """Every cross-field rule; ``cfg`` adds the checks that need the
        model (the engine passes it)."""
        if self.weights == "fake_quant":
            raise NotImplementedError(
                "weights='fake_quant' stores codes as jnp.int4 in the "
                "reference and is not ported (ROADMAP Queue 1 item 5); serve "
                "pack_params output with weights='packed'")
        if self.weights != "packed":
            raise ValueError(f"weights must be 'packed', got {self.weights!r}")
        if self.cache not in ("full", "quantized"):
            raise ValueError(f"cache must be 'full' or 'quantized', "
                             f"got {self.cache!r}")
        if self.cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout must be 'contiguous' or "
                             f"'paged', got {self.cache_layout!r}")
        if self.cache_layout == "paged":
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, "
                                 f"got {self.page_size}")
            if self.n_pages is not None and int(self.n_pages) < 1:
                raise ValueError(f"n_pages must be >= 1 when given, "
                                 f"got {self.n_pages}")
            if cfg is not None and not cfg.causal:
                raise ValueError("cache_layout='paged' serves causal "
                                 "attention caches only")
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, "
                             f"got {self.decode_chunk}")
        if self.prefill_chunk is not None:
            raise NotImplementedError("prefill_chunk (chunked prefill) is "
                                      "ROADMAP Queue 1 item 10")
        if self.sampler.kind != "greedy":
            raise NotImplementedError(
                "temperature / top-k sampling needs JAX's threefry bit for "
                "bit (ROADMAP Queue 1 item 11); the port samples greedily")
        if self.mesh is not None:
            raise NotImplementedError("mesh= (tensor-parallel serving) is "
                                      "ROADMAP Queue 1 item 14")
        if self.draft is not None:
            raise NotImplementedError("draft= (speculative decoding) is "
                                      "ROADMAP Queue 1 item 10")
