"""EngineSpec: every serving knob of ``ServeEngine`` in one validated spec
(port of ``repro/serve/config.py``).

The port serves packed (``pack_params``) or fake-quant
(``quantize_for_serving``) weights over a contiguous or paged, full or
quantized KV cache, its bits one int or chosen per layer, with greedy
sampling.  MLA's latent cache is contiguous and full precision at any
``cache_bits`` (the policy pins it); a paged layout refuses it.  Every
other value the reference accepts is refused here with
``NotImplementedError`` naming the ROADMAP item that ports it, so a
request the port cannot honour never runs as something else.  The default layout
is ``"packed"`` (the reference's is ``"fake_quant"``): every caller of the
port serves packed params, and params of the other layout are refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.serve import packing, sampling


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    weights: str = "packed"         # "packed" | "fake_quant"
    cache: str = "full"             # "full" | "quantized"
    cache_bits: Any = 8             # 8 or 4, or {group: per-layer 4/8/16}
    cache_layout: str = "contiguous"  # "contiguous" | "paged"
    page_size: int = 16             # tokens per physical page (paged)
    n_pages: Optional[int] = None   # pool size; None -> B * max_pages
    decode_chunk: int = 16          # decode steps per decode_chunk_step
    prefill_chunk: Optional[int] = None
    sampler: sampling.SamplerConfig = sampling.GREEDY
    cache_dtype: Any = None         # None -> cfg.compute_dtype
    mesh: Any = None
    draft: Any = None

    def validate(self, cfg=None, params=None) -> None:
        """Every cross-field rule; ``cfg`` and ``params`` add the checks
        that need the model and the weights (the engine passes both)."""
        if self.weights not in ("fake_quant", "packed"):
            raise ValueError(f"weights must be 'fake_quant' or 'packed', "
                             f"got {self.weights!r}")
        if self.cache not in ("full", "quantized"):
            raise ValueError(f"cache must be 'full' or 'quantized', "
                             f"got {self.cache!r}")
        if cfg is not None and not cfg.causal:
            raise ValueError(f"{cfg.name} is not causal: an encoder has no "
                             f"autoregressive decode to serve (DESIGN.md "
                             f"§4); its forward is transformer.apply(packed, "
                             f"policy_arrays, tokens, cfg, mode='prefill'), "
                             f"with embeds= in place of tokens for frame "
                             f"embeddings")
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
            if cfg is not None:
                blocks = tuple(cfg.prefix) + tuple(cfg.pattern)
                bad = sorted({b.mixer for b in blocks if b.mixer != "gqa"})
                if bad:
                    raise ValueError(
                        f"cache_layout='paged' serves causal GQA caches "
                        f"only (got mixers {bad}): MLA's latent has no "
                        f"per-token page structure — serve such configs "
                        f"with cache_layout='contiguous'")
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
        if params is not None:
            is_packed = packing.params_are_packed(params)
            if is_packed != (self.weights == "packed"):
                have = "packed" if is_packed else "fake_quant"
                raise ValueError(
                    f"EngineSpec(weights={self.weights!r}) but params are "
                    f"in the {have!r} layout — build packed params with "
                    f"serve.packing.pack_params(checkpoint, policy_arrays, "
                    f"cfg)")
