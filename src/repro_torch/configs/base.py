"""ArchConfig: declarative architecture description (port of
``repro/configs/base.py`` and ``BlockDef`` from ``repro/models/common.py``).

The port covers the olmo family (GQA mixer, SwiGLU FFN); the fields for the
rest of the zoo (MoE, MLA, SSMs) arrive with ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer of the repeating pattern."""
    mixer: str      # 'gqa' (the port's only mixer so far)
    ffn: str        # 'swiglu'
    d_ff: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[BlockDef, ...]
    n_repeats: int
    prefix: Tuple[BlockDef, ...] = ()

    norm: str = "rms"                    # 'rms' | 'ln' | 'nonparam_ln'
    activation: str = "silu"
    rope: str = "rope"                   # 'rope' | 'none'
    rope_base: float = 10_000.0
    causal: bool = True
    tie_embeddings: bool = False

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    cache_dtype: torch.dtype = torch.bfloat16

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the JAX ``smoke()``)."""
        return self.replace(
            d_model=128, n_heads=4, head_dim=32,
            n_kv_heads=max(1, (4 * self.n_kv_heads) // max(self.n_heads, 1)),
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_repeats=min(self.n_repeats, 2),
            prefix=tuple(BlockDef(b.mixer, b.ffn) for b in self.prefix[:1]),
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
