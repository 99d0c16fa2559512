"""ArchConfig: declarative architecture description (port of
``repro/configs/base.py`` and ``BlockDef`` from ``repro/models/common.py``).

The port covers the dense zoo: causal GQA (MHA to MQA) with a SwiGLU or
GeLU FFN, and the encoders' bidirectional GQA, with RMSNorm or LayerNorm,
RoPE, Qwen2-VL's M-RoPE (``rope="mrope"``, ``mrope_sections``) or none,
tied or untied heads, and frame embeddings in place of a token table
(``embed_input``); the routed mixture of experts (``BlockDef(...,
"moe")``: ``n_experts``, ``top_k``, ``capacity_factor``,
``moe_aux_weight``) with its shared expert (``n_shared_experts``); and
DeepSeek-V3's multi-head latent attention (``BlockDef("mla", ...)``:
``q_lora_rank``, ``kv_lora_rank``, ``qk_nope_dim``, ``qk_rope_dim``,
``v_head_dim``), its unrolled dense ``prefix`` blocks and its
multi-token-prediction head (``mtp``, ``mtp_weight``).  The SSMs' fields
arrive with ROADMAP Queue 1 item 13.4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer of the repeating pattern."""
    mixer: str      # 'gqa' | 'bidir' (GQA under cfg.causal=False) | 'mla'
    ffn: str        # 'swiglu' | 'gelu' (non-gated) | 'moe' (routed experts)
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
    activation: str = "silu"             # 'silu' | 'gelu' (tanh form)
    rope: str = "rope"                   # 'rope' | 'mrope' | 'none'
    rope_base: float = 10_000.0
    # M-RoPE: the head-dim halves split into (temporal, height, width)
    # sections, each rotated by its own position stream
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    causal: bool = True
    embed_input: bool = False            # modality stub: takes (B,S,d) embeds
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # multi-token prediction (DeepSeek-V3)
    mtp: bool = False
    mtp_weight: float = 0.3

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    cache_dtype: torch.dtype = torch.bfloat16

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the JAX ``smoke()``):
        an MoE config keeps at least 4 experts (and top_k of them) and
        routes to at most 2; M-RoPE's sections shrink with the head dim in
        proportion, the last taking the rounding ((16, 24, 24) -> (4, 6, 6)
        at head_dim 32); MLA's ranks and head dims become (64, 64, 32, 16,
        32); the prefix keeps its first block, at the smoke d_ff."""
        scale = dict(
            d_model=128, n_heads=4, head_dim=32,
            n_kv_heads=max(1, (4 * self.n_kv_heads) // max(self.n_heads, 1)),
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_repeats=min(self.n_repeats, 2),
            prefix=tuple(BlockDef(b.mixer, b.ffn) for b in self.prefix[:1]),
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        if self.rope == "mrope":
            half = scale["head_dim"] // 2
            orig = sum(self.mrope_sections)
            secs = [max(1, s * half // orig) for s in self.mrope_sections]
            secs[-1] += half - sum(secs)
            scale["mrope_sections"] = tuple(secs)
        if self.n_experts:
            scale.update(n_experts=max(4, self.top_k),
                         top_k=min(self.top_k, 2))
        if self.q_lora_rank:
            scale.update(q_lora_rank=64, kv_lora_rank=64, qk_nope_dim=32,
                         qk_rope_dim=16, v_head_dim=32)
        return self.replace(**scale)
