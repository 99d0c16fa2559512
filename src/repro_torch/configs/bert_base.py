"""bert-base, the paper's own NLP benchmark (Table 2 / Fig. 5): 12L d=768
12H d_ff=3072 vocab=30522, encoder-only (bidirectional attention), GeLU
FFN, parametric LayerNorm, RoPE, an untied LM head, float32.
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="bert-base",
        d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=30522,
        pattern=(BlockDef("bidir", "gelu"),), n_repeats=12,
        norm="ln", activation="gelu", rope="rope",
        causal=False,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
