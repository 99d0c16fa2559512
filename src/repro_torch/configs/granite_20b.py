"""granite-20b [dense, code]: 52L d=6144 48H (MQA kv=1) d_ff=24576
vocab=49152.

GPT-BigCode lineage: multi-query attention (48 query heads on one KV
head), a non-gated GeLU MLP (d_ff = 4d), parametric LayerNorm, an untied
head [arXiv:2405.04324].  RoPE stands in for the learned absolute
positions, as in the reference (the positional scheme is orthogonal to
the quantization study).
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-20b",
        d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152,
        pattern=(BlockDef("gqa", "gelu"),), n_repeats=52,
        norm="ln", activation="gelu", rope="rope",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
