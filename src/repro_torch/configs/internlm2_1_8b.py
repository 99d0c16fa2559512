"""internlm2-1.8b [dense]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

LLaMA-style with grouped-query attention: RMSNorm, SwiGLU, RoPE at base
1e6, an untied head [arXiv:2403.17297].
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b",
        d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=92544,
        pattern=(BlockDef("gqa", "swiglu"),), n_repeats=24,
        norm="rms", activation="silu", rope="rope", rope_base=1_000_000.0,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
