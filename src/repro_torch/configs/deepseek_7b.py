"""deepseek-7b [dense]: 30L d=4096 32H (MHA) d_ff=11008 vocab=102400.

LLaMA architecture: RMSNorm, SwiGLU, RoPE, an untied head
[arXiv:2401.02954].
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-7b",
        d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab=102400,
        pattern=(BlockDef("gqa", "swiglu"),), n_repeats=30,
        norm="rms", activation="silu", rope="rope",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
