"""olmo-1b [dense]: 16L d=2048 16H (MHA) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE, tied embeddings
[arXiv:2402.00838].
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b",
        d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab=50304,
        pattern=(BlockDef("gqa", "swiglu"),), n_repeats=16,
        norm="nonparam_ln", activation="silu", rope="rope",
        tie_embeddings=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
