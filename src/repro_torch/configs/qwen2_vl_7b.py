"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (temporal/height/width sections 16/24/24) at base 1e6, RMSNorm,
SwiGLU, an untied head [arXiv:2409.12191].  The vision front end is
outside the model, as in the reference: the caller passes the (3, B, S)
position streams (``transformer.apply(..., mrope_positions=)``); text
serving collapses them to the 1-D position (``serve.engine``).
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b",
        d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152064,
        pattern=(BlockDef("gqa", "swiglu"),), n_repeats=28,
        norm="rms", activation="silu", rope="mrope",
        mrope_sections=(16, 24, 24), rope_base=1_000_000.0,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
