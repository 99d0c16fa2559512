"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

16 experts, top-4, fine-grained MoE on every layer; LayerNorm
[hf:databricks/dbrx-base].
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab=100352,
        pattern=(BlockDef("gqa", "moe"),), n_repeats=40,
        norm="ln", activation="silu", rope="rope", rope_base=500_000.0,
        n_experts=16, top_k=4,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
