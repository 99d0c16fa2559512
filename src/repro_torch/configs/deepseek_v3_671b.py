"""deepseek-v3-671b [moe]: 61L d=7168 128H d_ff(expert)=2048 vocab=129280.

MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128); 3 dense prefix
layers (ff 18432); 58 MoE layers with 256 routed experts top-8 + 1 shared;
MTP head [arXiv:2412.19437].  The router's group-limited routing is plain
top-8, as in the reference.
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=2048, vocab=129280,
        prefix=(BlockDef("mla", "swiglu", d_ff=18432),) * 3,
        pattern=(BlockDef("mla", "moe"),), n_repeats=58,
        norm="rms", activation="silu", rope="rope",
        n_experts=256, top_k=8, n_shared_experts=1,
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
