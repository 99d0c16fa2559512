"""hubert-xlarge [audio]: 48L d=1280 16H (head_dim 80) d_ff=5120 vocab=504.

Encoder-only (bidirectional), wav2vec2-style blocks: GeLU FFN, parametric
LayerNorm, no rotary embedding, an untied 504-way head over the HuBERT
cluster targets [arXiv:2106.07447].  The CNN feature extractor and the
convolutional positional front end are outside the model, as in the
reference: ``transformer.apply(..., embeds=...)`` takes the frame
embeddings (B, S, 1280), and the model keeps no token table.  No
autoregressive decode (``EngineSpec.validate`` refuses it).
"""
import torch

from repro_torch.configs.base import ArchConfig, BlockDef


def config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab=504,
        pattern=(BlockDef("bidir", "gelu"),), n_repeats=48,
        norm="ln", activation="gelu", rope="none",
        causal=False, embed_input=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
