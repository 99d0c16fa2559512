"""Token sampling (port of ``repro/serve/sampling.py``, greedy only).

Temperature and top-k sampling draw through JAX's threefry keys; matching
them bit for bit is ROADMAP Queue 1 item 11, so ``EngineSpec`` refuses
them and ``sample`` implements greedy decoding.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """kind: 'greedy' | 'temperature' | 'top_k' (only greedy is ported)."""
    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.kind not in ("greedy", "temperature", "top_k"):
            raise ValueError(self.kind)


GREEDY = SamplerConfig()


def sample(logits: torch.Tensor, cfg: SamplerConfig = GREEDY
           ) -> torch.Tensor:
    """logits (B, V) -> (B,) int32: the first maximal index, as jnp.argmax."""
    if cfg.kind != "greedy":
        raise NotImplementedError("non-greedy sampling is ROADMAP Queue 1 "
                                  "item 11")
    return torch.argmax(logits, dim=-1).to(torch.int32)
