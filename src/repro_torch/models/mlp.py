"""Dense SwiGLU MLP — port of the dense part of ``repro/models/mlp.py``
(MoE follows with ROADMAP Queue 1 item 13)."""
from __future__ import annotations

import torch

from repro_torch.models.common import init_qdense, qproj, qproj_group


def init_dense_mlp(gen: torch.Generator, cfg, device, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    # draw order gate, up, down (one generator stream)
    gate = init_qdense(gen, d, f, dt, device)
    up = init_qdense(gen, d, f, dt, device)
    down = init_qdense(gen, f, d, dt, device)
    return {"gate": gate, "up": up, "down": down}


def dense_mlp_apply(p: dict, x: torch.Tensor, bits: dict,
                    impl: str = "auto") -> torch.Tensor:
    """SwiGLU; bits: {'mlp_gateup', 'mlp_down'}."""
    g, u = qproj_group(x, (p["gate"], p["up"]), bits["mlp_gateup"], impl)
    return qproj(torch.nn.functional.silu(g) * u, p["down"],
                 bits["mlp_down"], impl)
