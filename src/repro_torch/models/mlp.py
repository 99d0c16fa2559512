"""Dense MLPs, SwiGLU and GeLU — port of the dense part of
``repro/models/mlp.py`` (MoE follows with ROADMAP Queue 1 item 13)."""
from __future__ import annotations

import torch

from repro_torch.models.common import init_qdense, qproj, qproj_group


def act_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    """SiLU, or GeLU in the tanh form that ``jax.nn.gelu`` takes by default
    (PyTorch's default is the exact erf form)."""
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(kind)


def init_dense_mlp(gen: torch.Generator, cfg, device, d_ff=None,
                   gated: bool = True) -> dict:
    """{'gate', 'up', 'down'} (SwiGLU), or {'up', 'down'} with
    ``gated=False`` (GeLU)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    # draw order gate, up, down (one generator stream)
    p = {"gate": init_qdense(gen, d, f, dt, device)} if gated else {}
    p["up"] = init_qdense(gen, d, f, dt, device)
    p["down"] = init_qdense(gen, f, d, dt, device)
    return p


def dense_mlp_apply(p: dict, x: torch.Tensor, bits: dict,
                    activation: str = "silu", impl: str = "auto",
                    hvp: bool = False) -> torch.Tensor:
    """act(gate) * up with a gate, else act(up); then down.  bits:
    {'mlp_gateup', 'mlp_down'}."""
    if "gate" in p:
        g, u = qproj_group(x, (p["gate"], p["up"]), bits["mlp_gateup"],
                           impl, hvp)
        h = act_fn(activation, g) * u
    else:
        h = act_fn(activation, qproj(x, p["up"], bits["mlp_gateup"], impl,
                                     hvp))
    return qproj(h, p["down"], bits["mlp_down"], impl, hvp)
