"""MLPs: SwiGLU and GeLU dense blocks, and the routed mixture of experts —
port of ``repro/models/mlp.py`` on one device (the reference's expert
parallelism under ``shard_map`` comes with ROADMAP Queue 1 item 14).

MoE dispatch is sort-based, as in the reference: the (token, choice) slots
are sorted stably by expert, each slot's rank within its expert is its row
in that expert's capacity buffer, and ranks at or past the capacity are
dropped.  Every expert is its own quant unit: its gate/up and its down have
their own bits and steps, and in the packed layout each expert is its own
``PackedLinear``, so each expert's projections run ``quant_matmul`` and its
two activation fake-quants ``lsq_fakequant`` on the card.  Nothing in the
dispatch reads a value on the host: the capacity comes from the shapes, the
per-expert counts from ``scatter_add_``, and every expert runs its whole
buffer whether any token chose it or not, as the reference's does.  A
shared expert (DeepSeek-V3's ``n_shared_experts``) is a gated dense MLP of
width d_ff x n_shared_experts under ``moe["shared"]``, which every token
runs, added after the routed combine at the block's ``mlp_gateup`` and
``mlp_down`` bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import quant
from repro_torch.core.quant import PackedLinear
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (fake_quant_bank, init_qdense, qproj,
                                       qproj_group)


def act_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    """SiLU, or GeLU in the tanh form that ``jax.nn.gelu`` takes by default
    (PyTorch's default is the exact erf form)."""
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(kind)


# ------------------------------------------------------------------- dense
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


# --------------------------------------------------------------------- MoE
def init_moe(gen: torch.Generator, cfg, device) -> dict:
    """{'router': pinned 8-bit dense (d, E), 'gate', 'up': banks (E, d, f),
    'down': (E, f, d)}; a bank holds its weights ``w``, a weight step ``sw``
    (E,) from each expert's weights and an activation step ``sa`` (E,), the
    reference's init formulas (every bank at d_model ** -0.5); with
    ``n_shared_experts``, 'shared': a gated dense MLP of width d_ff x
    n_shared_experts."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype

    def expert_bank(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=gen, dtype=dt,
                        device=device).mul_(d ** -0.5)
        return {"w": w,
                "sw": torch.stack([quant.init_step_from_tensor(wi, 4.0)
                                   for wi in w]),
                "sa": torch.full((e,), 2.0 / math.sqrt(2.0 ** 3 - 1),
                                 dtype=torch.float32, device=device)}

    # draw order router, gate, up, down, shared (one generator stream)
    p = {"router": init_qdense(gen, d, e, dt, device),
         "gate": expert_bank(d, f), "up": expert_bank(d, f),
         "down": expert_bank(f, d)}
    if cfg.n_shared_experts:
        p["shared"] = init_dense_mlp(gen, cfg, device,
                                     d_ff=f * cfg.n_shared_experts)
    return p


def _quant_bank(bank: dict, bits, impl: str = "auto", hvp: bool = False
                ) -> torch.Tensor:
    """The quantized weights (E, d_in, d_out) of a bank that is not packed:
    prequantized (``wpre``), the fake-quant serve layout's int8 codes times
    each expert's scale (float32), or LSQ fake-quant of each expert's
    weights at its own step and bits."""
    if "wpre" in bank:
        return bank["wpre"]
    if "wq" in bank:
        return bank["wq"].float() * bank["scale"].float()[:, None, None]
    return fake_quant_bank(bank["w"], bank["sw"], bits, impl, hvp,
                           quant.mean_qmax(bits))


def _expert_matmul(x: torch.Tensor, w, impl: str) -> torch.Tensor:
    """One expert projection: a PackedLinear (``quant_matmul`` on the
    card), or a dense (d_in, d_out) weight (the CPU decode view's
    ``{'wpre'}``, or a row of a quantized bank)."""
    if isinstance(w, PackedLinear):
        return kops.packed_matmul(x, w, impl=impl)
    if isinstance(w, dict):
        w = w["wpre"]
    return kref.matmul(x, w.to(x.dtype))


def _expert_sa(p) -> torch.Tensor:
    return p.sa if isinstance(p, PackedLinear) else p["sa"]


def capacity_of(cfg, t: int) -> int:
    """Rows of each expert's buffer for ``t`` tokens (pads and idle slots
    included): round_up(max(int(t k / E cf + 0.999), 8), 8)."""
    c = max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor
                + 0.999), 8)
    return -(-c // 8) * 8


def slot_ranks(flat_ids: torch.Tensor, n_experts: int):
    """The sort dispatch of (token, choice) slots ``flat_ids`` (T k,):
    the slots sorted stably by expert (``ids_s``, and ``order``, each
    sorted slot's index), and each sorted slot's rank within its expert
    (``pos``; a rank at or past the capacity is a dropped slot)."""
    ids_s, order = torch.sort(flat_ids, stable=True)
    counts = torch.zeros((n_experts,), dtype=torch.long,
                         device=flat_ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_ids.numel(), device=flat_ids.device) - \
        starts[ids_s]
    return ids_s, order, pos


def _moe_local(x_flat: torch.Tensor, top_ids: torch.Tensor,
               top_w: torch.Tensor, banks, sa_gate, sa_down, bits_gateup,
               bits_down, capacity: int, activation: str, impl: str,
               hvp: bool, grad_qmax=(None, None)) -> torch.Tensor:
    """Dispatch, the experts and the combine over one device's experts.

    x_flat (T, d); top_ids, top_w (T, k).  ``banks`` = (gate, up, down):
    lists of E per-expert PackedLinear (or their CPU decode views), or
    (E, d_in, d_out) quantized weights.  ``grad_qmax``: the qmax of the
    two activation fake-quants' step gradients (the reference fake-quantizes
    a stacked bank's buffers at once, so their mean over the experts).
    Returns (T, d) in x's dtype."""
    t, d = x_flat.shape
    k = top_ids.shape[1]
    e = len(bits_gateup)
    dev = x_flat.device
    ids_s, order, pos = slot_ranks(top_ids.reshape(-1), e)  # (T k,)
    tok_s = order // k
    # a dropped slot (rank at or past the capacity) writes the spare row
    dest = torch.where(pos < capacity, ids_s * capacity + pos, e * capacity)

    buf = x_flat.new_zeros((e * capacity + 1, d))
    buf.index_copy_(0, dest, x_flat[tok_s])
    # a quantized bank's experts by unbind, whose backward stacks their
    # gradients once (indexing each would write a bank-sized gradient)
    gate_w, up_w, down_w = (b.unbind(0) if isinstance(b, torch.Tensor)
                            else b for b in banks)
    outs = []
    for i in range(e):
        # gate and up share one fake-quant of the buffer at the gate's step
        # (the up bank's activation step is never read, as in the reference)
        xq = quant.fake_quant(buf[i * capacity:(i + 1) * capacity],
                              sa_gate[i], bits_gateup[i], impl, hvp,
                              grad_qmax[0])
        h = (act_fn(activation, _expert_matmul(xq, gate_w[i], impl))
             * _expert_matmul(xq, up_w[i], impl))
        hq = quant.fake_quant(h, sa_down[i], bits_down[i], impl, hvp,
                              grad_qmax[1])
        outs.append(_expert_matmul(hq, down_w[i], impl))
    outs.append(x_flat.new_zeros((1, d)))                  # dropped slots
    out = torch.cat(outs)

    # combine: each token's kept rows, weighted in x's dtype and added one
    # at a time in ascending expert order (the reference's scatter order)
    dest_of_slot = torch.empty_like(dest).scatter_(0, order, dest)
    _, j = torch.sort(top_ids, dim=1, stable=True)
    rows = out[dest_of_slot[torch.arange(t, device=dev)[:, None] * k + j]]
    w = torch.gather(top_w, 1, j).to(x_flat.dtype)[..., None]
    y = rows[:, 0] * w[:, 0]
    for c in range(1, k):
        y = y + rows[:, c] * w[:, c]
    return y


def route(logits: torch.Tensor, k: int):
    """Softmax over the experts, the top k of it (ties to the lower
    expert, as ``jax.lax.top_k``: a stable descending sort), renormalized.
    Returns (probs, top_w, top_ids)."""
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = vals[:, :k], ids[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_ids


def moe_apply(p: dict, x: torch.Tensor, bits: dict, cfg, impl: str = "auto",
              hvp: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux loss (0-d float32)).  bits:
    {'moe_router': the pinned 8, 'moe_gateup', 'moe_down': a bit-width
    an expert; with a shared expert also 'mlp_gateup' and 'mlp_down'}.
    The capacity is the reference's for t = B S tokens."""
    b, s, d = x.shape
    e, k, t = cfg.n_experts, cfg.top_k, b * s
    x_flat = x.reshape(t, d)

    # router (pinned 8-bit; its output feeds a softmax, paper §3.4.2)
    logits = qproj(x_flat, p["router"], bits["moe_router"], impl,
                   hvp).float()
    probs, top_w, top_ids = route(logits, k)

    # load-balance auxiliary loss (Switch/GShard form)
    chosen = torch.zeros((e,), dtype=torch.float32, device=x.device)
    chosen.scatter_add_(0, top_ids.reshape(-1),
                        torch.ones((t * k,), dtype=torch.float32,
                                   device=x.device))
    aux = torch.sum(probs.mean(0) * (chosen / t)) * e * cfg.moe_aux_weight

    bits_gu, bits_down = bits["moe_gateup"], bits["moe_down"]
    grad_qmax = (None, None)
    if isinstance(p["gate"], list):           # packed: a PackedLinear each
        banks = (p["gate"], p["up"], p["down"])
        sa_gate = [_expert_sa(q) for q in p["gate"]]
        sa_down = [_expert_sa(q) for q in p["down"]]
    else:
        banks = (_quant_bank(p["gate"], bits_gu, impl, hvp),
                 _quant_bank(p["up"], bits_gu, impl, hvp),
                 _quant_bank(p["down"], bits_down, impl, hvp))
        sa_gate, sa_down = p["gate"]["sa"], p["down"]["sa"]
        grad_qmax = (quant.mean_qmax(bits_gu), quant.mean_qmax(bits_down))
    y = _moe_local(x_flat, top_ids, top_w, banks, sa_gate, sa_down, bits_gu,
                   bits_down, capacity_of(cfg, t), cfg.activation, impl, hvp,
                   grad_qmax)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + dense_mlp_apply(p["shared"], x, bits, cfg.activation, impl,
                                hvp)
    return y, aux
