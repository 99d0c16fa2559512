"""PyTorch + CUDA port of ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package trains olmo-1b
and bert-base (``configs.get_config``) with 4-bit LSQ QAT (``train/``),
selects a 4/2-bit mix with EAGL, ALPS, HAWQ-v3 or a baseline
(``core/metrics``) and the knapsack, sweeps the paper's frontier
(``core/frontier.py``), and serves the packed checkpoint (bert-base, an
encoder, runs its packed forward), with hand-written CUDA kernels
(``csrc/``) on an H100.  It imports neither ``jax`` nor ``repro``.

Entry points (``init_params``, ``init_train_state``, ``make_batch``,
``pack_params``, ``ServeEngine``) take an explicit ``device=`` that
defaults to ``"cuda"`` and raise when no CUDA device is present; the tests
pass ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; refuse CUDA when there is none.

    The port never falls back to the CPU on its own: asking for the card
    on a machine without one is an error, not a slower run.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
