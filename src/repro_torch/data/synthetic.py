"""Deterministic, stateless-resumable synthetic LM data — port of
``repro/data/synthetic.py``.

The same task: each sequence follows tokens[t] = (a + b t) mod V with
i.i.d. corruption, labels are the next token, every position counts.  The
draws come from a ``torch.Generator`` on the batch's device seeded by
(seed, step), so a batch depends on nothing but those two and resuming
from a step counter is exact.  The streams differ from the reference's
threefry draws: tests that compare the two packages feed the reference's
batches in as numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import resolve_device


def _seed(seed: int, step: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


def make_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
               noise: float = 0.05, device="cuda") -> Dict[str, torch.Tensor]:
    """{'tokens', 'labels'} (B, S) int64 and 'loss_mask' (B, S) float32 on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(_seed(seed, step))
    a = torch.randint(0, vocab, (batch, 1), generator=gen, device=dev)
    b = torch.randint(1, min(vocab, 64), (batch, 1), generator=gen,
                      device=dev)
    t = torch.arange(seq + 1, device=dev)[None, :]
    toks = (a + b * t) % vocab
    corrupt = torch.rand(toks.shape, generator=gen, device=dev) < noise
    rand = torch.randint(0, vocab, toks.shape, generator=gen, device=dev)
    toks = torch.where(corrupt, rand, toks)
    labels = toks[:, 1:]
    return {"tokens": toks[:, :-1], "labels": labels,
            "loss_mask": torch.ones(labels.shape, dtype=torch.float32,
                                    device=dev)}


@dataclasses.dataclass
class SyntheticLM:
    """Iterator with a checkpointable cursor (just the step)."""
    seed: int
    batch: int
    seq: int
    vocab: int
    step: int = 0
    device: str = "cuda"

    def next(self) -> Dict[str, torch.Tensor]:
        out = make_batch(self.seed, self.step, self.batch, self.seq,
                         self.vocab, device=self.device)
        self.step += 1
        return out

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def restore(cls, state: dict, batch: int, seq: int, vocab: int,
                device="cuda") -> "SyntheticLM":
        return cls(seed=state["seed"], batch=batch, seq=seq, vocab=vocab,
                   step=state["step"], device=device)
