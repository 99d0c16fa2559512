"""PrecisionPolicy: named quantizable units -> per-layer bit-widths (port of
``repro/core/policy.py``; numpy only).

A unit is one or more projections that share an input activation and so
share one precision (paper §3.4.1, "linked layers"); it is the atom of
knapsack selection.  Pinning rules: embedding / LM head 8-bit, units with
fewer than 128 input features 4-bit.  The bucket plan of the JAX package has
no counterpart: the port runs the pattern as a Python loop over per-layer
params, so there is no scan whose compile time it would bound.  Per-expert
units (MoE) and the KV-cache bit selection follow with the parts of the
zoo and of the selection path that use them (ROADMAP Queue 1 items 3, 13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PIN_MIN_IN_FEATURES = 128
PIN_EDGE_BITS = 8.0
PIN_NARROW_BITS = 4.0


@dataclasses.dataclass(frozen=True)
class CacheUnit:
    """One per-layer KV-cache precision atom (serving-side state)."""
    name: str                     # unique, e.g. "pat0.cache.L3"
    group: str
    layer: int
    kv_elems_per_token: int
    pinned_bits: Optional[float] = None   # None => selectable

    @property
    def selectable(self) -> bool:
        return self.pinned_bits is None


@dataclasses.dataclass(frozen=True)
class QuantUnit:
    """One selectable precision atom (>=1 linked projections)."""
    name: str                     # unique, e.g. "pat0.attn_qkv.L3"
    group: str                    # e.g. "pat0"
    layer: int                    # index within the group
    slot: str                     # bits-dict key used by the model's apply
    tensors: Tuple[Tuple[str, ...], ...]
    n_params: int
    macs_per_token: float
    in_features: int
    pinned_bits: Optional[float] = None   # None => selectable

    @property
    def selectable(self) -> bool:
        return self.pinned_bits is None


class PrecisionPolicy:
    """Unit registry + current bits assignment."""

    def __init__(self, units: Sequence[QuantUnit], b_hi: float = 4.0,
                 b_lo: float = 2.0, cache_units: Sequence[CacheUnit] = ()):
        names = [u.name for u in units] + [c.name for c in cache_units]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate quant-unit names: {dupes[:5]}")
        self.units: List[QuantUnit] = list(units)
        self.by_name: Dict[str, QuantUnit] = {u.name: u for u in units}
        self.b_hi = float(b_hi)
        self.b_lo = float(b_lo)
        self._bits: Dict[str, float] = {
            u.name: (u.pinned_bits if u.pinned_bits is not None else self.b_hi)
            for u in units}
        self.cache_units: List[CacheUnit] = list(cache_units)

    def bits_of(self, name: str) -> float:
        return self._bits[name]

    def selectable_units(self) -> List[QuantUnit]:
        return [u for u in self.units if u.selectable]

    def apply_selection(self, keep_hi: Dict[str, bool]) -> "PrecisionPolicy":
        """Copy with selections applied: unit name -> keep at b_hi?"""
        new = self.copy()
        for u in self.selectable_units():
            new._bits[u.name] = (self.b_hi if keep_hi.get(u.name, True)
                                 else self.b_lo)
        return new

    def copy(self) -> "PrecisionPolicy":
        new = PrecisionPolicy(self.units, self.b_hi, self.b_lo,
                              cache_units=self.cache_units)
        new._bits = dict(self._bits)
        return new

    def as_arrays(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{group: {slot: float32 (n_layers,)}} per-layer bits."""
        lens: Dict[Tuple[str, str], int] = {}
        for u in self.units:
            key = (u.group, u.slot)
            lens[key] = max(lens.get(key, 0), u.layer + 1)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for u in self.units:
            grp = out.setdefault(u.group, {})
            if u.slot not in grp:
                grp[u.slot] = np.full((lens[(u.group, u.slot)],), self.b_hi,
                                      np.float32)
            grp[u.slot][u.layer] = self._bits[u.name]
        return out
