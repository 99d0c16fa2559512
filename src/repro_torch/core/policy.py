"""PrecisionPolicy: named quantizable units -> per-layer bit-widths (port of
``repro/core/policy.py``; numpy only).

A unit is one or more projections that share an input activation and so
share one precision (paper §3.4.1, "linked layers"); it is the atom of
knapsack selection.  Pinning rules: embedding / LM head 8-bit, units with
fewer than 128 input features 4-bit.  Beside the weight bits the policy
carries per-layer KV-cache bits (int8 or int4, or full), which
``knapsack.select_weights_and_cache`` trades against the weights in one
byte budget.  The bucket plan of the JAX package has no counterpart: the
port runs the pattern as a Python loop over per-layer params, so there is
no scan whose compile time it would bound.  A per-expert unit (MoE) carries
its expert index in ``sub``, and its slot's bits array gains an expert axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PIN_MIN_IN_FEATURES = 128
PIN_EDGE_BITS = 8.0
PIN_NARROW_BITS = 4.0
CACHE_FULL_BITS = 16.0          # "16-passthrough": cache stays full dtype


@dataclasses.dataclass(frozen=True)
class CacheUnit:
    """One per-layer KV-cache precision atom (serving-side state).
    ``kv_elems_per_token`` counts the cache elements a token appends (GQA:
    2 * n_kv_heads * head_dim); a selectable unit trades cache_b_hi (int8)
    against cache_b_lo (int4), a pinned one stays at its bits."""
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
    sub: Optional[int] = None     # expert index (the bits array gains a dim)
    pinned_bits: Optional[float] = None   # None => selectable

    @property
    def selectable(self) -> bool:
        return self.pinned_bits is None


class PrecisionPolicy:
    """Unit registry + current bits assignment (weights and KV cache)."""

    def __init__(self, units: Sequence[QuantUnit], b_hi: float = 4.0,
                 b_lo: float = 2.0, cache_units: Sequence[CacheUnit] = (),
                 cache_b_hi: float = 8.0, cache_b_lo: float = 4.0):
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
        self.cache_by_name: Dict[str, CacheUnit] = {c.name: c
                                                    for c in cache_units}
        self.cache_b_hi = float(cache_b_hi)
        self.cache_b_lo = float(cache_b_lo)
        self._cache_bits: Dict[str, float] = {
            c.name: (c.pinned_bits if c.pinned_bits is not None
                     else self.cache_b_hi)
            for c in cache_units}

    # ----------------------------------------------------------------- basic
    def bits_of(self, name: str) -> float:
        return self._bits[name]

    def set_bits(self, name: str, bits: float) -> None:
        u = self.by_name[name]
        if not u.selectable:
            raise ValueError(f"unit {name} is pinned at {u.pinned_bits} bits")
        self._bits[name] = float(bits)

    def selectable_units(self) -> List[QuantUnit]:
        return [u for u in self.units if u.selectable]

    # ------------------------------------------------------------ cache bits
    def cache_bits_of(self, name: str) -> float:
        return self._cache_bits[name]

    def set_cache_bits(self, name: str, bits: float) -> None:
        c = self.cache_by_name[name]
        if not c.selectable:
            raise ValueError(f"cache unit {name} is pinned at "
                             f"{c.pinned_bits} bits")
        if float(bits) not in (4.0, 8.0, CACHE_FULL_BITS):
            raise ValueError(f"cache bits must be 4/8/{CACHE_FULL_BITS:g}, "
                             f"got {bits}")
        self._cache_bits[name] = float(bits)

    def selectable_cache_units(self) -> List[CacheUnit]:
        return [c for c in self.cache_units if c.selectable]

    def apply_cache_selection(self, keep_hi: Dict[str, bool]
                              ) -> "PrecisionPolicy":
        """Copy with cache selections applied: unit name -> keep int8?"""
        new = self.copy()
        for c in self.selectable_cache_units():
            new._cache_bits[c.name] = (self.cache_b_hi
                                       if keep_hi.get(c.name, True)
                                       else self.cache_b_lo)
        return new

    def uniform_cache(self, bits: float) -> "PrecisionPolicy":
        new = self.copy()
        for c in self.selectable_cache_units():
            new._cache_bits[c.name] = float(bits)
        return new

    def cache_bits_arrays(self) -> Dict[str, np.ndarray]:
        """{group: float32 (n_layers,)} per-layer cache bits; a layer with
        no cache unit reads CACHE_FULL_BITS."""
        lens: Dict[str, int] = {}
        for c in self.cache_units:
            lens[c.group] = max(lens.get(c.group, 0), c.layer + 1)
        out: Dict[str, np.ndarray] = {}
        for c in self.cache_units:
            if c.group not in out:
                out[c.group] = np.full((lens[c.group],), CACHE_FULL_BITS,
                                       np.float32)
            out[c.group][c.layer] = self._cache_bits[c.name]
        return out

    def kv_bytes_per_token(self) -> float:
        """KV-cache bytes a generated token appends under the current cache
        bits (codes only; the scales are O(1/head_dim) more)."""
        return float(sum(self._cache_bits[c.name] / 8.0
                         * c.kv_elems_per_token for c in self.cache_units))

    # ------------------------------------------------------------ assignment
    def apply_selection(self, keep_hi: Dict[str, bool]) -> "PrecisionPolicy":
        """Copy with selections applied: unit name -> keep at b_hi?"""
        new = self.copy()
        for u in self.selectable_units():
            new._bits[u.name] = (self.b_hi if keep_hi.get(u.name, True)
                                 else self.b_lo)
        return new

    def uniform(self, bits: float) -> "PrecisionPolicy":
        new = self.copy()
        for u in self.selectable_units():
            new._bits[u.name] = float(bits)
        return new

    def copy(self) -> "PrecisionPolicy":
        new = PrecisionPolicy(self.units, self.b_hi, self.b_lo,
                              cache_units=self.cache_units,
                              cache_b_hi=self.cache_b_hi,
                              cache_b_lo=self.cache_b_lo)
        new._bits = dict(self._bits)
        new._cache_bits = dict(self._cache_bits)
        return new

    # -------------------------------------------------------------- exports
    def as_arrays(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{group: {slot: float32 (n_layers,) or (n_layers, n_sub)}}
        per-layer bits; a per-expert slot has a row a layer."""
        lens: Dict[Tuple[str, str], int] = {}
        subs: Dict[Tuple[str, str], int] = {}
        for u in self.units:
            key = (u.group, u.slot)
            lens[key] = max(lens.get(key, 0), u.layer + 1)
            if u.sub is not None:
                subs[key] = max(subs.get(key, 0), u.sub + 1)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for u in self.units:
            key = (u.group, u.slot)
            grp = out.setdefault(u.group, {})
            if u.slot not in grp:
                shape = ((lens[key], subs[key]) if key in subs
                         else (lens[key],))
                grp[u.slot] = np.full(shape, self.b_hi, np.float32)
            if u.sub is not None:
                grp[u.slot][u.layer, u.sub] = self._bits[u.name]
            else:
                grp[u.slot][u.layer] = self._bits[u.name]
        return out

    # ------------------------------------------------------------ accounting
    def cost_bmacs_per_token(self, selectable_only: bool = True) -> float:
        """Sum of bits x MACs per token (over the selectable units)."""
        return float(sum(self._bits[u.name] * u.macs_per_token
                         for u in self.units
                         if u.selectable or not selectable_only))

    def model_bits(self) -> float:
        return float(sum(self._bits[u.name] * u.n_params for u in self.units))

    def compression_ratio(self) -> float:
        n = sum(u.n_params for u in self.units)
        return 32.0 * n / max(self.model_bits(), 1.0)

    def summary(self) -> str:
        return "\n".join(
            f"{u.name:48s} {self._bits[u.name]:.0f}b "
            f"macs/tok={u.macs_per_token:.3e} "
            f"{'pinned' if not u.selectable else ''}" for u in self.units)
