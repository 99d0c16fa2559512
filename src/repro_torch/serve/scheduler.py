"""Continuous batching: fixed-slot admission, per-request stop and
eviction — port of ``repro/serve/scheduler.py``.

Production serving never waits for a whole batch to finish: requests are
admitted into fixed batch SLOTS as they arrive, decode advances all slots
together, and a slot is freed the moment its request stops (EOS or token
budget).  The scheduler does this at chunk granularity, one iteration
being the engine's decode chunk:

  admit   - pop pending requests into free slots; each request is
            prefilled alone (its prompt padded to a small bucket) and its
            cache written into the shared buffers at its slot
            (``kv_cache.write_slot``; paged: ``paging.write_slot_pages``
            into the pages ``paging.plan_admission`` mapped, sharing any
            registered prefix).  Unequal prompt lengths are the normal
            case: every slot keeps its own valid length and position.
  decode  - one chunk for ALL slots; inactive slots decode garbage that
            never reaches the cache (their write position is pinned out of
            range) and is discarded here.
  harvest - per-request stop conditions: EOS token or max_new_tokens.
            Finished slots are evicted; their rows become garbage until
            overwritten, which the admission and decode masking already
            guarantee is never read.

The loop is host-side control over batch steps whose shapes never change
as requests come and go: request boundaries change only tensor contents
(lengths, active mask, feed tokens, block-table rows).  Each admission
makes one device-to-host copy (its first token) and each decode chunk one
(its tokens); the block table and lengths are written from the host,
never read back.

Over a mixture of experts each expert's capacity counts the tokens of
one call, as in the reference: an admission prefills its request alone
(its padded prompt), and a decode step runs every slot, idle ones
included, whose n_slots tokens send at most one slot each to an expert
of at least 8 rows (``models.mlp.capacity_of``).

A deterministic sim clock ticks in model-step units (a prefill costs its
padded token count, a decode chunk its step count); ``latency_report()``
turns the per-request emission clocks into p50/p95/p99 TTFT and
inter-token stall percentiles, the same numbers as the reference's for
the same workload.

Not ported: chunked prefill and speculative rounds (ROADMAP Queue 1 item
10; ``EngineSpec`` refuses ``prefill_chunk`` and ``draft``), sampled
decoding with its per-request sampling keys and admission nonces (item
11; a ``key`` is refused) and ``dispatch_audit`` (XLA's jit caches; item
15).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import kv_quant as kvq
from repro_torch.serve import kv_cache, paging, sampling
from repro_torch.serve.engine import ServeEngine


@dataclasses.dataclass
class Request:
    uid: str
    prompt: Sequence[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    uid: str
    prompt_len: int
    tokens: List[int]              # generated tokens (EOS included if hit)
    finish_reason: str             # 'eos' | 'length'


@dataclasses.dataclass
class _Slot:
    req: Request
    emitted: List[int]


class ContinuousBatchingScheduler:
    """Drive a ServeEngine with slot-based continuous batching."""

    def __init__(self, engine: ServeEngine, n_slots: int = 4,
                 prompt_bucket: int = 16, key=None,
                 share_prefixes: bool = True):
        self.engine = engine
        self.n_slots = n_slots
        self.prompt_bucket = prompt_bucket
        if key is not None:
            raise NotImplementedError(
                "sampled scheduling (a sampling key and per-admission "
                "nonces) is ROADMAP Queue 1 item 11; decoding is greedy")
        self.cache = engine.new_cache(n_slots)
        self._paged = engine.cache_layout == "paged"
        if self._paged:
            # host-side page bookkeeping: worst-case pages are claimed at
            # admission, released at eviction; the registry holds recently
            # seen prefixes alive for sharing
            self.allocator = paging.PageAllocator(
                paging.n_pool_pages(self.cache), engine.page_size)
            self.registry = (paging.PrefixRegistry(self.allocator)
                             if share_prefixes else None)
            self._slot_pages: List[Optional[List[int]]] = [None] * n_slots
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self._tok = np.zeros((n_slots, 1), np.int32)
        self.completed: Dict[str, Completion] = {}
        # deterministic sim clock (model-step units) + per-request emission
        # times: latency_report() derives TTFT / inter-token percentiles
        self.clock = 0
        self._submit_clock: Dict[str, int] = {}
        self._emit_clocks: Dict[str, List[int]] = {}

    # ------------------------------------------------------------ frontend
    def submit(self, req: Request) -> None:
        n_prompt = len(req.prompt)
        if n_prompt < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens < 1")
        if n_prompt + req.max_new_tokens > self.engine.max_seq:
            raise ValueError(
                f"request {req.uid}: {n_prompt}+{req.max_new_tokens} "
                f"exceeds max_seq {self.engine.max_seq}")
        if self._paged:
            need = kvq.page_count(n_prompt + req.max_new_tokens,
                                  self.engine.page_size)
            if need > self.allocator.n_pages:
                raise ValueError(
                    f"request {req.uid}: needs {need} pages but the pool "
                    f"holds {self.allocator.n_pages}: raise "
                    f"EngineSpec(n_pages=...)")
        self._submit_clock.setdefault(req.uid, self.clock)
        self.queue.append(req)

    def run(self) -> Dict[str, Completion]:
        """Drain the queue; returns uid -> Completion."""
        while self.queue or any(s is not None for s in self.slots):
            self._admit()
            if any(s is not None for s in self.slots):
                self._decode_harvest()
        return self.completed

    def dispatch_audit(self) -> dict:
        raise NotImplementedError(
            "dispatch_audit counts XLA jit-cache entries; its CUDA-graph "
            "counterpart is ROADMAP Queue 1 item 15")

    # ------------------------------------------------------------ internals
    def _record_emit(self, uid: str, clock: Optional[int] = None) -> None:
        self._emit_clocks.setdefault(uid, []).append(
            self.clock if clock is None else clock)

    def _begin_decode(self, j: int, slot: _Slot, first: int) -> None:
        """A request's prompt is in the cache and its first token sampled:
        the slot starts decoding (or is evicted at once when that token
        already finishes it)."""
        slot.emitted.append(first)
        self._record_emit(slot.req.uid)
        if self._finish_reason(slot) is not None:
            self._evict(slot, j)
            return
        self.slots[j] = slot
        self._tok[j, 0] = first

    def _admit(self) -> None:
        for j in range(self.n_slots):
            if self.slots[j] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            if self._paged:
                last = self._admit_paged(j, req)
                if last is None:
                    # pool exhausted: defer admission (FIFO preserved)
                    # until an eviction returns pages to the free list
                    self.queue.appendleft(req)
                    return
            else:
                last = self._admit_contiguous(j, req)
            # the admission's one device-to-host copy
            first = int(sampling.sample(last, self.engine.sampler)[0])
            self._begin_decode(j, _Slot(req=req, emitted=[]), first)

    def _bucket_pad(self, n: int, cap: int) -> int:
        """Bucket a prompt or suffix length, never past ``cap`` (the
        written rows must fit the slot's window)."""
        return min(-(-n // self.prompt_bucket) * self.prompt_bucket, cap)

    def _prompt_tokens(self, tokens: Sequence[int], pad: int) -> np.ndarray:
        toks = np.zeros((1, pad), np.int64)
        toks[0, :len(tokens)] = np.asarray(tokens, np.int64)
        return toks

    def _admit_contiguous(self, j: int, req: Request) -> torch.Tensor:
        n_prompt = len(req.prompt)
        pad = self._bucket_pad(n_prompt, self.engine.max_seq)
        last, pre = self.engine.prefill(self._prompt_tokens(req.prompt, pad),
                                        torch.tensor([n_prompt]))
        self.cache = kv_cache.write_slot(self.cache, pre, j, n_prompt)
        self.clock += pad               # whole-prompt prefill: every other
                                        # slot stalls for the padded prompt
        return last

    def _admit_paged(self, j: int, req: Request) -> Optional[torch.Tensor]:
        """Map pages (sharing any registered prefix), prefill only what
        the mapping does not already cover, register the new prefix.
        Returns the last valid prompt logits, or None when the pool cannot
        cover the request's worst case (the caller defers)."""
        eng = self.engine
        page = eng.page_size
        n_prompt = len(req.prompt)
        plan = paging.plan_admission(self.allocator, self.registry,
                                     tuple(req.prompt), req.max_new_tokens,
                                     quantized=eng.cache == "quantized")
        if plan is None:
            return None
        self.cache = paging.set_table_rows(self.cache, j, plan.pages)
        self._slot_pages[j] = plan.pages
        if plan.cow_src is not None:
            # copy-on-write of the shared partial tail page, at the moment
            # its divergent write is known (admission: this slot's decode
            # writes into that page)
            self.cache = paging.copy_pages(self.cache, plan.cow_src,
                                           plan.fresh[0])
        if plan.suffix_start >= n_prompt and plan.entry is not None:
            # identical-prompt hit: the donor's pages, K grids and last
            # logits are what this request's own prefill would give
            if plan.entry.k_scales is not None:
                self.cache = paging.set_slot_k_scales(self.cache, j,
                                                      plan.entry.k_scales)
            last = plan.entry.last_logits[None]
        elif plan.suffix_start > 0:
            # page-aligned prefix hit (full-dtype cache): prefill only the
            # unshared suffix, attending over the shared prefix pages
            suffix = list(req.prompt[plan.suffix_start:])
            pad = self._bucket_pad(len(suffix),
                                   eng.max_seq - plan.suffix_start)
            last, suf = eng.prefill_suffix(self._prompt_tokens(suffix, pad),
                                           len(suffix), plan.suffix_start,
                                           self.cache, j)
            self.clock += pad
            start_page = plan.suffix_start // page
            phys = plan.pages[start_page:
                              start_page + kvq.page_count(pad, page)]
            self.cache = paging.write_slot_pages(self.cache, suf, j,
                                                 len(suffix),
                                                 plan.suffix_start, phys)
        else:
            # miss: the whole prompt, exactly the contiguous admission math
            pad = self._bucket_pad(n_prompt, eng.max_seq)
            last, pre = eng.prefill(self._prompt_tokens(req.prompt, pad),
                                    torch.tensor([n_prompt]))
            self.clock += pad
            n_write = min(kvq.page_count(pad, page), len(plan.pages))
            self.cache = paging.write_slot_pages(self.cache, pre, j,
                                                 n_prompt, 0,
                                                 plan.pages[:n_write])
            self._register_prefix(j, req, plan, last)
        self.cache = paging.set_length(self.cache, j, n_prompt)
        return last

    def _register_prefix(self, j: int, req: Request, plan: paging.AdmitPlan,
                         last: torch.Tensor) -> None:
        """After a miss admission, make this prompt's prefix shareable."""
        if self.registry is None:
            return
        page = self.engine.page_size
        n_prompt = len(req.prompt)
        if self.engine.cache == "quantized":
            # only an identical whole prompt reproduces the per-request K
            # grid, so quantized entries memoize the whole admission:
            # pages (with the partial tail), grids, last logits
            self.registry.register(paging.PrefixEntry(
                key=tuple(req.prompt),
                pages=plan.pages[:kvq.page_count(n_prompt, page)],
                n_tokens=n_prompt, full_prompt=True, last_logits=last[0],
                k_scales=paging.get_slot_k_scales(self.cache, j)))
            return
        aligned = (n_prompt // page) * page
        if aligned >= page:
            self.registry.register(paging.PrefixEntry(
                key=tuple(req.prompt[:aligned]),
                pages=plan.pages[:aligned // page], n_tokens=aligned,
                full_prompt=False,
                last_logits=(last[0] if aligned == n_prompt else None)))

    def _decode_harvest(self) -> None:
        dev = self.engine.device
        active = np.array([s is not None for s in self.slots])
        # tail chunk: when every live slot's remaining budget is short,
        # run the next power of two of steps, not the whole chunk
        remaining = max(s.req.max_new_tokens - len(s.emitted)
                        for s in self.slots if s is not None)
        tail = 1
        while tail < remaining:
            tail *= 2
        n_steps = min(self.engine.decode_chunk, tail)
        self.cache, _, toks = self.engine.decode_chunk_step(
            self.cache, torch.as_tensor(self._tok, device=dev),
            active=torch.as_tensor(active, device=dev), n_steps=n_steps)
        toks_np = toks.cpu().numpy()    # the chunk's one device-to-host copy
        c0 = self.clock                 # step i emits at c0 + i + 1
        self.clock += n_steps
        for j, slot in enumerate(self.slots):
            if slot is None:
                continue
            done = False
            for i, t in enumerate(toks_np[j]):
                slot.emitted.append(int(t))
                self._record_emit(slot.req.uid, c0 + i + 1)
                if self._finish_reason(slot) is not None:
                    done = True
                    break
            if done:
                self._evict(slot, j)
            else:
                self._tok[j, 0] = slot.emitted[-1]

    # ------------------------------------------------------------ telemetry
    def latency_report(self) -> dict:
        """Deterministic step-count latency percentiles.

        The sim clock ticks in MODEL-STEP units: a prefill costs its padded
        token count, a decode chunk one unit per step (emissions land at
        successive steps).  TTFT = first-emission clock minus submit
        clock; inter-token = gaps between consecutive emissions of one
        request, whose p99 and max are the stall a long-prompt admission
        inflicts on its batchmates.  Identical across runs for a fixed
        workload, and equal to the reference's.
        """
        ttfts, gaps = [], []
        for uid, emits in self._emit_clocks.items():
            ttfts.append(emits[0] - self._submit_clock.get(uid, 0))
            gaps.extend(float(b - a) for a, b in zip(emits, emits[1:]))

        def pcts(xs):
            if not xs:
                return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0}
            a = np.asarray(xs, np.float64)
            return {"p50": float(np.percentile(a, 50, method="nearest")),
                    "p95": float(np.percentile(a, 95, method="nearest")),
                    "p99": float(np.percentile(a, 99, method="nearest")),
                    "max": float(a.max())}

        return {"unit": "model_steps", "clock": round(float(self.clock), 4),
                "n_requests": len(self._emit_clocks),
                "n_tokens": int(sum(len(v)
                                    for v in self._emit_clocks.values())),
                "ttft": pcts(ttfts), "inter_token": pcts(gaps)}

    def _finish_reason(self, slot: _Slot) -> Optional[str]:
        if slot.req.eos_id is not None \
                and slot.emitted[-1] == slot.req.eos_id:
            return "eos"
        if len(slot.emitted) >= slot.req.max_new_tokens:
            return "length"
        return None

    def _evict(self, slot: _Slot, j: int) -> None:
        reason = self._finish_reason(slot) or "length"
        self.completed[slot.req.uid] = Completion(
            uid=slot.req.uid, prompt_len=len(slot.req.prompt),
            tokens=list(slot.emitted), finish_reason=reason)
        self.slots[j] = None
        if self._paged and self._slot_pages[j] is not None:
            # drop this slot's mappings; pages return to the free list only
            # at refcount 0 (a prefix the registry or another slot holds
            # stays resident)
            self.allocator.release(self._slot_pages[j])
            self._slot_pages[j] = None
            # and UNMAP the table row: until re-admission this slot keeps
            # decoding as an inactive lane, and with max_seq % page != 0
            # its pinned position is in table range - a stale entry would
            # route the write into a freed (possibly re-allocated) page
            self.cache = paging.set_table_rows(self.cache, j, [])


def serve_all(engine: ServeEngine, requests: Sequence[Request],
              n_slots: int = 4, prompt_bucket: int = 16, key=None,
              share_prefixes: bool = True) -> Dict[str, Completion]:
    """Submit everything, drain, return the completions."""
    sched = ContinuousBatchingScheduler(engine, n_slots=n_slots,
                                        prompt_bucket=prompt_bucket, key=key,
                                        share_prefixes=share_prefixes)
    for r in requests:
        sched.submit(r)
    return sched.run()
