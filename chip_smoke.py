#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi); no card fails.
  2. build   - nvcc builds the four kernels from src/repro_torch/csrc into
               build/kernels/ (parallel, one process per source).
  3. kernels - each kernel against its plain PyTorch version at the main
               path's shapes, with its tolerance, kernel / plain / library
               times (CUDA events, warm-up excluded, L2 flushed) and bound.
  4. serve   - olmo-1b at full width, weights drawn on the card from seed 0,
               knapsack-mixed 4/2 packed (budget 0.7), 8 prompts of 128-512
               tokens right-padded to 512, 64 new tokens, max_seq 1024, over
               an int8 and an int4 KV cache; counts every kernel's launches;
               a torch.profiler breakdown of one prefill and 8 decode steps.
  5. check   - kernel path against the plain path (impl="ref") on the same
               weights, teacher-forced with the kernel path's tokens over
               the prefill and 16 decode steps, beside a control: the plain
               path with its prefill attention in float64 (see phase_check).
The second-to-last line is the kernels JSON, the last the device JSON.
Details go to chiprun_out/chip_smoke.json and chiprun_out/build_log.txt.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_OPS_PER_S = 989e12          # dense bf16 tensor cores
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
CONTROL_FACTOR = 1.25            # kernel vs plain logits, over the control's
ONE_BLOCK_BOUND = 1e-3           # relative logit error over one block
BLOCK_RMS_BOUND = 5e-2           # one block's own output error, RMS
TPU_SOURCES = {
    "quant_matmul": "src/repro/kernels/quant_matmul.py:72",
    "kv_decode_attention": "src/repro/kernels/flash_attention.py:131",
    "flash_attention": "src/repro/kernels/flash_attention.py:318",
    "lsq_fakequant": "src/repro/kernels/lsq_fakequant.py:31",
}
CUDA_SOURCES = {name: f"src/repro_torch/csrc/{name}.cu"
                for name in TPU_SOURCES}


def log(*args):
    print(*args, flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Mean device time of a call: CUDA events around each call, the 50 MB
    L2 flushed (not timed) before each, warm-up calls excluded."""

    def __init__(self, dev):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False - "
                         "this script needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    seconds = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    with open(OUT / "build_log.txt", "w") as f:
        for name, rec in info.items():
            f.write(f"===== {name}\n{rec['log']}\n")
    spills = sum(bool(re.search(r"[1-9]\d* bytes spill stores", line))
                 for rec in info.values() for line in rec["log"].splitlines())
    log(f"build: {len(info)} kernel libraries in {seconds:.1f} s "
        f"({spills} ptxas lines with spill stores; log in "
        f"chiprun_out/build_log.txt)")
    return seconds


# ------------------------------------------------------------ kernel phases
def check_quant_matmul(timer, dev, gen):
    from repro_torch.kernels import cuda, ref
    cases = []
    for bits in (4, 2):
        for (k, n) in ((2048, 2048), (2048, 8192), (8192, 2048)):
            for m in (8, 8 * 512):
                lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
                codes = torch.randint(lo, hi, (k, n), generator=gen,
                                      device=dev)
                wp = (ref.pack_w4 if bits == 4 else ref.pack_w2)(codes)
                x = (torch.randn((m, k), generator=gen, device=dev)
                     ).to(torch.bfloat16)
                scale = torch.rand((n,), generator=gen, device=dev) * 0.02 \
                    + 1e-3
                got = cuda.quant_matmul(x, wp, scale, bits).float()
                plain = ref.quant_matmul_w4 if bits == 4 else ref.quant_matmul_w2
                want = plain(x, wp, scale)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = bf16_ulp(float(want.abs().max()))
                ok = err <= tol
                w_bf16 = (codes.float() * scale[None]).to(torch.bfloat16)
                rec = {"bits": bits, "m": m, "k": k, "n": n,
                       "max_abs_err": err, "tol": tol, "ok": ok,
                       "ms": timer(lambda: cuda.quant_matmul(x, wp, scale,
                                                             bits)),
                       "plain_ms": timer(lambda: plain(x, wp, scale)),
                       "library_ms": timer(lambda: torch.matmul(x, w_bf16))}
                nb = m * k * 2 + wp.numel() + n * 4 + m * n * 2
                rec["bound_ms"], rec["bound_by"] = bound_ms(
                    nb, 2.0 * m * n * k, BF16_OPS_PER_S)
                log(f"  quant_matmul w{bits} M={m} K={k} N={n}: err {err:.3g}"
                    f" (tol {tol:.3g}, 1 bf16 ulp of max|ref|) "
                    f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
                    f"cuBLAS bf16 {rec['library_ms']:.4f}, bound "
                    f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
                cases.append(rec)
                del codes, wp, x, w_bf16, got, want
    # headline: the decode gate/up projection at int4
    head = next(c for c in cases if (c["bits"], c["m"], c["k"], c["n"])
                == (4, 8, 2048, 8192))
    return head, cases


def check_kv_decode(timer, dev, gen):
    from repro_torch.kernels import cuda, kv_quant, ref
    b, s, h, d = 8, 1024, 16, 128
    cases = []
    for bits in (8, 4):
        k = torch.randn((b, s, h, d), generator=gen, device=dev)
        v = torch.randn((b, s, h, d), generator=gen, device=dev)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        qc = kv_quant.quantize_prefill({"k": k, "v": v}, lengths, bits)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        # positions spread over the cache; slot 0 off range (inactive slot)
        pos = torch.tensor([s] + [int(x) for x in
                                  np.linspace(100, s - 1, b - 1)],
                           dtype=torch.int32, device=dev)
        args = (q, qc["kq"], qc["k_scale"], qc["vq"], qc["v_scale"], pos)
        got = cuda.kv_decode_attention(*args, bits)
        want = ref.kv_cache_attention(*args, bits)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-4 * float(want.abs().max())
        kd = kv_quant.dequant_k(qc["kq"], qc["k_scale"], bits,
                                torch.bfloat16).transpose(1, 2)
        vd = kv_quant.dequant_v(qc["vq"], qc["v_scale"], bits,
                                torch.bfloat16).transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])[
            :, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec = {"bits": bits, "b": b, "s": s, "h": h, "d": d,
               "max_abs_err": err, "tol": tol, "ok": err <= tol,
               "ms": timer(lambda: cuda.kv_decode_attention(*args, bits)),
               "plain_ms": timer(lambda: ref.kv_cache_attention(*args, bits)),
               "library_ms": timer(lambda: sdpa(q[:, :, None], kd, vd,
                                                 attn_mask=mask))}
        rows = int(torch.clamp(pos, max=s - 1).sum()) + b
        dp = d if bits == 8 else d // 2
        nb = (b * h * d * 2 + rows * h * (2 * dp + 4) + b * h * d * 4
              + b * 4 + b * h * d * 4)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nb, 4.0 * rows * (h * d), F32_OPS_PER_S)
        log(f"  kv_decode_attention int{bits} B={b} S={s} H={h} D={d}: err "
            f"{err:.3g} (tol {tol:.3g}) {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f}, SDPA on dequantized bf16 "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")
        cases.append(rec)
    return cases[0], cases


def check_flash(timer, dev, gen):
    from repro_torch.kernels import cuda, ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for (b, h, hkv, s, d) in ((8, 16, 16, 512, 128), (2, 16, 4, 300, 128)):
        q = torch.randn((b, h, s, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
        # the plain version on the same inputs in float32: in bf16 it rounds
        # the scores to bf16 before the softmax, an error of its own
        qf, kf, vf = q.float(), k.float(), v.float()
        out = cuda.flash_attention(q, k, v, causal=True)
        want = ops.flash_attention(qf, kf, vf, causal=True, impl="ref")
        torch.cuda.synchronize()
        got = out.float()
        err = float((got - want).abs().max())
        tol = 1e-2 * float(want.abs().max())
        # every query row on its own too: late causal rows average hundreds
        # of keys and are far smaller than the first rows, which set max|ref|
        row_err = float((torch.linalg.vector_norm(got - want, dim=-1)
                         / torch.linalg.vector_norm(want, dim=-1)).max())
        # the share of outputs that round to another bf16 than the plain
        # version's: what the next activation fake-quant can see
        off = float((out != want.bfloat16()).float().mean())
        rec = {"b": b, "h": h, "hkv": hkv, "s": s, "d": d,
               "max_abs_err": err, "tol": tol, "max_row_rel_err": row_err,
               "row_tol": 1e-2, "off_bf16_share": off,
               "ok": err <= tol and row_err <= 1e-2,
               "ms": timer(lambda: cuda.flash_attention(q, k, v)),
               "plain_ms": timer(lambda: ops.flash_attention(
                   qf, kf, vf, causal=True, impl="ref")),
               "library_ms": timer(lambda: sdpa(q, k, v, is_causal=True,
                                                 enable_gqa=hkv != h))}
        nb = 2 * (2 * b * h * s * d) + 2 * (2 * b * hkv * s * d)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nb, 4.0 * b * h * d * s * (s + 1) / 2, BF16_OPS_PER_S)
        log(f"  flash_attention B={b} H={h} Hkv={hkv} S={s} D={d} causal: "
            f"err {err:.3g} (tol {tol:.3g}), worst row |d|/|ref| "
            f"{row_err:.3g} (tol 0.01), {off:.3g} of outputs off the plain "
            f"bf16 rounding; {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
        cases.append(rec)
    return cases[0], cases


def check_lsq(timer, dev, gen):
    from repro_torch.kernels import cuda, ref
    x = torch.randn((8 * 512, 2048), generator=gen, device=dev).bfloat16()
    step = torch.tensor(0.7559289, device=dev)
    cases = []
    for bits in (2, 4, 8):
        got = cuda.lsq_fakequant(x, step, bits)
        want = ref.lsq_fakequant(x, step, bits)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        half = 2 ** (bits - 1)
        rec = {"bits": bits, "shape": list(x.shape), "max_abs_err": err,
               "tol": 0.0, "ok": err == 0.0,
               "ms": timer(lambda: cuda.lsq_fakequant(x, step, bits)),
               "plain_ms": timer(lambda: ref.lsq_fakequant(x, step, bits)),
               "library_ms": timer(
                   lambda: torch.fake_quantize_per_tensor_affine(
                       x, float(step), 0, -half, half - 1))}
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4.0 * x.numel(), 6.0 * x.numel(), F32_OPS_PER_S)
        log(f"  lsq_fakequant {bits}-bit {tuple(x.shape)} bf16: err {err} "
            f"(exact) {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
            f"fake_quantize_per_tensor_affine {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
        cases.append(rec)
    return cases[1], cases


# ---------------------------------------------------------------- main path
def make_prompts(cfg, rng):
    lengths = np.linspace(128, 512, 8).astype(np.int32)
    tokens = np.zeros((8, 512), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab, n)
    return tokens, lengths


def device_breakdown(fn, top: int = 10) -> dict:
    """Run ``fn`` once under torch.profiler: host wall ms, the summed device
    time of its kernels (one stream, so they do not overlap), the device's
    idle share of the wall time, and the kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for k, us, n in rows[:top]]}


def log_breakdown(what: str, rec: dict) -> None:
    log(f"    profile {what}: wall {rec['wall_ms']:.2f} ms, device busy "
        f"{rec['device_ms']:.2f} ms, idle share {rec['idle_share']:.3f}")
    for row in rec["top"][:6]:
        log(f"      {row['ms']:9.3f} ms  x{row['count']:<5d} {row['kernel']}")


def phase_serve(cfg, packed, pa, dev, tokens, lengths):
    from repro_torch.kernels import cuda
    from repro_torch.serve import EngineSpec, ServeEngine, kv_cache
    runs = {}
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    for bits in (8, 4):
        engine = ServeEngine(cfg, packed, pa, max_seq=1024,
                             spec=EngineSpec(cache="quantized",
                                             cache_bits=bits), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        t0 = time.perf_counter()
        out = engine.generate(tok_t, 64, lengths=lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if tuple(out.shape) != (8, 64) or out.dtype != torch.int32:
            raise RuntimeError(f"generate returned {tuple(out.shape)} "
                               f"{out.dtype}")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
            raise RuntimeError("generated token ids out of the vocabulary")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise RuntimeError(f"main path launched no {missing}")
        # the breakdown: one prefill, then the decode steps, timed apart
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, pre = engine.prefill(tok_t, len_t)
        cache = kv_cache.splice_prefill(engine.new_cache(8), pre, len_t)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = last.argmax(-1, keepdim=True)
        cuda.reset_launches()
        cache, _ = engine.decode_step(cache, tok)
        per_step = dict(cuda.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, tok, _ = engine.decode_chunk_step(cache, tok, n_steps=62)
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / 62
        cuda.reset_launches()
        engine.prefill(tok_t, len_t)
        per_prefill = dict(cuda.LAUNCHES)
        prof = {"prefill": device_breakdown(
                    lambda: engine.prefill(tok_t, len_t)),
                "decode_8_steps": device_breakdown(
                    lambda: engine.decode_chunk_step(cache, tok, n_steps=8))}
        wb = engine.weight_bytes()
        rec = {"cache_bits": bits, "generate_s": wall,
               "tokens_per_s": 8 * 64 / wall, "prefill_ms": prefill_s * 1e3,
               "decode_ms_per_step": decode_s * 1e3,
               "launches": launches, "launches_per_prefill": per_prefill,
               "launches_per_decode_step": per_step,
               "weight_bytes_packed": wb["packed"],
               "weight_bytes_bf16": wb["bf16"],
               "kv_bytes": kv_cache.cache_bytes(cache),
               "max_memory_allocated": peak, "profile": prof,
               "first_tokens": out[:, :8].tolist()}
        log(f"  serve int{bits} cache: generate 8x64 in {wall:.3f} s "
            f"({rec['tokens_per_s']:.1f} tok/s), prefill "
            f"{rec['prefill_ms']:.1f} ms, decode {rec['decode_ms_per_step']:.2f}"
            f" ms/step, weights {wb['packed'] / 1e6:.1f} MB packed vs "
            f"{wb['bf16'] / 1e6:.1f} MB bf16, KV {rec['kv_bytes'] / 1e6:.1f}"
            f" MB, peak {peak / 1e9:.2f} GB")
        log(f"    launches in generate: {launches}")
        log(f"    per prefill: {per_prefill}; per decode step: {per_step}")
        for what, brk in prof.items():
            log_breakdown(what, brk)
        runs[bits] = rec
        # free this run's cache before the next run's peak is taken
        del engine, cache, out, last, pre, tok
    return runs


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def rel_rms_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` is ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def attention_f64(q, k, v, chunk, causal, scale=None):
    """The plain prefill attention (``chunked_attention``'s arguments: q, k,
    v (B, S, H, D) at the query head count) in float64, in one piece: as
    exact as the float32 plain version, and rounded otherwise."""
    s, d = q.shape[1], q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) * (
        d ** -0.5 if scale is None else scale)
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.double()).to(q.dtype)


def shadowed(block_apply, errs: list):
    """``block_apply`` that also runs the plain version of each block
    (impl="ref") on the same input and a copy of the same cache, and
    appends the relative RMS and max-abs errors of the block's output."""
    def both(p, x, bits, cfg, mode, cache, positions, impl="auto"):
        copy = None if cache is None else {k: v.clone()
                                           for k, v in cache.items()}
        want, _ = block_apply(p, x, bits, cfg, mode, copy, positions, "ref")
        got, new = block_apply(p, x, bits, cfg, mode, cache, positions, impl)
        errs.append((rel_rms_err(got, want), rel_err(got, want)))
        return got, new
    return both


def teacher_forced(cfg, packed, pa, dev, tok_t, len_t, bits, n_decode):
    """The kernel path, the plain path (impl="ref") and the control - the
    plain path with its prefill attention in float64 - on the same weights
    and cache kind, all fed the kernel path's greedy tokens over the prefill
    and ``n_decode`` decode steps.  The kernel path runs through the
    engine's own loop, each of its blocks shadowed by the plain block.
    Returns each path's logits per step and the block errors, steps by
    blocks."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.serve import EngineSpec, ServeEngine, kv_cache
    spec = EngineSpec(cache="quantized", cache_bits=bits)
    engines = {name: ServeEngine(cfg, packed, pa, 1024, spec, device=dev,
                                 impl=impl)
               for name, impl in (("kernel", "auto"), ("plain", "ref"),
                                  ("control", "ref"))}
    errs, blocks = [], []
    swaps = {"kernel": (tf, "block_apply", shadowed(tf.block_apply, errs)),
             "control": (attn, "chunked_attention", attention_f64)}

    def run(name, fn, *args):
        swap = swaps.get(name)
        with patched(*swap) if swap else contextlib.nullcontext():
            return fn(*args)

    b = tok_t.shape[0]
    logits, caches = {}, {}
    for name, eng in engines.items():
        last, pre = run(name, eng.prefill, tok_t, len_t)
        caches[name] = kv_cache.splice_prefill(eng.new_cache(b), pre, len_t)
        logits[name] = [last]
    for step in range(n_decode + 1):
        blocks.append(errs[:])
        errs.clear()
        if not bool(torch.isfinite(logits["kernel"][-1]).all()):
            raise RuntimeError(f"non-finite logits at step {step}")
        if step == n_decode:
            return logits, blocks
        tok = logits["kernel"][-1].argmax(-1, keepdim=True)
        for name, eng in engines.items():
            caches[name], last = run(name, eng.decode_step, caches[name], tok)
            logits[name].append(last)


def phase_check(cfg, packed, pa, dev, tokens, lengths, n_decode=16):
    """Kernel path against the plain path (impl="ref") on the same weights,
    teacher-forced over the prefill and 16 decode steps, with three
    readings:

      all blocks - max|dlogit|/max|logit| over the steps, bounded by
        CONTROL_FACTOR times the control's: the plain path with its prefill
        attention in float64 against the plain path.  Each projection's
        activation fake-quant turns an output that rounds to another bf16
        into a whole code step, and the blocks that follow amplify it: two
        exact attentions that round apart already drift far apart over 16
        blocks of this random model (PERF.md), so a fixed bound below their
        drift cannot hold for any kernel;
      the first block alone - bounded by ONE_BLOCK_BOUND: nothing to
        amplify, and the projections are exact in any summation order;
      each block's own output - the plain block takes the kernel block's
        input and cache (``shadowed``); RMS bounded by BLOCK_RMS_BOUND, as
        one flipped code moves one token's row by one code step.
    """
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    one = cfg.replace(n_repeats=1)
    one_block = dict(packed, pat=packed["pat"][:1])
    res, bad = {}, {}
    for bits in (8, 4):
        logits, blocks = teacher_forced(cfg, packed, pa, dev, tok_t, len_t,
                                        bits, n_decode)
        first, _ = teacher_forced(one, one_block, pa, dev, tok_t, len_t,
                                  bits, n_decode)
        ker, plain, ctl = logits["kernel"], logits["plain"], logits["control"]
        rec = {
            "rel_logit_err": [rel_err(a, b) for a, b in zip(ker, plain)],
            "rel_rms_logit_err": [rel_rms_err(a, b)
                                  for a, b in zip(ker, plain)],
            "control_rel_logit_err": [rel_err(a, b)
                                      for a, b in zip(ctl, plain)],
            "control_rel_rms_logit_err": [rel_rms_err(a, b)
                                          for a, b in zip(ctl, plain)],
            "kernel_vs_control_rel_logit_err": [rel_err(a, b)
                                                for a, b in zip(ker, ctl)],
            "top1_agreement": float(np.mean(
                [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                 for a, b in zip(ker, plain)])),
            "one_block_rel_logit_err": [
                rel_err(a, b) for a, b in zip(first["kernel"],
                                              first["plain"])],
            "block_rel_rms_err": [[e[0] for e in row] for row in blocks],
            "block_rel_abs_err": [[e[1] for e in row] for row in blocks]}
        res[bits] = rec
        worst = {k: max(v) for k, v in rec.items()
                 if k.endswith("logit_err")}
        worst_block = max(max(row) for row in rec["block_rel_rms_err"])
        per_block = [max(c) for c in zip(*rec["block_rel_rms_err"])]
        e2e_bound = CONTROL_FACTOR * worst["control_rel_logit_err"]
        log(f"  check int{bits}: {cfg.n_repeats} blocks: max|dlogit|/"
            f"max|logit| {worst['rel_logit_err']:.4g} (bound "
            f"{CONTROL_FACTOR} x control = {e2e_bound:.4g}), "
            f"RMS {worst['rel_rms_logit_err']:.4g}, top-1 agreement "
            f"{rec['top1_agreement']:.3f}; per step "
            f"{' '.join(f'{e:.2g}' for e in rec['rel_logit_err'])}")
        log(f"    control (float64 prefill attention vs plain): "
            f"{worst['control_rel_logit_err']:.4g}, RMS "
            f"{worst['control_rel_rms_logit_err']:.4g}; kernel vs control "
            f"{worst['kernel_vs_control_rel_logit_err']:.4g}; per step "
            f"{' '.join(f'{e:.2g}' for e in rec['control_rel_logit_err'])}")
        log(f"    first block alone: {worst['one_block_rel_logit_err']:.4g}"
            f" (bound {ONE_BLOCK_BOUND})")
        log(f"    each block's own output, RMS |d|/|ref|: at most "
            f"{worst_block:.4g} (bound {BLOCK_RMS_BOUND}); per block "
            f"{' '.join(f'{e:.2g}' for e in per_block)}")
        for name, err, bound in (
                ("all blocks", worst["rel_logit_err"], e2e_bound),
                ("first block", worst["one_block_rel_logit_err"],
                 ONE_BLOCK_BOUND),
                ("block outputs", worst_block, BLOCK_RMS_BOUND)):
            if not err <= bound:
                bad[f"int{bits} {name}"] = (err, bound)
    if bad:
        raise RuntimeError(f"kernel path vs plain path over the bound: "
                           f"{bad}")
    return res


def main():
    smi_line = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import olmo_1b
    from repro_torch.core import knapsack
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    from repro_torch.serve import pack_params

    build_s = phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    timer = Timer(dev)
    log("kernels:")
    checks = {"quant_matmul": check_quant_matmul(timer, dev, gen),
              "kv_decode_attention": check_kv_decode(timer, dev, gen),
              "flash_attention": check_flash(timer, dev, gen),
              "lsq_fakequant": check_lsq(timer, dev, gen)}
    bad = [(name, c) for name, (_, cases) in checks.items() for c in cases
           if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    del timer
    torch.cuda.empty_cache()

    cfg = olmo_1b.config()
    log(f"serve: {cfg.name} d_model={cfg.d_model} layers={cfg.n_repeats} "
        f"heads={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab}")
    t0 = time.perf_counter()
    raw = tf.init_params(cfg, seed=0, device=dev)
    policy = tf.build_policy(cfg)
    sel = knapsack.select_for_budget(policy, knapsack.synthetic_gains(policy),
                                     budget_frac=0.7)
    mixed = policy.apply_selection(sel.take)
    pa = mixed.as_arrays()
    n4 = sum(mixed.bits_of(u.name) == 4.0 for u in policy.selectable_units())
    n2 = sum(mixed.bits_of(u.name) == 2.0 for u in policy.selectable_units())
    packed = pack_params(raw, pa, cfg, device=dev)
    del raw
    torch.cuda.synchronize()
    log(f"  knapsack at budget 0.7: {n4} units at 4 bits, {n2} at 2 bits; "
        f"init + pack {time.perf_counter() - t0:.1f} s")
    if not (n4 and n2):
        raise RuntimeError("the knapsack did not select a 4/2 mix")
    tokens, lengths = make_prompts(cfg, np.random.default_rng(0))
    runs = phase_serve(cfg, packed, pa, dev, tokens, lengths)
    log("check (kernel path vs plain path):")
    check = phase_check(cfg, packed, pa, dev, tokens, lengths)

    kernels = []
    for name, (head, _) in checks.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CUDA_SOURCES[name],
            "replaces": TPU_SOURCES[name],
            "launches": runs[8]["launches"][name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"]})
    OUT.mkdir(exist_ok=True)
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"device": smi_line, "build_s": build_s,
                   "kernels": {k: cases for k, (_, cases) in checks.items()},
                   "serve": runs, "check": check,
                   "launch_counts_after": dict(cuda.LAUNCHES)}, f, indent=1)
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
