#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi); no card fails.
  2. build   - nvcc builds the kernels from src/repro_torch/csrc into
               build/kernels/ (parallel, one process per source).
  3. kernels - each of the seven kernels against its plain PyTorch version at
               the main path's shapes, with its tolerance, kernel / plain /
               library times (CUDA events, warm-up excluded, L2 flushed) and
               bound; the decode GEMV's shapes also in device time alone
               (torch.profiler) beside cuBLAS's, both decode attentions
               beside SDPA's, lsq_fakequant (one step and q/k/v's three)
               beside fake_quantize_per_tensor_affine, its backward (the
               train step's shapes; gx bit for bit, the step gradients
               within 1e-5 of their terms' scale) beside PyTorch's
               learnable LSQ, and the histogram
               beside torch.bincount; the paged decode also bit for bit
               against the contiguous kernel on the gathered cache, and the
               probes of quant_matmul (identity, and the GEMV's selector and
               repeat), decode attention (selector in both layouts, and
               repeat), flash_attention (selector, also with the queries
               cut to their last rows; and the suffix prefill's Sk > Sq
               shapes beside SDPA with a bottom-right mask), lsq_fakequant (NaN,
               +-inf, ties, clamp edges, ragged lengths) and the histogram
               (repeat, one device op a call) bit for bit.
  select     - EAGL gains of olmo-1b at full width, weights drawn on the
               card from seed 0, through the histogram kernel and through
               impl="ref" (the same knapsack take), and the 4/2 mix the
               knapsack takes from them at budget 0.7.
  4. serve   - that mix packed, 8 prompts of 128-512 tokens right-padded to
               512, 64 new tokens, max_seq 1024, over an int8 and an int4
               KV cache, contiguous and paged (page 16; the same tokens);
               counts every kernel's launches (lsq_fakequant: 4 a layer
               and the head's, per prefill and per decode step); a
               torch.profiler breakdown of one prefill and 8 decode steps.
  schedule   - the continuous-batching scheduler over that mix: 24
               requests (12 sharing a 256-token system prompt, 4 repeats, 8
               unique; 8-32 new tokens) through 8 slots, paged full bf16,
               paged int8 and contiguous int4, pools of 160 pages; gates A
               (equal to a serial run), B (sharing on against off), D
               (allocator, hits, deferrals, pages) and the device-to-host
               copies (see phase_schedule).
  5. check   - kernel path against the plain path (impl="ref") on the same
               weights, teacher-forced with the kernel path's tokens over
               the prefill and 16 decode steps, beside a control: the plain
               path with its prefill attention in float64 (see phase_check).
  train      - 4-bit LSQ QAT of olmo-1b at full width and depth (seed 0,
               bf16), AdamW, 16 steps of 8 x 512 synthetic tokens: every
               fake-quant through the lsq_fakequant forward and backward
               kernels; step 1's loss and gradients against impl="ref",
               the loss falling, the launches a step, no forward-only
               kernel (see phase_train).
  alps       - ALPS over the 64 selectable units from the trained state,
               EAGL on the same weights, both knapsack takes (phase_alps).
  hawq       - HAWQ-v3 over the same units from the same state: 8
               Hutchinson probes, each a torch.func jvp of grad; its wall
               seconds beside ALPS's and EAGL's (phase_hawq).
  frontier   - the frontier sweep: EAGL, ALPS, HAWQ-v3, uniform and the
               two greedy baselines at budgets 0.9, 0.75 and 0.6, each
               point fine-tuned 4 steps from the b_hi state and evaluated
               on 2 held-out batches; the joint weight-and-cache knapsack's
               take (phase_frontier).
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
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))
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
    "histogram": "src/repro/kernels/entropy_hist.py:37",
    "paged_kv_decode_attention": "src/repro/kernels/flash_attention.py:237",
    # no Pallas kernel: the reference's custom VJP, which XLA fuses
    "lsq_fakequant_bwd": "src/repro/core/quant.py:77",
}
PAGE = 16                        # the paged serve runs' page size


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


def host_us(fn, n: int = 100) -> float:
    """Host microseconds to enqueue one call: the device is synchronized
    before and after, and only the loop of n calls is timed.  The Timer's
    window also holds the part of this that outlasts its L2 flush."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


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
def qmm_case(timer, dev, gen, bits, m, k, n, wp=None, x=None):
    """One quant_matmul shape against its plain version (1 bf16 ulp of
    max|ref|), timed beside cuBLAS bf16 on the dequantized weight.  A GEMV
    shape (M <= 16) is also read in device time alone (``device_us``)."""
    from repro_torch.kernels import cuda, ref
    unpack = ref.unpack_w4 if bits == 4 else ref.unpack_w2
    if wp is None:
        lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
        codes = torch.randint(lo, hi, (k, n), generator=gen, device=dev)
        wp = (ref.pack_w4 if bits == 4 else ref.pack_w2)(codes)
    if x is None:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    got = cuda.quant_matmul(x, wp, scale, bits).float()
    plain = ref.quant_matmul_w4 if bits == 4 else ref.quant_matmul_w2
    want = plain(x, wp, scale)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = bf16_ulp(float(want.abs().max()))
    w_bf16 = (unpack(wp, torch.float32) * scale[None]).to(torch.bfloat16)
    rec = {"bits": bits, "m": m, "k": k, "n": n, "max_abs_err": err,
           "tol": tol, "ok": err <= tol,
           "ms": timer(lambda: cuda.quant_matmul(x, wp, scale, bits)),
           "plain_ms": timer(lambda: plain(x, wp, scale)),
           "library_ms": timer(lambda: torch.matmul(x, w_bf16))}
    nb = m * k * 2 + wp.numel() + n * 4 + m * n * 2
    flop = 2.0 * m * n * k
    rec["bound_ms"], rec["bound_by"] = bound_ms(nb, flop, BF16_OPS_PER_S)
    rate = ""
    rec["route"] = cuda.quant_matmul_route(m, n, k)
    if rec["route"] != "gemv":
        rec["tflops"] = flop / rec["ms"] * 1e-9
        rec["x_cublas"] = rec["ms"] / rec["library_ms"]
        rate = (f", {rec['tflops']:.1f} TFLOP/s, {rec['x_cublas']:.2f}x "
                f"cuBLAS")
    log(f"  quant_matmul {rec['route']} w{bits} M={m} K={k} N={n}: err "
        f"{err:.3g} (tol {tol:.3g}, 1 bf16 ulp of max|ref|) "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, cuBLAS bf16 "
        f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}){rate}")
    if rec["route"] == "gemv":
        rec["plan"] = list(cuda.gemv_plan(m, n, k, bits))
        rec["device_us"], rec["device_kernels"] = device_us(
            timer, lambda: cuda.quant_matmul(x, wp, scale, bits))
        # the same kernel on a plan of two blocks an SM, for comparison
        with patched(cuda, "GEMV_TARGET_BLOCKS", 2 * 132):
            rec["plan_two_per_sm"] = list(cuda.gemv_plan(m, n, k, bits))
            rec["device_us_two_per_sm"], _ = device_us(
                timer, lambda: cuda.quant_matmul(x, wp, scale, bits))
        rec["library_device_us"], rec["library_kernels"] = device_us(
            timer, lambda: torch.matmul(x, w_bf16))
        rec["bound_us"] = rec["bound_ms"] * 1e3
        rec["x_bound_device"] = rec["device_us"] / rec["bound_us"]
        rec["x_cublas_device"] = rec["device_us"] / rec["library_device_us"]
        log(f"    device time alone (torch.profiler, L2 flushed): "
            f"{rec['device_us']:.2f} us, {rec['x_bound_device']:.2f}x the "
            f"bound ({rec['bound_us']:.2f} us), cuBLAS bf16 "
            f"{rec['library_device_us']:.2f} us ({rec['x_cublas_device']:.2f}"
            f"x); plan {rec['plan'][0]} K slices of {rec['plan'][1]} steps;"
            f" on {rec['plan_two_per_sm'][0]} slices (two blocks an SM) "
            f"{rec['device_us_two_per_sm']:.2f} us")
    return rec, got, want


def device_us(timer, fn, iters: int = 30):
    """Device microseconds of one call of ``fn`` with the L2 cold:
    torch.profiler over ``iters`` calls, each after the Timer's flush; a
    call's time is the summed duration of its kernels, every kernel but
    the flush's own, which a profile of the flush alone names.  Returns
    (the median over the calls, {kernel: launches a call})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):  # a profile that recorded no flush is taken again,
        # and so is the flush's own, which may have recorded no kernel
        flush = set(device_rows(timer.flush_buf.zero_))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                timer.flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        calls, names = [], {}
        for e in sorted((e for e in prof.events() if e.device_type
                         == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            if e.key in flush:  # a flush opens the next call
                calls.append(0.0)
            elif calls:
                calls[-1] += e.time_range.elapsed_us()
                names[e.key[:90]] = names.get(e.key[:90], 0) + 1
        if calls:
            return (float(np.median(calls)),
                    {k: n / len(calls) for k, n in names.items()})
    raise RuntimeError("device_us: the profiles recorded no flush kernel")


def gemv_selector_probe(dev, bits, m):
    """The GEMV route's probe: K = N = 256, the packed bytes cycling through
    all 256 values in every row, x of M one-hot rows; call c puts row r's 1
    at K position c M + r, so ceil(K / M) calls place a 1 at every K
    position.
    Each output is one code times its scale, rounded once to bf16, so the
    calls must equal codes x scale bit for bit: a wrong lane byte, bit
    offset, channel permutation, x staging order or slice breaks it."""
    from repro_torch.kernels import cuda, ref
    k = n = 256
    r = torch.arange(k // (8 // bits), device=dev)[:, None]
    wp = ((r + torch.arange(n, device=dev)[None, :]) % 256).to(torch.uint8)
    scale = torch.rand((n,), generator=torch.Generator(dev).manual_seed(3),
                       device=dev) + 0.5
    rows, got = torch.arange(m, device=dev), []
    for c in range(-(-k // m)):  # the last call's rows past K stay 0
        pos = c * m + rows
        x = torch.zeros((m, k), device=dev, dtype=torch.bfloat16)
        x[rows[pos < k], pos[pos < k]] = 1.0
        got.append(cuda.quant_matmul(x, wp, scale, bits)[pos < k])
    unpack = ref.unpack_w4 if bits == 4 else ref.unpack_w2
    want = (unpack(wp, torch.float32) * scale[None]).to(torch.bfloat16)
    return bool(torch.equal(torch.cat(got), want))


def gemv_repeat(dev, gen, bits, m=8, k=8192, n=2048):
    """Two calls on the same inputs through a split-K plan: equal bit for
    bit (the slices add in a fixed order; no floating-point atomics)."""
    from repro_torch.kernels import cuda, ref
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    codes = torch.randint(lo, hi, (k, n), generator=gen, device=dev)
    wp = (ref.pack_w4 if bits == 4 else ref.pack_w2)(codes)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    first = cuda.quant_matmul(x, wp, scale, bits)
    return cuda.gemv_plan(m, n, k, bits), bool(torch.equal(
        first, cuda.quant_matmul(x, wp, scale, bits)))


def identity_probe(timer, dev, gen, bits):
    """x = the K x K identity (M = K = 256), the packed bytes cycling
    through all 256 values in every row: each output is one code times its
    scale, so the kernel must equal the plain version bit for bit.  It
    pins every lane's byte and bit offset and every swizzled row."""
    k = n = 256
    r = torch.arange(k // (8 // bits), device=dev)[:, None]
    wp = ((r + torch.arange(n, device=dev)[None, :]) % 256).to(torch.uint8)
    x = torch.eye(k, device=dev, dtype=torch.bfloat16)
    rec, got, want = qmm_case(timer, dev, gen, bits, k, k, n, wp=wp, x=x)
    rec["identity_probe"] = True
    rec["bit_equal"] = bool(torch.equal(got.bfloat16(), want.bfloat16()))
    rec["ok"] = rec["ok"] and rec["bit_equal"]
    log(f"    identity probe w{bits}: equal to codes x scale bit for bit: "
        f"{rec['bit_equal']}")
    return rec


def check_quant_matmul(timer, dev, gen):
    """The main path's twelve shapes (bits 4 and 2, the three projection
    shapes of olmo-1b, decode M = 8 and prefill M = 4096), the identity
    probe, and ragged tiled shapes: M = 4099 (a ragged M through the wgmma
    route), and M = 129 with N = 200 and K = 520 (ragged M, N and a partial
    last K step; N % 16 != 0 takes the mma.sync route).  Then the GEMV
    route's selector probe at M = 16 and 8 and its repeat check."""
    cases = []
    for bits in (4, 2):
        for (k, n) in ((2048, 2048), (2048, 8192), (8192, 2048)):
            for m in (8, 8 * 512):
                cases.append(qmm_case(timer, dev, gen, bits, m, k, n)[0])
    for bits in (4, 2):
        cases.append(identity_probe(timer, dev, gen, bits))
        for (m, k, n) in ((4099, 2048, 2048), (129, 520, 200)):
            cases.append(qmm_case(timer, dev, gen, bits, m, k, n)[0])
    for bits in (4, 2):
        for m in (16, 8):
            same = gemv_selector_probe(dev, bits, m)
            cases.append({"gemv_selector_probe": True, "bits": bits, "m": m,
                          "k": 256, "n": 256, "bit_equal": same, "ok": same})
            log(f"    GEMV selector probe w{bits} M={m}: every K position "
                f"one-hot, outputs equal codes x scale bit for bit: {same}")
        plan, same = gemv_repeat(dev, gen, bits)
        cases.append({"gemv_repeat": True, "bits": bits, "m": 8, "k": 8192,
                      "n": 2048, "plan": list(plan), "bit_equal": same,
                      "ok": same})
        log(f"    GEMV repeat w{bits} M=8 K=8192 N=2048 ({plan[0]} K "
            f"slices): two calls equal bit for bit: {same}")
    # headline: the decode gate/up projection at int4
    head = next(c for c in cases if (c["bits"], c["m"], c["k"], c["n"])
                == (4, 8, 2048, 8192))
    return head, cases


def alone_device(timer, rec, fn, library):
    """A kernel's device time alone (``device_us``) beside the library
    call's, and its ratios to the bound and the library call."""
    rec["device_us"], rec["device_kernels"] = device_us(timer, fn)
    rec["library_device_us"], rec["library_kernels"] = device_us(timer,
                                                                 library)
    rec["bound_us"] = rec["bound_ms"] * 1e3
    rec["x_bound_device"] = rec["device_us"] / rec["bound_us"]
    rec["x_library_device"] = rec["device_us"] / rec["library_device_us"]


def log_alone(rec, library: str) -> None:
    log(f"    device time alone (torch.profiler, L2 flushed): "
        f"{rec['device_us']:.2f} us, {rec['x_bound_device']:.2f}x the bound "
        f"({rec['bound_us']:.2f} us), {library} "
        f"{rec['library_device_us']:.2f} us ({rec['x_library_device']:.2f}x);"
        f" device ops a call: {rec['device_kernels']}")


KV_PROBE_SCORE = 200.0          # the selected logit of the decode probe


def kv_decode_selector_probe(dev, bits, layout, b=4, h=16, hkv=16, s=1024,
                             d=128, page=PAGE, impl="cuda"):
    """Decode attention's selector probe.  Each (slot, query head) selects
    one cache row: q is one-hot at a channel of its own within its KV head,
    that channel of K is 0 on every row but the selected one, where its
    logit is about KV_PROBE_SCORE; every other logit is exactly 0, whose
    weight exp(-200) underflows to 0 in float32.  V row r holds codes
    cycling with r and the scale 1 + r / 1024, so the output must be the
    selected row's codes times its scale bit for bit.  The selected rows
    are the first, middle and last row of every chunk of the plan, and the
    last row; each slot's position is its largest selected row, slot 0's
    past the end.  ``layout`` "contiguous" or "paged" (shuffled pages,
    stale and -1 entries past a slot's last page); ``impl`` "cuda" (the
    kernels) or "ref" (the plain versions).  Returns (calls, splits, C,
    every call equal)."""
    from repro_torch.kernels import cuda, kv_quant, ref
    g = torch.Generator(dev).manual_seed(7)
    group, dp = h // hkv, (d if bits == 8 else d // 2)
    splits, c = cuda.decode_plan(b, hkv, group, s, bits)
    targets = sorted({min(r, s - 1) for k in range(splits)
                      for r in (k * c, k * c + c // 2, k * c + c - 1)}
                     | {s - 1})
    top = 127 if bits == 8 else 7
    rows = torch.arange(s, device=dev)[:, None, None]
    chans = torch.arange(d, device=dev)
    v_codes = ((rows * 37 + chans * 11 + torch.arange(hkv, device=dev)[
        :, None] * 5) % (2 * top + 1) - top).expand(b, s, hkv, d)
    v_scale = (1.0 + torch.arange(s, device=dev, dtype=torch.float32)
               / 1024)[None, :, None].expand(b, s, hkv).contiguous()
    pack = (lambda x: x.to(torch.int8)) if bits == 8 else kv_quant.pack4
    vq = pack(v_codes.contiguous())
    k_scale = torch.rand((b, hkv, d), generator=g, device=dev) + 0.5
    heads = torch.arange(h, device=dev)[None].expand(b, h)
    bi = torch.arange(b, device=dev)[:, None].expand(b, h)
    hk_of, chan_of = heads // group, heads % d  # each query head's channel
    per_call = b * h
    calls = -(-len(targets) // per_call)
    order = torch.tensor(targets, device=dev)
    ok = True
    for call in range(calls):
        pick = torch.arange(call * per_call, (call + 1) * per_call,
                            device=dev) % len(targets)
        sel = order[pick].reshape(b, h)
        pos = sel.amax(dim=1).to(torch.int32)
        pos[0] = s
        k_codes = torch.randint(-top, top + 1, (b, s, hkv, d), generator=g,
                                device=dev)
        k_codes[bi, :, hk_of, chan_of] = 0
        k_codes[bi, sel, hk_of, chan_of] = top
        kq = pack(k_codes)
        q = torch.zeros((b, h, d), device=dev)
        q[bi, heads, chan_of] = KV_PROBE_SCORE * math.sqrt(d) / (
            top * k_scale[bi, hk_of, chan_of])
        q = q.to(torch.bfloat16)
        want = (v_codes[bi, sel, hk_of].float()
                * v_scale[bi, sel, hk_of][..., None])
        if layout == "contiguous":
            args = (q, kq, k_scale, vq, v_scale, pos)
            fn = (cuda.kv_decode_attention if impl == "cuda"
                  else ref.kv_cache_attention)
        else:
            n = s // page
            p = b * n + 8
            perm = torch.randperm(p, generator=g, device=dev)
            tbl = torch.full((b, n), -1, dtype=torch.int32, device=dev)
            pools = [torch.zeros((p, page, hkv, dp), dtype=kq.dtype,
                                 device=dev) for _ in range(2)]
            pools.append(torch.full((p, page, hkv), float("nan"),
                                    device=dev))
            for i in range(b):
                npg = min(int(pos[i]), s - 1) // page + 1
                ids = perm[i * n:i * n + npg]
                tbl[i, :npg] = ids.to(torch.int32)
                if npg < n:  # a stale entry past the slot's last page
                    tbl[i, npg] = int(perm[-1])
                for pool, src in zip(pools, (kq, vq, v_scale)):
                    pool[ids] = src[i, :npg * page].reshape(
                        (npg, page) + tuple(src.shape[2:]))
            args = (q, pools[0], k_scale, pools[1], pools[2], tbl, pos)
            fn = (cuda.paged_kv_decode_attention if impl == "cuda"
                  else ref.paged_kv_cache_attention)
        ok = ok and bool(torch.equal(fn(*args, bits), want))
    return calls, splits, c, ok


def check_kv_decode(timer, dev, gen):
    """The contiguous decode at B = 8, S = 1024, H = Hkv = 16, D = 128, one
    slot past the end and the others spread over the cache, int8 and int4:
    within 1e-4 * max|ref| of the plain version, timed on the timer and in
    device time alone beside SDPA on the dequantized bf16 cache, and on
    plans of other chunk sizes; two calls equal bit for bit; then the
    selector probe, bit for bit, at MHA and GQA 16/4."""
    from repro_torch.kernels import cuda, kv_quant, ref
    b, s, h, d = 8, 1024, 16, 128
    hkv = h
    cases = []
    for bits in (8, 4):
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev)
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
        again = cuda.kv_decode_attention(*args, bits)
        want = ref.kv_cache_attention(*args, bits)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-4 * float(want.abs().max())
        repeat = bool(torch.equal(got, again))
        kd = kv_quant.dequant_k(qc["kq"], qc["k_scale"], bits,
                                torch.bfloat16).transpose(1, 2)
        vd = kv_quant.dequant_v(qc["vq"], qc["v_scale"], bits,
                                torch.bfloat16).transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])[
            :, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def library():
            return sdpa(q[:, :, None], kd, vd, attn_mask=mask)

        rec = {"bits": bits, "b": b, "s": s, "h": h, "hkv": hkv, "d": d,
               "plan": list(cuda.decode_plan(b, hkv, h // hkv, s, bits)),
               "max_abs_err": err, "tol": tol, "repeat_bit_equal": repeat,
               "ok": err <= tol and repeat,
               "ms": timer(lambda: cuda.kv_decode_attention(*args, bits)),
               "plain_ms": timer(lambda: ref.kv_cache_attention(*args, bits)),
               "library_ms": timer(library)}
        rows = int(torch.clamp(pos, max=s - 1).sum()) + b
        dp = d if bits == 8 else d // 2
        nb = (b * h * d * 2 + rows * hkv * (2 * dp + 4) + b * hkv * d * 4
              + b * 4 + b * h * d * 4)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nb, 4.0 * rows * (h * d), F32_OPS_PER_S)
        alone_device(timer, rec,
                     lambda: cuda.kv_decode_attention(*args, bits), library)
        # the same kernel on plans of other chunk sizes, for comparison
        rec["device_us_by_chunk"] = {}
        for rows_cap in (64, 256):
            with patched(cuda, "DECODE_CHUNK_ROWS", rows_cap):
                c = cuda.decode_plan(b, hkv, h // hkv, s, bits)[1]
                rec["device_us_by_chunk"][c], _ = device_us(
                    timer, lambda: cuda.kv_decode_attention(*args, bits))
        log(f"  kv_decode_attention int{bits} B={b} S={s} H={h} D={d}: err "
            f"{err:.3g} (tol {tol:.3g}), two calls equal: {repeat}; "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, SDPA on "
            f"dequantized bf16 {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
        log(f"    device time alone: {rec['device_us']:.2f} us, "
            f"{rec['x_bound_device']:.2f}x the bound ({rec['bound_us']:.2f} "
            f"us), SDPA {rec['library_device_us']:.2f} us "
            f"({rec['x_library_device']:.2f}x); plan {rec['plan'][0]} splits of "
            f"{rec['plan'][1]} rows; other chunks: " + ", ".join(
                f"C={c} {us:.2f} us"
                for c, us in rec["device_us_by_chunk"].items()))
        cases.append(rec)
        del k, v, qc, kd, vd, args
    for bits in (8, 4):
        for hkv in (16, 4):
            calls, splits, c, same = kv_decode_selector_probe(
                dev, bits, "contiguous", hkv=hkv)
            cases.append({"kv_decode_selector_probe": True, "bits": bits,
                          "layout": "contiguous", "h": 16, "hkv": hkv,
                          "s": 1024, "plan": [splits, c], "calls": calls,
                          "bit_equal": same, "ok": same})
            log(f"    selector probe int{bits} Hkv={hkv}: rows in every one "
                f"of {splits} chunks of {c}, {calls} call(s), outputs equal "
                f"the selected V rows bit for bit: {same}")
    return cases[0], cases


FLASH_DESIGN = "B: wgmma + TMA, warp-specialised, 2-stage mbarrier ring"
PROBE_SCORE = 200.0              # the selected score of the flash probe


def flash_selector_probe(dev, b, h, hkv, s, d=128, seed=0, causal=True):
    """Inputs of the flash selector probe: n = min(S, d) keys are one-hot,
    k at position pos(m) = c e_m for m < n, every other key 0; q_i = c
    e_pi(i) with pi(i) < n, drawn anew for every (batch, head);
    c * c * d**-0.5 is about PROBE_SCORE.  Every other score of row i is 0,
    200 below the selected one, so its exponential underflows to exactly 0
    in float32 and output row i is V[pos(pi(i))] bit for bit.  Causal:
    pos(m) = m and pi(i) <= i.  Not causal: the keys lie at positions drawn
    anew for every (batch, kv head), the last position always among them,
    so every kv tile, the ragged last one too, holds selected keys.
    Returns q, k, v ((B, H|Hkv, S, D) bf16) and that expected output."""
    c = math.sqrt(PROBE_SCORE * math.sqrt(d))
    g = torch.Generator(dev).manual_seed(seed)
    n = min(s, d)
    if causal:
        rows = torch.arange(s, device=dev)
        pi = torch.randint(0, 1 << 30, (b, h, s), generator=g,
                           device=dev) % (torch.clamp(rows, max=d - 1) + 1)
        pos = torch.arange(n, device=dev).expand(b, hkv, n)
    else:
        r = torch.rand((b, hkv, s), generator=g, device=dev)
        r[..., s - 1] = -1.0
        pos = r.argsort(dim=-1)[..., :n]
        pi = torch.randint(0, n, (b, h, s), generator=g, device=dev)
    q = torch.zeros((b, h, s, d), device=dev).scatter_(-1, pi[..., None], c)
    one_hot = torch.zeros((n, d), device=dev)
    one_hot[torch.arange(n), torch.arange(n)] = c
    k = torch.zeros((b, hkv, s, d), device=dev).scatter_(
        2, pos[..., None].expand(b, hkv, n, d), one_hot.expand(b, hkv, n, d))
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    group = h // hkv
    sel = torch.gather(pos.repeat_interleave(group, dim=1), 2, pi)
    want = torch.gather(v.repeat_interleave(group, dim=1), 2,
                        sel[..., None].expand(b, h, s, d))
    return q.bfloat16(), k.bfloat16(), v, want


def check_flash(timer, dev, gen):
    """The prefill shape and a ragged GQA shape, causal, against the plain
    version in float32 (max-abs and per-row tolerances), timed beside SDPA;
    the suffix prefill's offset shapes (``FLASH_OFFSET_CASES``) likewise,
    beside SDPA with a bottom-right mask; a digest of the Sk = Sq outputs;
    then the selector probe, bit for bit, at S = 128, 129, 300 and 513 with
    MHA and GQA 16/4, causal and with keys spread over every kv tile, and
    causal with the queries cut to their last rows (q_offset > 0)."""
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
               "design": FLASH_DESIGN,
               "max_abs_err": err, "tol": tol, "max_row_rel_err": row_err,
               "row_tol": 1e-2, "off_bf16_share": off,
               "ok": err <= tol and row_err <= 1e-2,
               "ms": timer(lambda: cuda.flash_attention(q, k, v)),
               "plain_ms": timer(lambda: ops.flash_attention(
                   qf, kf, vf, causal=True, impl="ref")),
               "library_ms": timer(lambda: sdpa(q, k, v, is_causal=True,
                                                 enable_gqa=hkv != h))}
        nb = 2 * (2 * b * h * s * d) + 2 * (2 * b * hkv * s * d)
        flop = 4.0 * b * h * d * s * (s + 1) / 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(nb, flop, BF16_OPS_PER_S)
        rec["tflops"] = flop / rec["ms"] * 1e-9
        rec["x_sdpa"] = rec["ms"] / rec["library_ms"]
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
        rec["host_us"] = host_us(lambda: cuda.flash_attention(q, k, v))
        rec["library_host_us"] = host_us(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=hkv != h))
        log(f"  flash_attention B={b} H={h} Hkv={hkv} S={s} D={d} causal: "
            f"err {err:.3g} (tol {tol:.3g}), worst row |d|/|ref| "
            f"{row_err:.3g} (tol 0.01), {off:.3g} of outputs off the plain "
            f"bf16 rounding; {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
        log(f"    design {FLASH_DESIGN}: {rec['tflops']:.1f} TFLOP/s (causal "
            f"4BHDS(S+1)/2), {rec['x_sdpa']:.2f}x SDPA, {rec['x_bound']:.2f}x "
            f"the bound; enqueue {rec['host_us']:.1f} us on the host (SDPA "
            f"{rec['library_host_us']:.1f})")
        cases.append(rec)
    for (s, s_k, hkv) in FLASH_OFFSET_CASES:
        cases.append(flash_offset_case(timer, dev, gen, s, s_k, hkv))
    digest = flash_digest(dev)
    cases.append({"digest": digest, "ok": True})
    log(f"    Sk = Sq outputs (seeded inputs, B=8 H=16 S=512 and B=2 H=16 "
        f"Hkv=4 S=300, D=128): sha256 {digest}")
    for causal in (True, False):
        for s in (128, 129, 300, 513):
            for hkv in (16, 4):
                q, k, v, want = flash_selector_probe(dev, 2, 16, hkv, s,
                                                     causal=causal)
                got = cuda.flash_attention(q, k, v, causal=causal)
                same = bool(torch.equal(got, want))
                cases.append({"selector_probe": True, "b": 2, "h": 16,
                              "hkv": hkv, "s": s, "d": 128, "causal": causal,
                              "bit_equal": same, "ok": same})
                log(f"    selector probe S={s} Hkv={hkv} causal={causal}: "
                    f"output row i equals V[pos(pi(i))] bit for bit: {same}")
    for (s, off) in ((16, 256), (37, 16), (200, 496), (1, 512)):
        for hkv in (16, 4):
            q, k, v, want = flash_selector_probe(dev, 2, 16, hkv, off + s)
            got = cuda.flash_attention(q[:, :, off:], k, v, causal=True)
            same = bool(torch.equal(got, want[:, :, off:]))
            cases.append({"selector_probe": True, "b": 2, "h": 16,
                          "hkv": hkv, "s": s, "q_offset": off, "d": 128,
                          "causal": True, "bit_equal": same, "ok": same})
            log(f"    selector probe Sq={s} q_offset={off} Hkv={hkv}: row i "
                f"equals V[pos(pi(q_offset + i))] bit for bit: {same}")
    return cases[0], cases


# the suffix prefill's shapes: (Sq, Sk, Hkv) at B = 1, H = 16, D = 128;
# Sk - Sq is the shared prefix (256 rows of the schedule phase's system
# prompt, or more)
FLASH_OFFSET_CASES = ((16, 272, 16), (64, 320, 16), (240, 496, 16),
                      (200, 712, 16), (200, 712, 4))


def flash_offset_case(timer, dev, gen, s, s_k, hkv, h=16, d=128):
    """Keys longer than the queries (query row i at position Sk - Sq + i)
    against the plain version in float32 with the flash tolerance; timed
    beside SDPA with an explicit bottom-right mask (its is_causal aligns
    top-left when Sq != Sk)."""
    from repro_torch.kernels import cuda, ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    off = s_k - s
    q = torch.randn((1, h, s, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((1, hkv, s_k, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, hkv, s_k, d), generator=gen, device=dev).bfloat16()
    qf, kf, vf = q.float(), k.float(), v.float()
    out = cuda.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(qf, kf, vf, causal=True, impl="ref")
    got = out.float()
    err = float((got - want).abs().max())
    tol = 1e-2 * float(want.abs().max())
    row_err = float((torch.linalg.vector_norm(got - want, dim=-1)
                     / torch.linalg.vector_norm(want, dim=-1)).max())
    mask = torch.ones((s, s_k), dtype=torch.bool,
                      device=dev).tril(diagonal=off)
    lib = sdpa(q, k, v, attn_mask=mask, enable_gqa=hkv != h)
    lib_err = float((lib.float() - want).abs().max())
    rec = {"b": 1, "h": h, "hkv": hkv, "s": s, "s_k": s_k, "q_offset": off,
           "d": d, "max_abs_err": err, "tol": tol, "max_row_rel_err": row_err,
           "row_tol": 1e-2, "sdpa_max_abs_err": lib_err,
           "ok": err <= tol and row_err <= 1e-2,
           "ms": timer(lambda: cuda.flash_attention(q, k, v)),
           "plain_ms": timer(lambda: ops.flash_attention(
               qf, kf, vf, causal=True, impl="ref")),
           "library_ms": timer(lambda: sdpa(q, k, v, attn_mask=mask,
                                            enable_gqa=hkv != h))}
    nb = 2 * (2 * h * s * d) + 2 * (2 * hkv * s_k * d)
    flop = 4.0 * h * d * (s * off + s * (s + 1) / 2)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nb, flop, BF16_OPS_PER_S)
    rec["x_sdpa"] = rec["ms"] / rec["library_ms"]
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    log(f"  flash_attention offset B=1 H={h} Hkv={hkv} Sq={s} Sk={s_k} "
        f"(q_offset {off}) D={d}: err {err:.3g} (tol {tol:.3g}), worst row "
        f"{row_err:.3g} (tol 0.01); {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f}, masked SDPA {rec['library_ms']:.4f} "
        f"({rec['x_sdpa']:.2f}x), bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}, {rec['x_bound']:.1f}x)")
    return rec


def flash_digest(dev) -> str:
    """sha256 of the kernel's outputs at Sk = Sq on seeded inputs (the
    prefill shape and a ragged GQA shape): equal digests from two trees in
    one call show the two kernels compute the same bits."""
    import hashlib
    from repro_torch.kernels import cuda
    g = torch.Generator(dev).manual_seed(7)
    h = hashlib.sha256()
    for (b, hkv, s) in ((8, 16, 512), (2, 4, 300)):
        q, k, v = (torch.randn((b, n, s, 128), generator=g,
                               device=dev).bfloat16() for n in (16, hkv, hkv))
        out = cuda.flash_attention(q, k, v, causal=True)
        h.update(out.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


LSQ_STEPS = (0.7559289, 0.31, 1.7)   # q, k and v's steps in phase 3
LSQ_PROBE_STEPS = (0.25, 0.1, 3.0)   # exact ties for 0.25; near ties for 0.1
LSQ_PROBE_LENGTHS = (1, 7, 8 * 1000 + 3, 8 * 250_000 + 3)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit (signed zeros included), NaN where ``want`` is NaN
    (any NaN payload)."""
    gn, wn = torch.isnan(got), torch.isnan(want)
    if got.dtype != want.dtype or not torch.equal(gn, wn):
        return False
    iv = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.view(iv)[~gn], want.view(iv)[~wn])


def lsq_probe_values(dtype, steps, dev) -> torch.Tensor:
    """The values that can break an exact fake-quant: NaN, +-inf, signed
    zeros; for each step s and every code k of 8 bits and two past the clamp
    edges, (k + 1/2) s (a rounding tie where exact, a near tie otherwise)
    and its two neighbours in ``dtype``, and k s; then normal values. The
    specials lead, so a short prefix holds them."""
    head = torch.tensor([math.nan, math.inf, -math.inf, 0.0, -0.0, 1e30,
                         -1e30], dtype=torch.float32, device=dev).to(dtype)
    k = torch.arange(-130, 130, dtype=torch.float32, device=dev)
    iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
    parts = [head]
    for s in steps:
        tie = ((k + 0.5) * torch.tensor(s, device=dev)).to(dtype)
        parts += [tie, (tie.view(iv) + 1).view(dtype),
                  (tie.view(iv) - 1).view(dtype),
                  (k * torch.tensor(s, device=dev)).to(dtype)]
    g = torch.Generator(dev).manual_seed(5)
    parts.append(torch.randn((8 * 1024,), generator=g, device=dev).to(dtype))
    return torch.cat(parts)


def lsq_probe(dev):
    """The kernel against the plain version on the probe values, bit for
    bit: bf16 and float32, bits 2, 4 and 8, 1, 2 and 3 steps as tensors and
    as floats, the lengths LSQ_PROBE_LENGTHS (the values tiled and
    shuffled past the first). Returns (calls, failures)."""
    from repro_torch.kernels import cuda, ref
    calls, bad = 0, []
    for dtype in (torch.bfloat16, torch.float32):
        vals = lsq_probe_values(dtype, LSQ_PROBE_STEPS, dev)
        g = torch.Generator(dev).manual_seed(6)
        for n in LSQ_PROBE_LENGTHS:
            reps = -(-n // vals.numel())
            tiled = vals.repeat(reps)
            perm = torch.randperm(tiled.numel() - vals.numel(), generator=g,
                                  device=dev) + vals.numel()
            x = torch.cat([vals, tiled[perm]])[:n].contiguous()
            for bits in (2, 4, 8):
                for n_steps in (1, 2, 3):
                    for kind in ("tensor", "float"):
                        steps = [torch.tensor(v, device=dev) if kind ==
                                 "tensor" else v
                                 for v in LSQ_PROBE_STEPS[:n_steps]]
                        got = cuda.lsq_fakequant(x, steps, bits)
                        want = ref.lsq_fakequant_grouped(x, steps, bits)
                        calls += 1
                        if not all(same_bits(a, b)
                                   for a, b in zip(got, want)):
                            bad.append((str(dtype), n, bits, n_steps, kind))
    return calls, bad


def sass_count(source: str, kernel: str):
    """SASS instructions of each instantiation of ``kernel`` in a built
    library, from cuobjdump: {mangled name: (all, main path)}, the main
    path being the instructions up to the last EXIT before the first RET
    (what follows is the division's slow path, a subroutine); None where
    the toolkit has no cuobjdump.  Static counts: the kernels have no
    loops, so the main path is what a thread executes, the tail's branch
    included."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    lib = build.BUILD_DIR / f"lib{source}.so"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                ops[name] = []
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\S*)",
                         line)
            if m:
                ops[name].append(m.group(1))
    counts = {}
    for name, seq in ops.items():
        ret = next((i for i, op in enumerate(seq) if op.startswith("RET")),
                   len(seq))
        exits = [i for i, op in enumerate(seq[:ret]) if op == "EXIT"]
        counts[name] = (len(seq), exits[-1] + 1 if exits else ret)
    return counts


def check_lsq(timer, dev, gen):
    """The main path's shape (a prefill's 4096 x 2048 bf16 activations) at
    2, 4 and 8 bits, with one step and with three (q/k/v's grouped call):
    bit for bit against the plain version, timed, and in device time alone
    beside fake_quantize_per_tensor_affine (called once a step); then the
    probe (``lsq_probe``) and the kernel's static SASS count."""
    from repro_torch.kernels import cuda, ref
    x = torch.randn((8 * 512, 2048), generator=gen, device=dev).bfloat16()
    steps = [torch.tensor(v, device=dev) for v in LSQ_STEPS]
    cases = []
    for n_steps in (1, 3):
        st = steps[0] if n_steps == 1 else steps[:n_steps]
        for bits in (2, 4, 8):
            half = 2 ** (bits - 1)

            def kernel():
                return cuda.lsq_fakequant(x, st, bits)

            def plain():
                return ref.lsq_fakequant_grouped(x, steps[:n_steps], bits)

            def library():
                return [torch.fake_quantize_per_tensor_affine(
                    x, float(s), 0, -half, half - 1) for s in steps[:n_steps]]

            got = kernel()
            got = [got] if n_steps == 1 else got
            want = plain()
            torch.cuda.synchronize()
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            equal = all(same_bits(a, b) for a, b in zip(got, want))
            rec = {"bits": bits, "steps": n_steps, "shape": list(x.shape),
                   "max_abs_err": err, "tol": 0.0, "bit_equal": equal,
                   "ok": equal, "ms": timer(kernel), "plain_ms": timer(plain),
                   "library_ms": timer(library)}
            n = x.numel()
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                2.0 * n * (1 + n_steps), 6.0 * n * n_steps, F32_OPS_PER_S)
            alone_device(timer, rec, kernel, library)
            # PyTorch moving at least the same bytes: a copy of x (one
            # step), or x concatenated with itself, once an output
            rec["same_bytes_device_us"], _ = device_us(
                timer, lambda: torch.cat([x] * n_steps))
            log(f"  lsq_fakequant {bits}-bit, {n_steps} step(s), "
                f"{tuple(x.shape)} bf16: err {err} (exact; bit for bit: "
                f"{equal}) {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
                f"fake_quantize_per_tensor_affine x{n_steps} "
                f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
                f"({rec['bound_by']})")
            log_alone(rec, f"fake_quantize_per_tensor_affine x{n_steps}")
            log(f"    torch.cat of x, once an output (the same bytes): "
                f"{rec['same_bytes_device_us']:.2f} us")
            cases.append(rec)
    calls, bad = lsq_probe(dev)
    cases.append({"lsq_probe": True, "calls": calls, "failures": bad,
                  "ok": not bad})
    log(f"    probe (NaN, +-inf, ties and near ties, clamp edges; lengths "
        f"{LSQ_PROBE_LENGTHS}; bf16, f32; bits 2/4/8; 1-3 steps, tensors "
        f"and floats): {calls} calls, bit for bit against the plain version"
        f" in all but {len(bad)}: {bad[:4]}")
    sass = sass_count("lsq_fakequant", "lsq_kernel")
    for name, (total, main) in sorted((sass or {}).items()):
        m = re.search(r"lsq_kernelI(13__nv_bfloat16|f)Li(\d)E", name)
        if m:  # one 16-byte vector a thread: 8 bf16 or 4 float32
            elems = 8 if m.group(1) != "f" else 4
            log(f"    SASS lsq_kernel<{m.group(1)[2:] or 'float'}, "
                f"{m.group(2)}>: {main} instructions on the main path, "
                f"{main / elems:.1f} an element ({total} with the "
                f"division's slow path)")
    cases[1]["sass"] = sass
    return cases[1], cases


LSQ_BWD_TOL = 1e-5    # gs: times gscale * sum|g * ds| (the sum's order)


def lsq_bwd_gs_scale(x, g, step, bits) -> float:
    """gscale * sum|g * ds|: the size of the terms a step gradient sums,
    which bounds what a change of summation order can move it by."""
    from repro_torch.core import quant
    qmin, qmax = quant.qrange(bits)
    s = max(abs(float(step)), 1e-9)
    xs = x.float() / torch.tensor(s, device=x.device)
    inr = (xs >= qmin) & (xs <= qmax)
    ds = torch.where(inr, torch.round(xs) - xs, torch.clamp(xs, qmin, qmax))
    return float((g.double() * ds.double()).abs().nansum()) * \
        quant.lsq_step_grad_scale(x.numel(), bits)


def lsq_bwd_compare(x, grads, steps, bits):
    """The backward kernel against its plain version on one input: gx bit
    for bit; each gs within LSQ_BWD_TOL * gscale * sum|g * ds| (NaN where
    the plain version gives NaN).  Returns (gx equal, worst gs error over
    its bound, max |gs difference|)."""
    from repro_torch.kernels import cuda, ref
    gx, gs = cuda.lsq_fakequant_bwd(x, grads, steps, bits)
    wx, ws = ref.lsq_fakequant_bwd(x, grads, steps, bits)
    torch.cuda.synchronize()
    worst, diff = 0.0, 0.0
    for a, b, g, s in zip(gs, ws, grads, steps):
        a, b = float(a), float(b)
        if math.isnan(b) or math.isnan(a):
            worst = max(worst, 0.0 if math.isnan(a) == math.isnan(b)
                        else math.inf)
            continue
        d = abs(a - b)
        diff = max(diff, d)
        scale = lsq_bwd_gs_scale(x, g, s, bits)
        worst = max(worst, d / (LSQ_BWD_TOL * scale) if scale else
                    (0.0 if d == 0 else math.inf))
    return same_bits(gx, wx), worst, diff


def check_lsq_bwd(timer, dev, gen):
    """The LSQ backward kernel at the train step's shapes (B = 8, S = 512):
    q/k/v's shared input (4096 x 2048 bf16, 3 steps), the down
    projection's input (4096 x 8192, 1 step), a gate/up weight (2048 x
    8192, its LSQ step), all at 4 bits; then a ragged length and the
    forward probe's values (NaN, +-inf, ties, clamp edges) at 2, 4 and 8
    bits, bf16 and float32, 1-3 steps.  gx bit for bit against the plain
    version, gs within its bound (``lsq_bwd_compare``); timed beside the
    plain version and beside PyTorch's learnable per-tensor LSQ
    (``torch._fake_quantize_learnable_per_tensor_affine``, forward and
    backward, zero point 0, once a step: it recomputes the forward's codes
    in its backward and takes no shared input), and in device time alone
    against the byte bound."""
    from repro_torch.core import quant
    from repro_torch.kernels import cuda, ref
    w = torch.randn((2048, 8192), generator=gen, device=dev) * 0.02
    shapes = [("qkv input", (8 * 512, 2048), [torch.tensor(v, device=dev)
                                               for v in LSQ_STEPS]),
              ("down input", (8 * 512, 8192), [torch.tensor(0.31,
                                                            device=dev)]),
              ("gate weight", (2048, 8192), [quant.init_step_from_tensor(
                  w, 4.0)])]
    cases = []
    for what, shape, steps in shapes:
        x = (w.bfloat16() if what == "gate weight" else torch.randn(
            shape, generator=gen, device=dev).bfloat16())
        grads = [torch.randn(shape, generator=gen, device=dev).bfloat16()
                 * 1e-3 for _ in steps]
        bits = 4
        half = 2 ** (bits - 1)

        def kernel():
            return cuda.lsq_fakequant_bwd(x, grads, steps, bits)

        def plain():
            return ref.lsq_fakequant_bwd(x, grads, steps, bits)

        xr = x.float().requires_grad_(True)
        zp = torch.zeros((1,), device=dev)
        lib_steps = [s.reshape(1).clone().requires_grad_(True) for s in steps]
        gscale = quant.lsq_step_grad_scale(x.numel(), bits)

        def library():
            for s, g in zip(lib_steps, grads):
                out = torch._fake_quantize_learnable_per_tensor_affine(
                    xr, s, zp, -half, half - 1, gscale)
                out.backward(g.float())

        equal, worst, diff = lsq_bwd_compare(x, grads, steps, bits)
        n, ns = x.numel(), len(steps)
        rec = {"what": what, "shape": list(shape), "steps": ns,
               "bits": bits, "gx_bit_equal": equal,
               "gs_err_over_bound": worst, "max_abs_err": diff,
               "tol": f"gx exact; gs {LSQ_BWD_TOL} x gscale sum|g ds|",
               "ok": equal and worst <= 1.0, "ms": timer(kernel),
               "plain_ms": timer(plain), "library_ms": timer(library)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2.0 * n * (2 + ns), 10.0 * n * ns, F32_OPS_PER_S)
        alone_device(timer, rec, kernel, library)
        log(f"  lsq_fakequant_bwd {what} {tuple(shape)} bf16, {ns} step(s):"
            f" gx bit for bit {equal}, gs |diff| {diff:.3g} "
            f"({worst:.3g} of its bound); {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f}, learnable LSQ fwd+bwd x{ns} "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")
        log_alone(rec, f"learnable LSQ fwd+bwd x{ns}")
        cases.append(rec)
    bad, calls = [], 0
    for dtype in (torch.bfloat16, torch.float32):
        vals = lsq_probe_values(dtype, LSQ_PROBE_STEPS, dev)
        for n in (8 * 1000 + 3, vals.numel()):
            x = vals.repeat(-(-n // vals.numel()))[:n].contiguous()
            g = torch.Generator(dev).manual_seed(7)
            grads = [torch.randn(x.shape, generator=g, device=dev).to(dtype)
                     for _ in range(3)]
            for bits in (2, 4, 8):
                for ns in (1, 2, 3):
                    steps = [torch.tensor(v, device=dev) if k % 2 else v
                             for k, v in enumerate(LSQ_PROBE_STEPS[:ns])]
                    equal, worst, _ = lsq_bwd_compare(x, grads[:ns], steps,
                                                      bits)
                    calls += 1
                    if not (equal and worst <= 1.0):
                        bad.append((str(dtype), n, bits, ns, equal, worst))
    cases.append({"lsq_bwd_probe": True, "calls": calls, "failures": bad,
                  "ok": not bad})
    log(f"    probe (NaN, +-inf, ties, clamp edges; lengths 8003 and "
        f"{vals.numel()}; bf16, f32; bits 2/4/8; 1-3 steps): {calls} calls,"
        f" gx bit for bit and gs within bound in all but {len(bad)}: "
        f"{bad[:4]}")
    return cases[0], cases


def check_histogram(timer, dev, gen):
    """EAGL's histogram at the largest olmo-1b tensor (2048 x 8192 codes of
    normal weights quantized at 4 and 2 bits), and ragged lengths with
    negatives and the sentinel n_bins at 16 bins and at 17 and 4096 (the
    shared-counter path).  Exact against the plain version, two calls in a
    row equal (the counters reset), one device op a call; timed against
    torch.bincount on the in-range codes."""
    from repro_torch.core import quant
    from repro_torch.kernels import cuda, ref
    cases = []
    w = torch.randn((2048 * 8192,), generator=gen, device=dev) * 0.02
    for n_bins in (16, 4):
        bits = float(n_bins.bit_length() - 1)
        step = quant.init_step_from_tensor(w, bits)
        codes = (quant.quantize_int(w, step, bits) + n_bins // 2).to(
            torch.int32)
        cases.append((n_bins, codes))
    ragged = torch.randint(-3, 16 + 3, (1_000_003,), generator=gen,
                           device=dev, dtype=torch.int32)
    cases.append((16, ragged))
    for n_bins in (17, 4096):
        cases.append((n_bins, torch.randint(
            -3, n_bins + 3, (1_000_003,), generator=gen, device=dev,
            dtype=torch.int32)))
    out = []
    for n_bins, codes in cases:
        got = cuda.histogram(codes, n_bins)
        again = cuda.histogram(codes, n_bins)
        want = ref.histogram(codes, n_bins)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        repeat = bool(torch.equal(got, again))
        kept = codes[(codes >= 0) & (codes < n_bins)]
        n = codes.numel()
        rec = {"n": n, "n_bins": n_bins, "max_abs_err": err, "tol": 0.0,
               "repeat_equal": repeat,
               "ok": (err == 0.0 and repeat
                      and float(got.sum()) == kept.numel()),
               "ms": timer(lambda: cuda.histogram(codes, n_bins)),
               "plain_ms": timer(lambda: ref.histogram(codes, n_bins)),
               "library_ms": timer(lambda: torch.bincount(
                   kept, minlength=n_bins))}
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4.0 * n + 4.0 * n_bins, float(n), F32_OPS_PER_S)
        alone_device(timer, rec, lambda: cuda.histogram(codes, n_bins),
                     lambda: torch.bincount(kept, minlength=n_bins))
        rec["device_ops"] = sum(rec["device_kernels"].values())
        rec["ok"] = rec["ok"] and rec["device_ops"] == 1
        # PyTorch reading the same bytes (a reduction over the codes)
        rec["same_bytes_device_us"], _ = device_us(timer,
                                                   lambda: codes.max())
        log(f"  histogram n={n} bins={n_bins}: err {err} (exact; two calls "
            f"equal: {repeat}) "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, bincount "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")
        log_alone(rec, "bincount")
        log(f"    one device op a call: {rec['device_ops'] == 1}; "
            f"codes.max() over the same bytes: "
            f"{rec['same_bytes_device_us']:.2f} us")
        out.append(rec)
    return out[0], out


def paged_case(gen, dev, bits, b, h, hkv, d, n, page, pos):
    """A quantized cache of n * page rows a slot, and the same rows in
    shuffled pools: each slot maps the pages its position needs, the table
    past them holds stale ids and -1, the free pages hold garbage codes and
    NaN V scales.  Returns (q, contiguous cache, (kq, vq, v_scale) pools,
    tbl)."""
    from repro_torch.kernels import kv_quant
    s = n * page
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    qc = kv_quant.quantize_prefill({"k": k, "v": v}, torch.full(
        (b,), s, dtype=torch.int32, device=dev), bits)
    p = b * n + 32
    perm = torch.randperm(p, generator=gen, device=dev).to(torch.int32)
    pools = [torch.randint(-128 if bits == 8 else 0, 128 if bits == 8
                           else 256, (p, page) + tuple(qc[key].shape[2:]),
                           generator=gen, device=dev).to(qc[key].dtype)
             for key in ("kq", "vq")]
    pools.append(torch.full((p, page, hkv), float("nan"), device=dev))
    tbl = torch.randint(0, p, (b, n), generator=gen, device=dev,
                        dtype=torch.int32)
    tbl[:, 1::2] = -1
    for i in range(b):
        npg = min(int(pos[i]) // page + 1, n)   # a position past the end
        ids = perm[i * n:i * n + npg]
        tbl[i, :npg] = ids
        for pool, key in zip(pools, ("kq", "vq", "v_scale")):
            pool[ids.long()] = qc[key][i, :npg * page].reshape(
                (npg, page) + tuple(qc[key].shape[2:]))
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    return q, qc, pools, tbl


def check_paged_kv_decode(timer, dev, gen):
    """The paged decode at the serve shapes (B = 8, D = 128, page 16, 64
    pages a slot, positions up to 1023), int8 and int4, and GQA 16/4:
    bit for bit the contiguous kernel on the gathered cache and itself on
    a second call, within 1e-4 * max|ref| of the plain version, finite over
    NaN-poisoned free pages.  Timed against SDPA on the dequantized bf16
    cache (no gather), also in device time alone beside the contiguous
    kernel on the same rows; then the selector probe over pages."""
    from repro_torch.kernels import cuda, kv_quant, ref
    b, d, n, page = 8, 128, 64, PAGE
    s = n * page
    pos = torch.tensor([int(x) for x in np.linspace(100, s - 1, b)],
                       dtype=torch.int32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for bits, h, hkv in ((8, 16, 16), (4, 16, 16), (4, 16, 4)):
        q, qc, (kqp, vqp, vsp), tbl = paged_case(gen, dev, bits, b, h, hkv,
                                                 d, n, page, pos)
        args = (q, kqp, qc["k_scale"], vqp, vsp, tbl, pos)
        got = cuda.paged_kv_decode_attention(*args, bits)
        repeat = bool(torch.equal(got, cuda.paged_kv_decode_attention(
            *args, bits)))
        gathered = (q, kv_quant.gather_pages(kqp, tbl), qc["k_scale"],
                    kv_quant.gather_pages(vqp, tbl),
                    kv_quant.gather_pages(vsp, tbl), pos)
        contiguous = cuda.kv_decode_attention(*gathered, bits)
        want = ref.paged_kv_cache_attention(*args, bits)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-4 * float(want.abs().max())
        same = bool(torch.equal(got, contiguous))
        kd = kv_quant.dequant_k(qc["kq"], qc["k_scale"], bits,
                                torch.bfloat16).transpose(1, 2)
        vd = kv_quant.dequant_v(qc["vq"], qc["v_scale"], bits,
                                torch.bfloat16).transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])[
            :, None, None, :]

        def library():
            return sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                        enable_gqa=hkv != h)

        rec = {"bits": bits, "b": b, "h": h, "hkv": hkv, "d": d,
               "page": page, "pages_per_slot": n,
               "plan": list(cuda.decode_plan(b, hkv, h // hkv, s, bits)),
               "max_abs_err": err, "tol": tol,
               "equals_contiguous_kernel": same, "repeat_bit_equal": repeat,
               "ok": (err <= tol and same and repeat
                      and bool(torch.isfinite(got).all())),
               "ms": timer(lambda: cuda.paged_kv_decode_attention(*args,
                                                                  bits)),
               "contiguous_ms": timer(lambda: cuda.kv_decode_attention(
                   *gathered, bits)),
               "plain_ms": timer(lambda: ref.paged_kv_cache_attention(
                   *args, bits)),
               "library_ms": timer(library)}
        rows = int(pos.sum()) + b
        dp = d if bits == 8 else d // 2
        pages_read = int((pos // page + 1).sum())
        nb = (b * h * d * 2 + rows * hkv * (2 * dp + 4) + b * hkv * d * 4
              + pages_read * 4 + b * 4 + b * h * d * 4)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nb, 4.0 * rows * (h * d), F32_OPS_PER_S)
        alone_device(timer, rec,
                     lambda: cuda.paged_kv_decode_attention(*args, bits),
                     library)
        rec["contiguous_device_us"], _ = device_us(
            timer, lambda: cuda.kv_decode_attention(*gathered, bits))
        rec["x_contiguous_device"] = (rec["device_us"]
                                      / rec["contiguous_device_us"])
        log(f"  paged_kv_decode_attention int{bits} B={b} H={h} Hkv={hkv} "
            f"D={d} page={page} x{n}: err {err:.3g} (tol {tol:.3g}), equal "
            f"to the contiguous kernel: {same}, two calls equal: {repeat}; "
            f"{rec['ms']:.4f} ms (contiguous {rec['contiguous_ms']:.4f}), "
            f"plain {rec['plain_ms']:.4f}, SDPA on dequantized bf16 "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")
        log(f"    device time alone: {rec['device_us']:.2f} us, "
            f"{rec['x_bound_device']:.2f}x the bound ({rec['bound_us']:.2f} "
            f"us), SDPA {rec['library_device_us']:.2f} us "
            f"({rec['x_library_device']:.2f}x); contiguous on the same rows "
            f"{rec['contiguous_device_us']:.2f} us "
            f"({rec['x_contiguous_device']:.2f}x); plan {rec['plan'][0]} "
            f"splits of {rec['plan'][1]} rows")
        cases.append(rec)
        del q, qc, kqp, vqp, vsp, tbl, args, gathered, kd, vd
    for bits in (8, 4):
        for hkv in (16, 4):
            calls, splits, c, same = kv_decode_selector_probe(
                dev, bits, "paged", hkv=hkv)
            cases.append({"kv_decode_selector_probe": True, "bits": bits,
                          "layout": "paged", "h": 16, "hkv": hkv, "s": 1024,
                          "plan": [splits, c], "calls": calls,
                          "bit_equal": same, "ok": same})
            log(f"    selector probe int{bits} Hkv={hkv} paged: rows in "
                f"every one of {splits} chunks of {c}, {calls} call(s), "
                f"outputs equal the selected V rows bit for bit: {same}")
    return cases[0], cases


# ---------------------------------------------------------------- main path
def make_prompts(cfg, rng):
    lengths = np.linspace(128, 512, 8).astype(np.int32)
    tokens = np.zeros((8, 512), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab, n)
    return tokens, lengths


def device_rows(fn) -> dict:
    """{kernel: (device us, launches)} of the kernels ``fn`` runs, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_table(prof)


def device_table(prof) -> dict:
    rows = {}
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue   # a span over kernels (Optimizer.step), not one
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (us, e.count)
    return rows


def device_breakdown(fn, top: int = 20) -> dict:
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
    rows = sorted(((k, us, n) for k, (us, n) in device_table(prof).items()),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
            # each one a point where the host waited for the device
            "dtoh_copies": sum(n for k, _, n in rows
                               if k.startswith("Memcpy DtoH")),
            "device_ops": sum(n for _, _, n in rows),
            "qmm_gemv_ms": sum(us for k, us, _ in rows
                               if "qmm_gemv" in k) / 1e3,
            "decode_attention_ms": sum(us for k, us, _ in rows
                                       if "kv_decode" in k) / 1e3,
            "lsq_fakequant_ms": sum(us for k, us, _ in rows
                                    if "lsq_kernel" in k) / 1e3,
            "lsq_fakequant_bwd_ms": sum(us for k, us, _ in rows
                                        if "lsq_bwd_kernel" in k) / 1e3,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for k, us, n in rows[:top]]}


def log_breakdown(what: str, rec: dict) -> None:
    log(f"    profile {what}: wall {rec['wall_ms']:.2f} ms, device busy "
        f"{rec['device_ms']:.2f} ms, idle share {rec['idle_share']:.3f}, "
        f"{rec['device_ops']} device ops, {rec['dtoh_copies']} "
        f"device-to-host copies; qmm_gemv {rec['qmm_gemv_ms']:.3f} ms, "
        f"decode attention {rec['decode_attention_ms']:.3f} ms, "
        f"lsq_fakequant {rec['lsq_fakequant_ms']:.3f} ms")
    for row in rec["top"][:6]:
        log(f"      {row['ms']:9.3f} ms  x{row['count']:<5d} {row['kernel']}")


def phase_select(cfg, raw, dev):
    """EAGL gains of every selectable unit, through the histogram kernel
    (the launches are counted) and through impl="ref"; the knapsack take at
    budget 0.7 from each.  The counts are exact on both paths, so the gains
    agree to float32 rounding and the takes are equal.  Returns the mixed
    policy and the record."""
    from repro_torch.core import knapsack
    from repro_torch.core.metrics import eagl_gains
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    policy = tf.build_policy(cfg)

    def fetch(u, t):
        return tf.fetch_unit_tensor(raw, u, t)

    def timed(impl):
        sync(dev)
        t0 = time.perf_counter()
        gains = eagl_gains(policy, fetch, impl=impl)
        sync(dev)
        return gains, time.perf_counter() - t0

    cuda.reset_launches()
    gains, wall = timed("auto")
    launches = dict(cuda.LAUNCHES)
    plain, plain_wall = timed("ref")
    rel = max(abs(gains[k] - plain[k]) / max(abs(plain[k]), 1e-30)
              for k in gains)
    sel = knapsack.select_for_budget(policy, gains, budget_frac=0.7)
    sel_ref = knapsack.select_for_budget(policy, plain, budget_frac=0.7)
    mixed = policy.apply_selection(sel.take)
    units = policy.selectable_units()
    n4 = sum(mixed.bits_of(u.name) == 4.0 for u in units)
    n2 = sum(mixed.bits_of(u.name) == 2.0 for u in units)
    rec = {"units": len(units), "tensors": sum(len(u.tensors) for u in units),
           "wall_s": wall, "plain_wall_s": plain_wall, "launches": launches,
           "gains_max_rel_diff": rel, "take_equal": sel.take == sel_ref.take,
           "n4": n4, "n2": n2, "gains": gains,
           "mix": {u.name: mixed.bits_of(u.name) for u in units}}
    log(f"  EAGL over {rec['units']} units ({rec['tensors']} tensors): "
        f"{wall:.2f} s through the histogram kernel, {plain_wall:.2f} s "
        f"plain; gains agree to {rel:.3g} relative, takes equal: "
        f"{rec['take_equal']}")
    log(f"  knapsack at budget 0.7 on the EAGL gains: {n4} units at 4 bits, "
        f"{n2} at 2 bits: " + " ".join(
            f"{name.replace('pat0.', '')}={int(b)}"
            for name, b in rec["mix"].items()))
    log("  the weights are random (seed 0), so this mix says nothing about "
        "which layers of a trained OLMo-1B need 4 bits")
    if not (rel <= 1e-6 and rec["take_equal"]):
        raise RuntimeError(f"EAGL through the kernel disagrees with "
                           f"impl='ref': max relative gain difference {rel}, "
                           f"takes equal {rec['take_equal']}")
    if not (n4 and n2):
        raise RuntimeError("the knapsack did not select a 4/2 mix")
    return mixed, rec


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


# the kernels each serve path must launch, and those it must not
SERVE_PATHS = {
    "contiguous": ({"quant_matmul", "kv_decode_attention", "flash_attention",
                    "lsq_fakequant"}, {"paged_kv_decode_attention"}),
    "paged": ({"quant_matmul", "paged_kv_decode_attention",
               "flash_attention", "lsq_fakequant"}, {"kv_decode_attention"}),
}


def phase_serve(cfg, packed, pa, dev, tokens, lengths):
    from repro_torch.serve import EngineSpec, ServeEngine
    runs = {}
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    for layout, (need, never) in SERVE_PATHS.items():
        for bits in (8, 4):
            name = f"{layout}-int{bits}"
            engine = ServeEngine(cfg, packed, pa, max_seq=1024,
                                 spec=EngineSpec(cache="quantized",
                                                 cache_bits=bits,
                                                 cache_layout=layout,
                                                 page_size=PAGE),
                                 device=dev)
            rec = serve_run(engine, cfg, tok_t, len_t, lengths)
            launches = rec["launches"]
            missing = sorted(k for k in need if launches[k] == 0)
            stray = sorted(k for k in never if launches[k] != 0)
            if missing or stray:
                raise RuntimeError(f"{name}: the path launched no {missing}"
                                   f" and launched {stray}")
            copies = rec["profile"]["decode_8_steps"]["dtoh_copies"]
            if copies:
                raise RuntimeError(f"{name}: {copies} device-to-host copies "
                                   f"in 8 decode steps")
            step = rec["launches_per_decode_step"]
            decode_kernel = ("paged_kv_decode_attention" if layout == "paged"
                             else "kv_decode_attention")
            if step[decode_kernel] != cfg.n_repeats:
                raise RuntimeError(f"{name}: {step[decode_kernel]} "
                                   f"{decode_kernel} launches per decode "
                                   f"step, expected {cfg.n_repeats}")
            # one grouped fake-quant for q/k/v, o, gate/up and down a layer,
            # and the head's
            lsq = (rec["launches_per_prefill"]["lsq_fakequant"],
                   step["lsq_fakequant"])
            if lsq != (4 * cfg.n_repeats + 1,) * 2:
                raise RuntimeError(f"{name}: lsq_fakequant launched {lsq} "
                                   f"times per prefill and decode step, "
                                   f"expected {4 * cfg.n_repeats + 1}")
            if layout == "paged":
                base = runs[f"contiguous-int{bits}"]
                if rec["tokens"] != base["tokens"]:
                    raise RuntimeError(f"{name}: tokens differ from the "
                                       f"contiguous run's")
            wb = engine.weight_bytes()
            rec.update(weight_bytes_packed=wb["packed"],
                       weight_bytes_bf16=wb["bf16"])
            log(f"  serve {name} cache: generate 8x64 in "
                f"{rec['generate_s']:.3f} s ({rec['tokens_per_s']:.1f} "
                f"tok/s), prefill {rec['prefill_ms']:.1f} ms, decode "
                f"{rec['decode_ms_per_step']:.2f} ms/step, weights "
                f"{wb['packed'] / 1e6:.1f} MB packed vs {wb['bf16'] / 1e6:.1f}"
                f" MB bf16, KV {rec['kv_bytes'] / 1e6:.1f} MB, peak "
                f"{rec['max_memory_allocated'] / 1e9:.2f} GB")
            log(f"    launches in generate: {launches}")
            log(f"    per prefill: {rec['launches_per_prefill']}; per decode "
                f"step: {step}")
            for what, brk in rec["profile"].items():
                log_breakdown(what, brk)
            if layout == "paged":
                log(f"    tokens equal to the contiguous int{bits} run's")
            runs[name] = rec
            # free this run's cache before the next run's peak is taken
            del engine
            torch.cuda.empty_cache()
    return runs


def serve_run(engine, cfg, tok_t, len_t, lengths):
    """One engine: generate 8 x 64 with the launches counted, then one
    prefill and the decode steps timed apart, and their profiles."""
    from repro_torch.kernels import cuda
    from repro_torch.serve import kv_cache
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, pre = engine.prefill(tok_t, len_t)
    cache = engine.splice_prefill(pre, len_t)
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
    return {"generate_s": wall, "tokens_per_s": 8 * 64 / wall,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s * 1e3, "launches": launches,
            "launches_per_prefill": per_prefill,
            "launches_per_decode_step": per_step,
            "kv_bytes": kv_cache.cache_bytes(cache),
            "max_memory_allocated": peak, "profile": prof,
            "tokens": out.tolist()}


# ------------------------------------------------------------- schedule
SCHED_SLOTS = 8
SCHED_MAX_SEQ = 1024
SCHED_POOL = 160                 # pages; 8 slots' worst case is 512
GATE_A_MIN = 18                  # of 24 requests equal to their serial run
MIN_HITS = 12                    # registry hits in the paged full run
# run -> (EngineSpec fields, kernels the run must launch, and must not)
SCHED_RUNS = {
    "paged-full": ({"cache": "full", "cache_layout": "paged"},
                   {"quant_matmul", "flash_attention", "lsq_fakequant"},
                   {"kv_decode_attention", "paged_kv_decode_attention"}),
    "paged-int8": ({"cache": "quantized", "cache_bits": 8,
                    "cache_layout": "paged"},
                   {"quant_matmul", "flash_attention", "lsq_fakequant",
                    "paged_kv_decode_attention"}, {"kv_decode_attention"}),
    "contiguous-int4": ({"cache": "quantized", "cache_bits": 4},
                        {"quant_matmul", "flash_attention", "lsq_fakequant",
                         "kv_decode_attention"},
                        {"paged_kv_decode_attention"}),
}
# submission order: s = shares the system prompt, u = shares nothing,
# r = repeats an earlier s prompt exactly.  Each hit's donor comes first;
# with these budgets the paged full run defers admissions under sharing
# too, and its peak of pages in use stays under the run without sharing
SCHED_ORDER = ("s0 u0 s1 s2 s3 s4 s5 r0 u1 u2 u3 s6 u4 u5 s7 u6 s8 r1 s9 "
               "r2 u7 r3 s10 s11").split()


def schedule_requests(cfg, rng):
    """The schedule phase's 24 requests, in submission order: 12 share a
    256-token system prompt (16 pages) and add 5-200 tokens of their own
    (s0 fewer than 16, so the prefix it registers is the system prompt's
    16 pages), 4 repeat the s prompt submitted last before them, 8 share
    nothing
    (64-512 tokens); 8-32 new tokens each.  Returns [(uid, prompt,
    max_new_tokens)]."""
    sys_prompt = rng.integers(0, cfg.vocab, 256).tolist()
    prompts = {}
    for i in range(12):
        n = int(rng.integers(5, 16)) if i == 0 else int(rng.integers(5, 201))
        prompts[f"s{i}"] = sys_prompt + rng.integers(0, cfg.vocab, n).tolist()
    for i in range(8):
        prompts[f"u{i}"] = rng.integers(0, cfg.vocab,
                                        int(rng.integers(64, 513))).tolist()
    for uid in (u for u in SCHED_ORDER if u[0] == "r"):
        # the latest s prompt before it, so that its donor's entry is
        # still registered when it arrives
        donor = [u for u in SCHED_ORDER[:SCHED_ORDER.index(uid)]
                 if u[0] == "s"][-1]
        prompts[uid] = list(prompts[donor])
    budgets = rng.integers(8, 33, len(SCHED_ORDER))
    return [(uid, prompts[uid], int(n)) for uid, n in zip(SCHED_ORDER,
                                                            budgets)]


def audited(engine, share: bool = True):
    """A ContinuousBatchingScheduler that records, without changing what
    it does: each admission's plan (miss, aligned hit at its
    suffix_start, identical hit) and first-token logits, deferrals,
    decode chunks, the wall clock at which each request's first token and
    each of its chunks reach the host, and the peak of the
    distinct pages live slots map; and checks the allocator after every
    admission and eviction."""
    from repro_torch.serve import ContinuousBatchingScheduler, paging

    class Audited(ContinuousBatchingScheduler):
        def __init__(self):
            super().__init__(engine, n_slots=SCHED_SLOTS, prompt_bucket=16,
                             share_prefixes=share)
            self.plans, self.first_logits, self.walls = {}, {}, {}
            self.deferrals = self.chunks = self.live_peak = 0
            self._plan = None

        def _record(self, plan, *args, **kw):
            self._plan = plan(*args, **kw)
            return self._plan

        def _admit_contiguous(self, j, req):
            last = super()._admit_contiguous(j, req)
            self.plans[req.uid] = ("miss", 0)
            self.first_logits[req.uid] = last[0].float().clone()
            return last

        def _admit_paged(self, j, req):
            orig = paging.plan_admission
            with patched(paging, "plan_admission",
                         lambda *a, **k: self._record(orig, *a, **k)):
                last = super()._admit_paged(j, req)
            self.allocator.check()
            if last is None:
                self.deferrals += 1
                return None
            plan, n = self._plan, len(req.prompt)
            self.plans[req.uid] = (
                "miss" if plan.entry is None else
                "identical" if plan.suffix_start >= n else "aligned",
                plan.suffix_start)
            self.first_logits[req.uid] = last[0].float().clone()
            live = set()
            for pages in self._slot_pages:
                live.update(pages or ())
            self.live_peak = max(self.live_peak, len(live))
            return last

        def _begin_decode(self, j, slot, first):
            super()._begin_decode(j, slot, first)
            self.walls[slot.req.uid] = [time.perf_counter()]

        def _decode_harvest(self):
            self.chunks += 1
            live = [s.req.uid for s in self.slots if s is not None]
            super()._decode_harvest()
            now = time.perf_counter()
            for uid in live:
                self.walls[uid].append(now)

        def _evict(self, slot, j):
            super()._evict(slot, j)
            if self._paged:
                self.allocator.check()

    return Audited()


def median_max(xs) -> dict:
    """p50 and max: a few dozen samples hold no p99 but their largest."""
    a = np.asarray(xs if len(xs) else [0.0], np.float64)
    return {"p50": float(np.percentile(a, 50, method="nearest")),
            "max": float(a.max())}


def schedule_run(engine, reqs, dev, share=True, profile=False):
    """Submit every request, then drain: the launches counted, the wall
    clock kept and, with ``profile``, the device-to-host copies counted
    (torch.profiler, device activity only).  Returns the scheduler and the
    run's record."""
    from torch.profiler import ProfilerActivity, profile as profiler
    from repro_torch.kernels import cuda
    from repro_torch.serve import Request, kv_cache
    sched = audited(engine, share)
    for uid, prompt, n, eos in reqs:
        sched.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n,
                             eos_id=eos))
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    act = ProfilerActivity.CUDA if dev.type == "cuda" else \
        ProfilerActivity.CPU
    ctx = profiler(activities=[act]) if profile else contextlib.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        sched.run()
        sync(dev)
        wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "launches": dict(cuda.LAUNCHES),
           "admissions": len(sched.first_logits), "chunks": sched.chunks,
           "deferrals": sched.deferrals, "plans": sched.plans,
           "latency_report": sched.latency_report(),
           "pool_bytes": kv_cache.cache_bytes(sched.cache),
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else None)}
    n_tok = sum(len(c.tokens) for c in sched.completed.values())
    # a chunk's tokens reach the host together at its harvest, so the wall
    # clock reads the stall between a request's chunks, not per token
    ttft = [w[0] - t0 for w in sched.walls.values()]
    stalls = [b - a for w in sched.walls.values() for a, b in zip(w, w[1:])]
    rec.update(tokens=n_tok, tokens_per_s=n_tok / wall,
               wall_ttft_ms={k: v * 1e3
                             for k, v in median_max(ttft).items()},
               wall_chunk_stall_ms={k: v * 1e3
                                    for k, v in median_max(stalls).items()})
    if profile:
        rows = device_table(prof)
        busy = sum(us for us, _ in rows.values())
        rec.update(dtoh_copies=sum(n for k, (_, n) in rows.items()
                                   if k.startswith("Memcpy DtoH")),
                   device_ms=busy / 1e3,
                   idle_share=1.0 - busy / (wall * 1e6))
    if sched._paged:
        rec.update(peak_pages=sched.allocator.peak_in_use,
                   live_peak_pages=sched.live_peak,
                   pages_in_use_after=sched.allocator.in_use,
                   registry_hits=(sched.registry.hits if sched.registry
                                  else 0),
                   registry_misses=(sched.registry.misses if sched.registry
                                    else 0))
    return sched, rec


def check_completions(sched, reqs, vocab) -> None:
    for uid, prompt, n, eos in reqs:
        c = sched.completed.get(uid)
        if c is None or not 1 <= len(c.tokens) <= n or \
                not all(0 <= t < vocab for t in c.tokens) or \
                c.prompt_len != len(prompt):
            raise RuntimeError(f"request {uid}: bad completion {c}")
        stop = "eos" if eos is not None and c.tokens[-1] == eos else "length"
        if c.finish_reason != stop or (stop == "length" and
                                       len(c.tokens) != n):
            raise RuntimeError(f"request {uid}: finish {c.finish_reason} "
                               f"after {len(c.tokens)} of {n} tokens")


def suffix_prefill_device(engine, sched, reqs, dev) -> dict:
    """One aligned hit's suffix prefill (over the registered system-prompt
    pages, mapped into slot 0 of the drained scheduler) beside the same
    prompt's whole prefill: device ms from torch.profiler."""
    from repro_torch.serve import paging
    uid, st = max(((u, p[1]) for u, p in sched.plans.items()
                   if p[0] == "aligned"), key=lambda x: x[1])
    prompt = next(p for u, p, _, _ in reqs if u == uid)
    suffix = prompt[st:]
    pad = sched._bucket_pad(len(suffix), engine.max_seq - st)
    whole_pad = sched._bucket_pad(len(prompt), engine.max_seq)
    toks = sched._prompt_tokens(suffix, pad)
    whole = sched._prompt_tokens(prompt, whole_pad)
    n = torch.tensor([len(prompt)])
    # the prefix rows into pages of the drained scheduler's pool
    sched.registry.make_room(st // PAGE)
    pages = sched.allocator.alloc(st // PAGE)
    _, pre = engine.prefill(whole, n)
    cache = paging.write_slot_pages(sched.cache, pre, 0, len(prompt), 0,
                                    pages)
    cache = paging.set_table_rows(cache, 0, pages)
    suf = device_breakdown(lambda: engine.prefill_suffix(
        toks, len(suffix), st, cache, 0))
    full = device_breakdown(lambda: engine.prefill(whole, n))
    paging.set_table_rows(cache, 0, [])
    sched.allocator.release(pages)
    return {"uid": uid, "prefix": st, "suffix": len(suffix),
            "suffix_pad": pad, "whole_pad": whole_pad,
            "suffix_device_ms": suf["device_ms"],
            "whole_device_ms": full["device_ms"],
            "suffix_wall_ms": suf["wall_ms"], "whole_wall_ms": full["wall_ms"],
            "suffix_top": suf["top"][:8], "whole_top": full["top"][:8]}


def phase_schedule(cfg, packed, pa, dev, smi_line):
    """The continuous-batching scheduler over olmo-1b at full width: the 24
    requests of ``schedule_requests`` through 8 slots (max_seq 1024, page
    16, decode chunk 16, prompt bucket 16), paged full bf16 (aligned hits
    through the suffix prefill), paged int8 (identical hits and
    copy-on-write) and contiguous int4; the paged pools hold 160 pages, so
    admissions are deferred and pages recycled.  Gates:

      A - each request whose admission plan is the same in both runs
          decodes the same tokens as in a serial run (the same 24, one at a
          time, through a fresh scheduler of the same spec), and at least
          GATE_A_MIN of 24 match;
      B - paged int8: an identical hit's tokens equal its donor's over
          their common length; paged full: each aligned hit's first-token
          logits against the same prompt served with share_prefixes=False,
          bit for bit where the suffix pads past GEMV_MAX_M rows, else
          within CONTROL_FACTOR x the control (``sharing_off``);
      D - the allocator's invariants after every admission and eviction;
          at least MIN_HITS registry hits and one deferral in the paged
          full run; its peak of pages in use lower with sharing than
          without; without sharing, every page back at the end.  The
          deferral and the lower peak hold for SCHED_ORDER, which was
          chosen so that they do: another order of the same requests
          need not defer, or peak lower;
      copies - device-to-host copies at most one per admission plus one
          per decode chunk;
    and every kernel of each run's path launched (and none of another's).
    """
    from repro_torch.serve import EngineSpec, Request, ServeEngine
    base = schedule_requests(cfg, np.random.default_rng(2))
    out = {}
    for name, (spec, need, never) in SCHED_RUNS.items():
        engine = ServeEngine(cfg, packed, pa, SCHED_MAX_SEQ,
                             EngineSpec(page_size=PAGE, decode_chunk=16,
                                        n_pages=SCHED_POOL, **spec),
                             device=dev)
        # one miss stops at EOS: the token its serial run emits at step 5
        first_u = next(r for r in base if r[0][0] == "u")
        probe, _ = schedule_run(engine, [first_u + (None,)], dev)
        eos_uid = first_u[0]
        eos = probe.completed[eos_uid].tokens[4]
        reqs = [r + ((eos if r[0] == eos_uid else None),) for r in base]
        del probe
        sched, rec = schedule_run(engine, reqs, dev)
        launches = rec["launches"]
        missing = sorted(k for k in need if launches[k] == 0)
        stray = sorted(k for k in never if launches[k] != 0)
        if missing or stray:
            raise RuntimeError(f"schedule {name}: the path launched no "
                               f"{missing} and launched {stray}")
        check_completions(sched, reqs, cfg.vocab)
        conc = sched
        prof_sched, prof = schedule_run(engine, reqs, dev, profile=True)
        rec["profiled"] = {k: prof[k] for k in (
            "dtoh_copies", "admissions", "chunks", "device_ms", "idle_share",
            "wall_s")}
        if prof_sched.latency_report() != rec["latency_report"] or any(
                prof_sched.completed[u].tokens != conc.completed[u].tokens
                for u, *_ in reqs):
            raise RuntimeError(f"schedule {name}: the profiled run's "
                               f"tokens or latency report differ")
        del prof_sched
        if prof["dtoh_copies"] > prof["admissions"] + prof["chunks"]:
            raise RuntimeError(f"schedule {name}: {prof['dtoh_copies']} "
                               f"device-to-host copies for "
                               f"{prof['admissions']} admissions and "
                               f"{prof['chunks']} decode chunks")
        serial = audited(engine)
        for uid, prompt, n, e in reqs:
            serial.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n,
                                  eos_id=e))
            serial.run()
        same_plan = [u for u, *_ in reqs
                     if conc.plans[u] == serial.plans[u]]
        matched = [u for u in same_plan if conc.completed[u].tokens
                   == serial.completed[u].tokens]
        rec["gate_a"] = {"same_plan": len(same_plan), "matched":
                         len(matched), "differs": sorted(set(same_plan)
                                                         - set(matched)),
                         "plans_differ": sorted(
                             u for u, *_ in reqs
                             if conc.plans[u] != serial.plans[u])}
        log(f"  schedule {name}: {rec['tokens']} tokens in "
            f"{rec['wall_s']:.2f} s ({rec['tokens_per_s']:.1f} tok/s); "
            f"{rec['admissions']} admissions, {rec['deferrals']} deferrals, "
            f"{rec['chunks']} decode chunks; pool {rec['pool_bytes'] / 1e6:.1f}"
            f" MB, peak memory "
            f"{(rec['max_memory_allocated'] or 0) / 1e9:.2f} GB; {smi_line}")
        lat = rec["latency_report"]
        log(f"    latency (model steps): TTFT p50 {lat['ttft']['p50']} max "
            f"{lat['ttft']['max']} ({lat['n_requests']} requests), "
            f"inter-token p50 {lat['inter_token']['p50']} p99 "
            f"{lat['inter_token']['p99']} max {lat['inter_token']['max']}; "
            f"wall: TTFT p50 {rec['wall_ttft_ms']['p50']:.1f} ms max "
            f"{rec['wall_ttft_ms']['max']:.1f}, stall between a request's "
            f"chunks p50 {rec['wall_chunk_stall_ms']['p50']:.1f} ms max "
            f"{rec['wall_chunk_stall_ms']['max']:.1f}")
        log(f"    profiled run: {prof['dtoh_copies']} device-to-host copies "
            f"for {prof['admissions']} admissions + {prof['chunks']} chunks;"
            f" device busy {prof['device_ms']:.1f} ms of "
            f"{prof['wall_s'] * 1e3:.1f}, idle share "
            f"{prof['idle_share']:.3f}; launches {launches}")
        log(f"    gate A: {len(matched)} of {len(reqs)} requests equal their "
            f"serial run ({len(same_plan)} with the same admission plan; "
            f"plans differ for {rec['gate_a']['plans_differ']})")
        if rec["gate_a"]["differs"] or len(matched) < GATE_A_MIN:
            raise RuntimeError(f"schedule {name}: gate A: {rec['gate_a']}")
        if conc._paged:
            log(f"    pages: peak {rec['peak_pages']} in use, "
                f"{rec['live_peak_pages']} mapped by live slots, "
                f"{rec['pages_in_use_after']} in use after; registry "
                f"{rec['registry_hits']} hits, {rec['registry_misses']} "
                f"misses; plans "
                f"{sorted(Counter(k for k, _ in conc.plans.values()).items())}")
        if name == "paged-int8":
            rec["gate_b_identical"] = identical_hits(conc, reqs)
            log(f"    gate B: identical hits equal to their donors' tokens:"
                f" {rec['gate_b_identical']}")
            if not all(rec["gate_b_identical"].values()):
                raise RuntimeError(f"schedule {name}: gate B: "
                                   f"{rec['gate_b_identical']}")
        if name == "paged-full":
            rec.update(sharing_off(cfg, packed, pa, dev, engine, conc, reqs,
                                   rec))
            rec["suffix_prefill"] = suffix_prefill_device(engine, conc,
                                                          reqs, dev)
            sp = rec["suffix_prefill"]
            log(f"    suffix prefill of {sp['uid']} ({sp['suffix']} tokens "
                f"padded to {sp['suffix_pad']} over {sp['prefix']} shared): "
                f"{sp['suffix_device_ms']:.2f} device ms against "
                f"{sp['whole_device_ms']:.2f} for the whole prompt "
                f"(padded to {sp['whole_pad']}); the largest items of each:")
            for what in ("suffix_top", "whole_top"):
                for row in sp[what][:4]:
                    log(f"      {what[:-4]:6s} {row['ms']:8.3f} ms "
                        f"x{row['count']:<4d} {row['kernel']}")
        rec["plans"] = {u: list(p) for u, p in rec["plans"].items()}
        out[name] = rec
        del engine, sched, conc, serial
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def identical_hits(sched, reqs) -> dict:
    """Each identical hit's tokens against its donor's (the first request
    with the same prompt, admitted as a miss), over their common length."""
    res = {}
    for i, (uid, prompt, _, _) in enumerate(reqs):
        if sched.plans[uid][0] != "identical":
            continue
        donor = next(u for u, p, _, _ in reqs[:i]
                     if p == prompt and sched.plans[u][0] == "miss")
        a, b = sched.completed[uid].tokens, sched.completed[donor].tokens
        n = min(len(a), len(b))
        res[f"{uid}<-{donor}"] = a[:n] == b[:n]
    return res


def sharing_off(cfg, packed, pa, dev, engine, conc, reqs, rec) -> dict:
    """Gates B (paged full) and D: the same requests with
    share_prefixes=False.  An aligned hit whose suffix pads past
    GEMV_MAX_M rows runs the same tiled quant_matmul as the whole prefill,
    so its first-token logits equal that run's bit for bit.  A shorter
    suffix takes the GEMV, which sums in another order: its gap is bounded
    by CONTROL_FACTOR x the control (the hit prompts' whole prefill, kernel
    path against impl="ref"), and the control itself by CONTROL_FACTOR x
    the plain path with its prefill attention in float64 against the plain
    path, as in phase check."""
    from repro_torch.kernels.cuda import GEMV_MAX_M
    from repro_torch.models import attention as attn
    from repro_torch.serve import EngineSpec, ServeEngine
    off, off_rec = schedule_run(engine, reqs, dev, share=False)
    hits = [u for u, p in conc.plans.items() if p[0] == "aligned"]
    if not hits:
        raise RuntimeError("schedule paged-full: no aligned prefix hit")
    ref = ServeEngine(cfg, packed, pa, SCHED_MAX_SEQ, EngineSpec(),
                      device=dev, impl="ref")
    gaps, control, control64, equal, exact = {}, {}, {}, {}, {}
    for uid in hits:
        prompt = next(p for u, p, _, _ in reqs if u == uid)
        toks = conc._prompt_tokens(prompt, conc._bucket_pad(len(prompt),
                                                            SCHED_MAX_SEQ))
        n = torch.tensor([len(prompt)])
        want, _ = ref.prefill(toks, n)
        with patched(attn, "chunked_attention", attention_f64):
            want64, _ = ref.prefill(toks, n)
        got, got_off = conc.first_logits[uid], off.first_logits[uid]
        gaps[uid] = rel_err(got, got_off)
        control[uid] = rel_err(got_off, want[0])
        control64[uid] = rel_err(want64[0], want[0])
        st = conc.plans[uid][1]
        if conc._bucket_pad(len(prompt) - st, SCHED_MAX_SEQ - st) > GEMV_MAX_M:
            exact[uid] = torch.equal(got, got_off)
        equal[uid] = conc.completed[uid].tokens == off.completed[uid].tokens
    control_bound = CONTROL_FACTOR * max(control64.values())
    bound = CONTROL_FACTOR * max(control.values())
    gemv = {u: g for u, g in gaps.items() if u not in exact}
    res = {"sharing_off": {k: off_rec[k] for k in (
               "peak_pages", "live_peak_pages", "pages_in_use_after",
               "wall_s", "tokens_per_s")},
           "gate_b_aligned": {"gap": gaps, "bit_equal": exact,
                              "control": control,
                              "control_f64": control64,
                              "control_bound": control_bound,
                              "bound": bound, "tokens_equal": equal}}
    log(f"    gate B: {len(hits)} aligned hits; first-token logits bit for "
        f"bit those of share_prefixes=False for {sum(exact.values())} of "
        f"{len(exact)} tiled suffixes; {len(gemv)} GEMV suffixes "
        f"{sorted(gemv)}, gap at most {max(gemv.values(), default=0.0):.4g} "
        f"(bound {CONTROL_FACTOR} x control {max(control.values()):.4g} = "
        f"{bound:.4g}); control within {CONTROL_FACTOR} x float64 control "
        f"{max(control64.values()):.4g} = {control_bound:.4g}; tokens equal "
        f"for {sum(equal.values())} of {len(hits)}")
    log(f"    gate D: without sharing peak {off_rec['peak_pages']} pages in "
        f"use, {off_rec['live_peak_pages']} mapped by live slots (with: "
        f"{rec['peak_pages']}, {rec['live_peak_pages']}), "
        f"{off_rec['pages_in_use_after']} in use after")
    bad = []
    if not all(exact.values()):
        bad.append(f"gate B: tiled suffixes not bit for bit: "
                   f"{sorted(u for u, e in exact.items() if not e)}")
    if not max(control.values()) <= control_bound:
        bad.append(f"gate B control {control} over {control_bound}")
    if not max(gemv.values(), default=0.0) <= bound:
        bad.append(f"gate B gap {gemv} over {bound}")
    if rec["registry_hits"] < MIN_HITS or rec["deferrals"] < 1:
        bad.append(f"gate D: {rec['registry_hits']} hits, "
                   f"{rec['deferrals']} deferrals")
    if not rec["peak_pages"] < off_rec["peak_pages"]:
        bad.append(f"gate D: peak {rec['peak_pages']} pages in use with "
                   f"sharing, {off_rec['peak_pages']} without")
    if off_rec["pages_in_use_after"] != 0:
        bad.append(f"gate D: {off_rec['pages_in_use_after']} pages in use "
                   f"after the run without sharing")
    if bad:
        raise RuntimeError(f"schedule paged-full: {bad}")
    return res


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
    def both(p, x, bits, cfg, mode, cache, positions, impl="auto",
             hvp=False):
        copy = None if cache is None else {k: v.clone()
                                           for k, v in cache.items()}
        want, _ = block_apply(p, x, bits, cfg, mode, copy, positions, "ref",
                              hvp)
        got, new = block_apply(p, x, bits, cfg, mode, cache, positions, impl,
                               hvp)
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
    from repro_torch.serve import EngineSpec, ServeEngine
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
        caches[name] = eng.splice_prefill(pre, len_t)
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


TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 16   # the train phase's batches
ALPS_B, ALPS_S, ALPS_STEPS = 4, 256, 2      # an ALPS probe's
ALPS_REF_UNITS = 4                          # units probed by impl="ref" too
# AdamW as examples/quickstart.py builds it, at OLMo-1B's published peak
# learning rate: quickstart's 2e-3 suits its smoke model (d_model 128); at
# full width 2e-3 and 1e-3 raised the loss over 16 steps on the H100
# (PERF.md §6), 4e-4 and 1e-4 lowered it
LR, GRAD_CLIP = 4e-4, 1.0
STEP_GRAD_TOL = 1e-5                        # LSQ step gradients, relative
ALPS_REF_TOL = 1e-2                         # gains, kernel vs plain path


def lsq_sites(cfg) -> dict:
    """Fake-quant sites of a train step (one launch each way, steps that
    share an input grouped): the activations of q/k/v, o, gate/up and down
    in each layer and the head's; the 7 weights of each layer and the
    embedding table twice (the gather's and the tied head's).  The
    backward recomputes each layer (checkpointing), so its activation
    sites launch the forward a second time."""
    layers = cfg.n_repeats * len(cfg.pattern)
    return {"activations": 4 * layers + 1, "weights": 7 * layers + 2,
            "recomputed": 4 * layers}


def grads_of(state, cfg, batch, impl):
    """Step 1's loss and every leaf's gradient, with no update."""
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    loss, _ = tf.loss_fn(state.params, state.policy, batch, cfg, impl)
    grads = torch.autograd.grad(loss, tree.leaves(state.params))
    return loss.detach(), [g.detach() for g in grads]


def compare_grads(state, g_kernel, g_again, g_ref) -> dict:
    """T2: each gradient finite and not all zero; each weight gradient of
    the kernel path bit for bit with impl="ref", or else equal to a second
    kernel-path run's (a difference the run itself makes); each step's
    within STEP_GRAD_TOL relative."""
    from repro_torch import tree
    rec = {"leaves": 0, "w_equal": 0, "w_differ": [], "w_unexplained": [],
           "step_max_rel": 0.0, "bad": []}
    for (path, _), a, b, c in zip(tree.flatten(state.params), g_kernel,
                                  g_again, g_ref):
        name = ".".join(str(x) for x in path)
        rec["leaves"] += 1
        if not (bool(torch.isfinite(a).all()) and bool((a != 0).any())):
            rec["bad"].append(f"{name}: not finite or all zero")
        if path[-1] == "w":
            if torch.equal(a, c):
                rec["w_equal"] += 1
            else:
                d = float((a.float() - c.float()).abs().max())
                rec["w_differ"].append((name, d))
                if torch.equal(a, b):
                    rec["w_unexplained"].append((name, d))
        else:
            rel = abs(float(a) - float(c)) / max(abs(float(c)), 1e-30)
            rec["step_max_rel"] = max(rec["step_max_rel"], rel)
            if not rel <= STEP_GRAD_TOL:
                rec["bad"].append(f"{name}: step gradient {float(a)} vs "
                                  f"{float(c)} ({rel:.3g} relative)")
    rec["bad"] += [f"{n}: w gradient differs from impl='ref' by {d}, and "
                   f"two kernel-path runs agree" for n, d in
                   rec["w_unexplained"]]
    return rec


def phase_train(cfg, dev, smi_line):
    """QAT of olmo-1b at full width and depth (weights from seed 0, bf16),
    uniform 4-bit, AdamW (lr LR, clip 1.0, float32 moments), the port's
    synthetic batches of 8 x 512 tokens, TRAIN_STEPS steps.  Gates: (T1)
    step 1's loss on the kernel path equals impl="ref"'s bit for bit; (T2)
    ``compare_grads``; (T3) the mean loss of the last 4 steps below step
    1's; (T4) each step launches the LSQ forward once a site and once more
    a recomputed site, and the backward once a site; (T5) no
    flash_attention, quant_matmul or decode attention launch.  Readings:
    ms/step on the host clock (synchronized), tokens/s, MFU, peak memory,
    and a profiled step (device ms, idle share, top 20, LSQ ms).  Returns
    the final state and the record."""
    import functools
    from repro_torch import tree
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import init_train_state, make_train_step
    policy = tf.build_policy(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, functools.partial(
        AdamW, learning_rate=LR, grad_clip=GRAD_CLIP), 0, policy, device=dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    batches = [make_batch(0, i, TRAIN_B, TRAIN_S, cfg.vocab, device=dev)
               for i in range(TRAIN_STEPS + 1)]
    sites = lsq_sites(cfg)
    n_sites = sites["activations"] + sites["weights"]

    # T1, T2: step 1 before any update, the kernel path twice and the plain
    t0 = time.perf_counter()
    cuda.reset_launches()
    loss_k, g_k = grads_of(state, cfg, batches[0], "auto")
    once = dict(cuda.LAUNCHES)
    _, g_again = grads_of(state, cfg, batches[0], "auto")
    loss_r, g_r = grads_of(state, cfg, batches[0], "ref")
    torch.cuda.synchronize()
    grads = compare_grads(state, g_k, g_again, g_r)
    t1_equal = torch.equal(loss_k, loss_r)
    del g_k, g_again, g_r
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    log(f"  step 1, kernel path vs impl='ref': loss {float(loss_k):.6f} vs "
        f"{float(loss_r):.6f} (bit for bit: {t1_equal}); {grads['leaves']} "
        f"leaves, w gradients bit for bit {grads['w_equal']}, differing "
        f"{grads['w_differ'][:4]}, step gradients within "
        f"{grads['step_max_rel']:.3g} relative ({check_s:.1f} s)")

    step = make_train_step(cfg, impl="auto")
    losses, wall = [], []
    torch.cuda.synchronize()
    cuda.reset_launches()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        losses.append(float(m["loss"]))        # a sync
        wall.append(time.perf_counter() - t0)
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prof = device_breakdown(lambda: step(state, batches[TRAIN_STEPS]))
    ms = float(np.median(wall[1:])) * 1e3
    tokens = TRAIN_B * TRAIN_S
    rec = {"config": f"{cfg.name} d_model={cfg.d_model} layers="
                     f"{cfg.n_repeats} heads={cfg.n_heads} d_ff={cfg.d_ff} "
                     f"vocab={cfg.vocab} {cfg.param_dtype}",
           "device": smi_line, "batch": [TRAIN_B, TRAIN_S],
           "steps": TRAIN_STEPS, "n_params": n_params, "losses": losses,
           "step_ms": [w * 1e3 for w in wall], "ms_per_step": ms,
           "first_step_ms": wall[0] * 1e3,
           "tokens_per_s": tokens / (ms / 1e3),
           "mfu": 6.0 * n_params * tokens / ((ms / 1e3) * BF16_OPS_PER_S),
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "launches_step1_grads": once, "sites": sites, "grads": grads,
           "t1_loss_equal": t1_equal, "profile": prof,
           "last4_mean": float(np.mean(losses[-4:]))}
    rec["t3_margin"] = losses[0] - rec["last4_mean"]
    log(f"  {rec['config']}: {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (last 4 mean "
        f"{rec['last4_mean']:.4f}, margin {rec['t3_margin']:.4f})")
    log(f"  {ms:.1f} ms/step (host clock, median of steps 2-{TRAIN_STEPS}; "
        f"step 1 {wall[0] * 1e3:.1f}), {rec['tokens_per_s']:.0f} tokens/s, "
        f"MFU {rec['mfu']:.4f} (6 N tokens, N = {n_params}, at 989 TFLOP/s);"
        f" peak {rec['peak_gib']:.2f} GiB; launches {launches}")
    log_breakdown("one train step", prof)
    log(f"    lsq_fakequant_bwd {prof['lsq_fakequant_bwd_ms']:.3f} ms; top "
        f"20: " + "; ".join(f"{r['kernel'][:48]} {r['ms']:.2f} x{r['count']}"
                            for r in prof["top"]))
    bad = list(grads["bad"])
    if not t1_equal:
        bad.append(f"T1: loss {float(loss_k)} vs impl='ref' {float(loss_r)}")
    if not rec["last4_mean"] < losses[0]:
        bad.append(f"T3: last 4 steps' mean {rec['last4_mean']} not below "
                   f"step 1's {losses[0]}")
    want = {"lsq_fakequant": TRAIN_STEPS * (n_sites + sites["recomputed"]),
            "lsq_fakequant_bwd": TRAIN_STEPS * n_sites}
    for name, n in want.items():
        if launches[name] != n:
            bad.append(f"T4: {name} launched {launches[name]} times, "
                       f"{n} expected ({sites}, {TRAIN_STEPS} steps)")
    for name in ("flash_attention", "quant_matmul", "kv_decode_attention",
                 "paged_kv_decode_attention"):
        if launches[name]:
            bad.append(f"T5: {name} launched {launches[name]} times")
    if bad:
        raise RuntimeError(f"train phase: {bad}")
    return state, rec


def phase_alps(cfg, dev, state, smi_line):
    """ALPS over every selectable unit from the train phase's final state
    (ALPS_STEPS steps a probe at ALPS_B x ALPS_S on make_batch(11, i)),
    then EAGL through the histogram kernel on the same weights; the
    knapsack take at budget 0.7 from each, their overlap, and their wall
    seconds.  Gates: (A1) after ALPS the params equal the b_hi state bit
    for bit; (A2) the first unit's probe, run again at the end, gives its
    gain bit for bit; (A3) on ALPS_REF_UNITS units the kernel path's gains
    within ALPS_REF_TOL relative of impl="ref"'s."""
    from repro_torch import tree
    from repro_torch.core import knapsack
    from repro_torch.core.metrics import (AlpsConfig, alps_gains,
                                          eagl_gains, make_probe)
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import make_train_step
    policy = tf.build_policy(cfg)
    units = policy.selectable_units()
    batches = [make_batch(11, i, ALPS_B, ALPS_S, cfg.vocab, device=dev)
               for i in range(ALPS_STEPS)]
    b_hi = [p.detach().clone() for p in tree.leaves(state.params)]
    probe = make_probe(state, make_train_step(cfg, impl="auto"),
                       lambda i: batches[i])
    acfg = AlpsConfig(steps_per_probe=ALPS_STEPS)
    sync(dev)
    cuda.reset_launches()
    t0 = time.perf_counter()
    gains = alps_gains(policy, probe_finetune=probe, cfg=acfg)
    sync(dev)
    alps_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    a1 = all(torch.equal(p.detach(), q) for p, q in
             zip(tree.leaves(state.params), b_hi))
    first = units[0]
    again = probe(policy=policy.apply_selection({first.name: False}),
                  steps=ALPS_STEPS)["loss"]
    a2 = again == gains[first.name]
    ref_probe = make_probe(state, make_train_step(cfg, impl="ref"),
                           lambda i: batches[i])
    a3 = {}
    for u in units[:ALPS_REF_UNITS]:
        g = ref_probe(policy=policy.apply_selection({u.name: False}),
                      steps=ALPS_STEPS)["loss"]
        a3[u.name] = abs(gains[u.name] - g) / abs(g)
    del b_hi
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        eagl = eagl_gains(policy, lambda u, t: tf.fetch_unit_tensor(
            state.params, u, t), impl="auto")
        sync(dev)
        eagl_s = time.perf_counter() - t0
    take_a = knapsack.select_for_budget(policy, gains, budget_frac=0.7).take
    take_e = knapsack.select_for_budget(policy, eagl, budget_frac=0.7).take
    overlap = sum(take_a[u.name] == take_e[u.name] for u in units)
    rec = {"device": smi_line, "units": len(units), "batch": [ALPS_B, ALPS_S],
           "steps_per_probe": ALPS_STEPS, "alps_s": alps_s,
           "eagl_s": eagl_s, "alps_over_eagl": alps_s / eagl_s,
           "launches": launches, "gains": gains, "eagl": eagl,
           "a1_params_equal": a1, "a2_again": again, "a2_equal": a2,
           "a3_rel": a3, "take_alps": take_a, "take_eagl": take_e,
           "n4_alps": sum(take_a.values()), "n4_eagl": sum(take_e.values()),
           "overlap": overlap}
    log(f"  ALPS over {len(units)} units ({ALPS_STEPS} steps a probe at "
        f"{ALPS_B} x {ALPS_S}): {alps_s:.1f} s; EAGL through the histogram "
        f"kernel {eagl_s:.3f} s: ALPS / EAGL = {rec['alps_over_eagl']:.0f}")
    log(f"  gains (mean probe loss) {min(gains.values()):.4f} to "
        f"{max(gains.values()):.4f}; knapsack at 0.7: ALPS keeps "
        f"{rec['n4_alps']} units at 4 bits, EAGL {rec['n4_eagl']}; the "
        f"takes agree on {overlap} of {len(units)}")
    log(f"  A1 params equal b_hi: {a1}; A2 {first.name} again "
        f"{again!r} vs {gains[first.name]!r}: {a2}; A3 kernel vs ref "
        f"relative {', '.join(f'{v:.3g}' for v in a3.values())}; launches "
        f"{launches}")
    bad = []
    if not a1:
        bad.append("A1: the params after ALPS differ from the b_hi state")
    if not a2:
        bad.append(f"A2: {first.name}'s probe gave {again}, ALPS "
                   f"{gains[first.name]}")
    if not all(v <= ALPS_REF_TOL for v in a3.values()):
        bad.append(f"A3: kernel vs impl='ref' gains {a3}")
    if bad:
        raise RuntimeError(f"alps phase: {bad}")
    return rec


HAWQ_SEED_BATCH = 5            # frontier_bench's HAWQ batch, make_batch(5, 0)
HAWQ_REF_PROBES = 2            # probes of H3's kernel vs impl="ref" traces
# H3: kernel route's traces against impl="ref"'s, relative to the largest
# |trace|; measured 0 on the H100 (the products' forward kernel equals its
# plain version bit for bit, as in T1, and their LSQ backward is the same
# torch ops on both routes)
HAWQ_REF_TOL = 1e-6
FRONTIER_BUDGETS = (0.9, 0.75, 0.6)   # frontier_bench.run's defaults
FRONTIER_STEPS = 4                    # fine-tune steps a point
FRONTIER_EVAL = 2                     # held-out batches, make_batch(123, i)
JOINT_BUDGET, JOINT_CONTEXT = 0.7, 1024   # the joint knapsack's log line


def params_equal(state, saved) -> bool:
    from repro_torch import tree
    return all(torch.equal(p.detach(), q) for p, q in
               zip(tree.leaves(state.params), saved))


def phase_hawq(cfg, dev, state, alps, smi_line):
    """HAWQ-v3 over every selectable unit from the trained state:
    ``HawqConfig()`` (8 Rademacher probes from the port's generator), one
    batch make_batch(5, 0) at ALPS_B x ALPS_S, per-layer paths, each probe
    one ``torch.func.jvp`` of ``torch.func.grad`` of ``hawq.hvp_loss``
    (train mode without checkpointing, the LSQ backward in torch ops).
    Readings: wall seconds beside the alps phase's ALPS and EAGL seconds,
    peak memory, the LSQ forward's route (its launches), the knapsack take
    at 0.7 and its overlap with ALPS's and EAGL's.  Gates: (H1) every gain
    finite; (H2) the params after HAWQ equal the b_hi state bit for bit;
    (H3) on ALPS_REF_UNITS units, with the same HAWQ_REF_PROBES injected
    probes, the kernel route's traces within HAWQ_REF_TOL of impl="ref"'s
    (relative to the largest); (H4) no lsq_fakequant_bwd launch during the
    products."""
    from repro_torch import tree
    from repro_torch.core import knapsack
    from repro_torch.core.metrics import hawq
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    policy = tf.build_policy(cfg)
    units = policy.selectable_units()
    pa = policy.as_arrays()
    batch = make_batch(HAWQ_SEED_BATCH, 0, ALPS_B, ALPS_S, cfg.vocab,
                       device=dev)
    b_hi = [p.detach().clone() for p in tree.leaves(state.params)]
    hcfg = hawq.HawqConfig()
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    gains = hawq.hawq_gains(policy, hawq.hvp_loss(cfg, pa, "auto"),
                            state.params, None, hcfg, batch)
    sync(dev)
    hawq_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    h1 = all(math.isfinite(g) for g in gains.values())
    h2 = params_equal(state, b_hi)
    del b_hi

    paths = hawq.unit_tensor_paths(policy)
    some = {k: v for k, v in paths.items()
            if k.split("/")[0] in {u.name for u in units[:ALPS_REF_UNITS]}}
    probes = list(hawq.rademacher_probes(
        state.params, hawq.HawqConfig(n_probes=HAWQ_REF_PROBES, seed=1)))
    traces = {impl: hawq.hutchinson_traces(hawq.hvp_loss(cfg, pa, impl),
                                           state.params, some, hcfg, batch,
                                           probes=probes)
              for impl in ("auto", "ref")}
    del probes
    top = max(abs(v) for v in traces["ref"].values())
    h3 = max(abs(traces["auto"][k] - traces["ref"][k]) for k in some) / top

    take_h = knapsack.select_for_budget(policy, gains, budget_frac=0.7).take
    rec = {"device": smi_line, "units": len(units), "probes": hcfg.n_probes,
           "batch": [ALPS_B, ALPS_S], "hawq_s": hawq_s,
           "alps_s": alps["alps_s"], "eagl_s": alps["eagl_s"],
           "hawq_over_eagl": hawq_s / alps["eagl_s"],
           "alps_over_hawq": alps["alps_s"] / hawq_s,
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "forward_route": ("lsq_fakequant kernel"
                             if launches["lsq_fakequant"] else "plain"),
           "gains": gains, "h1_finite": h1, "h2_params_equal": h2,
           "h3_rel": h3, "h3_traces": traces, "take_hawq": take_h,
           "n4_hawq": sum(take_h.values()),
           "overlap_alps": sum(take_h[u.name] == alps["take_alps"][u.name]
                               for u in units),
           "overlap_eagl": sum(take_h[u.name] == alps["take_eagl"][u.name]
                               for u in units)}
    log(f"  HAWQ-v3 over {len(units)} units ({hcfg.n_probes} probes, "
        f"{ALPS_B} x {ALPS_S} tokens): {hawq_s:.2f} s; ALPS "
        f"{alps['alps_s']:.1f} s, EAGL {alps['eagl_s']:.3f} s: ALPS / HAWQ "
        f"= {rec['alps_over_hawq']:.2f}, HAWQ / EAGL = "
        f"{rec['hawq_over_eagl']:.0f}; peak {rec['peak_gib']:.2f} GiB; the "
        f"products' LSQ forward: {rec['forward_route']} "
        f"({launches['lsq_fakequant']} launches), backward launches "
        f"{launches['lsq_fakequant_bwd']}")
    log(f"  gains {min(gains.values()):.4g} to {max(gains.values()):.4g}; "
        f"knapsack at 0.7 keeps {rec['n4_hawq']} units at 4 bits; agrees "
        f"with ALPS's take on {rec['overlap_alps']}, EAGL's on "
        f"{rec['overlap_eagl']} of {len(units)}")
    log(f"  H1 finite: {h1}; H2 params equal b_hi: {h2}; H3 kernel vs ref "
        f"traces {h3:.3g} of the largest ({len(some)} tensors, "
        f"{HAWQ_REF_PROBES} probes); H4 backward launches "
        f"{launches['lsq_fakequant_bwd']}")
    bad = []
    if not h1:
        bad.append("H1: a HAWQ gain is not finite")
    if not h2:
        bad.append("H2: the params after HAWQ differ from the b_hi state")
    if not h3 <= HAWQ_REF_TOL:
        bad.append(f"H3: kernel vs impl='ref' traces {h3} of the largest")
    if launches["lsq_fakequant_bwd"]:
        bad.append(f"H4: lsq_fakequant_bwd launched "
                   f"{launches['lsq_fakequant_bwd']} times in the products")
    if bad:
        raise RuntimeError(f"hawq phase: {bad}")
    return rec


def phase_frontier(cfg, dev, state, gains, smi_line):
    """``frontier.sweep`` over eagl, alps, hawq_v3, uniform, first_to_last
    and last_to_first (``gains``: method -> gains, None for the greedy
    ones) at FRONTIER_BUDGETS.  Each point restores the b_hi state,
    fine-tunes FRONTIER_STEPS steps (make_batch(7, i), frontier_bench's
    fine-tune seed, at ALPS_B x ALPS_S, the train phase's AdamW) and
    evaluates the mean loss on FRONTIER_EVAL held-out batches
    (make_batch(123, i), benchmarks/common.eval_loss); the b_hi state
    under uniform 4 and 2 bits is evaluated the same way, and the joint
    weight-and-cache take of EAGL's gains with synthetic cache gains is
    logged.  Gates: (F1) each point's achieved cost at or under its
    budget, to the knapsack's weight_resolution for each unit it keeps;
    (F2) its n_dropped the number of b_lo units of its policy, its loss
    finite; (F3) the params after the sweep equal the b_hi state bit for
    bit; (F4) the fine-tunes' LSQ launches the points x steps x a train
    step's (lsq_sites).  The losses are reported, not gated."""
    from repro_torch.core import costs, frontier, knapsack
    from repro_torch.core.metrics.alps import StateCopy
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    from repro_torch.train.step import make_train_step
    policy = tf.build_policy(cfg)
    ft = [make_batch(7, i, ALPS_B, ALPS_S, cfg.vocab, device=dev)
          for i in range(FRONTIER_STEPS)]
    held = [make_batch(123, i, ALPS_B, ALPS_S, cfg.vocab, device=dev)
            for i in range(FRONTIER_EVAL)]
    saved = StateCopy(state)
    step = make_train_step(cfg, impl="auto")
    ft_launches = Counter()

    @torch.no_grad()
    def evaluate(pa):
        out = [tf.loss_fn(state.params, pa, b, cfg, "auto")
               for b in held]
        return {"loss": float(torch.stack([o[0] for o in out]).mean()),
                "accuracy": float(torch.stack(
                    [o[1]["accuracy"] for o in out]).mean())}

    def finetune_eval(policy=None):
        saved.restore(state)
        state.policy = policy.as_arrays()
        try:
            before = dict(cuda.LAUNCHES)
            train = [step(state, b)[1]["loss"] for b in ft]
            ft_launches.update({k: cuda.LAUNCHES[k] - before[k]
                                for k in before})
            return dict(evaluate(state.policy),
                        train_loss=[float(x) for x in train])
        finally:
            saved.restore(state)

    sync(dev)
    cuda.reset_launches()
    t0 = time.perf_counter()
    points = frontier.sweep(policy, gains, finetune_eval,
                            list(FRONTIER_BUDGETS))
    sync(dev)
    sweep_s = time.perf_counter() - t0
    uniform = {b: evaluate(policy.uniform(b).as_arrays())
               for b in (policy.b_hi, policy.b_lo)}
    f3 = params_equal(state, saved.params)
    del saved

    bmacs_hi = costs.bmacs(policy.uniform(policy.b_hi))
    rows, bad = [], []
    for pt in points:
        mixed = frontier.select_policy(policy, pt.method, gains[pt.method],
                                       pt.budget_frac)
        n_lo = sum(mixed.bits_of(u.name) == policy.b_lo
                   for u in policy.selectable_units())
        slack = 0.0
        if gains[pt.method] is not None:
            res = knapsack.select_for_budget(policy, gains[pt.method],
                                             pt.budget_frac)
            slack = sum(res.take.values()) * res.weight_resolution / bmacs_hi
        row = {"method": pt.method, "budget": pt.budget_frac,
               "achieved": pt.achieved_cost_frac, "slack": slack,
               "n_dropped": pt.n_dropped, "n_lo": n_lo,
               "compression": pt.compression_ratio, **pt.task_metrics}
        rows.append(row)
        if not pt.achieved_cost_frac <= pt.budget_frac + slack + 1e-12:
            bad.append(f"F1: {pt.method} at {pt.budget_frac}: achieved "
                       f"{pt.achieved_cost_frac} (slack {slack})")
        if pt.n_dropped != n_lo or not math.isfinite(row["loss"]):
            bad.append(f"F2: {pt.method} at {pt.budget_frac}: n_dropped "
                       f"{pt.n_dropped}, b_lo units {n_lo}, loss "
                       f"{row['loss']}")
    sites = lsq_sites(cfg)
    n_sites = sites["activations"] + sites["weights"]
    steps = len(points) * FRONTIER_STEPS
    want = {"lsq_fakequant": steps * (n_sites + sites["recomputed"]),
            "lsq_fakequant_bwd": steps * n_sites}
    for name, n in want.items():
        if ft_launches[name] != n:
            bad.append(f"F4: the fine-tunes launched {name} "
                       f"{ft_launches[name]} times, {n} expected")
    if not f3:
        bad.append("F3: the params after the sweep differ from the b_hi "
                   "state")

    cache_gains = knapsack.synthetic_cache_gains(policy)
    joint = knapsack.select_weights_and_cache(
        policy, gains["eagl"], cache_gains, JOINT_BUDGET, JOINT_CONTEXT)
    n_cache8 = sum(joint.take[c.name]
                   for c in policy.selectable_cache_units())
    n_w4 = sum(joint.take[u.name] for u in policy.selectable_units())
    rec = {"device": smi_line, "budgets": list(FRONTIER_BUDGETS),
           "steps_per_point": FRONTIER_STEPS, "eval_batches": FRONTIER_EVAL,
           "batch": [ALPS_B, ALPS_S], "sweep_s": sweep_s, "points": rows,
           "uniform_4bit": uniform[policy.b_hi],
           "uniform_2bit": uniform[policy.b_lo],
           "finetune_launches": dict(ft_launches),
           "launches_after": dict(cuda.LAUNCHES), "f3_params_equal": f3,
           "joint": {"budget": JOINT_BUDGET, "context": JOINT_CONTEXT,
                     "cache_int8": n_cache8,
                     "cache_units": len(policy.selectable_cache_units()),
                     "weights_4bit": n_w4,
                     "kv_bytes_per_token": policy.apply_cache_selection(
                         joint.take).kv_bytes_per_token()}}
    log(f"  {len(points)} points ({len(gains)} methods x "
        f"{len(FRONTIER_BUDGETS)} budgets), {FRONTIER_STEPS} fine-tune "
        f"steps each at {ALPS_B} x {ALPS_S}: {sweep_s:.1f} s; eval loss "
        f"uniform 4-bit {uniform[policy.b_hi]['loss']:.4f}, uniform 2-bit "
        f"{uniform[policy.b_lo]['loss']:.4f}")
    for r in rows:
        log(f"    {r['method']:14s} budget {r['budget']:.2f} achieved "
            f"{r['achieved']:.4f} dropped {r['n_dropped']:2d} comp "
            f"{r['compression']:.2f}x loss {r['loss']:.4f} acc "
            f"{r['accuracy']:.4f}")
    log(f"  joint weight-and-cache knapsack (EAGL gains, synthetic cache "
        f"gains, budget {JOINT_BUDGET}, context {JOINT_CONTEXT}): "
        f"{n_cache8} of {rec['joint']['cache_units']} cache layers stay "
        f"int8, {n_w4} weight units stay 4-bit")
    log(f"  F3 params equal b_hi: {f3}; fine-tune launches "
        f"{dict(ft_launches)} (expected {want})")
    if bad:
        raise RuntimeError(f"frontier phase: {bad}")
    return rec


def selection_methods(policy, alps, hawq) -> dict:
    """The frontier's methods, as benchmarks/frontier_bench.py names them:
    method -> gains (None for the greedy baselines)."""
    from repro_torch.core.metrics import uniform_gains
    return {"eagl": alps["eagl"], "alps": alps["gains"],
            "hawq_v3": hawq["gains"], "uniform": uniform_gains(policy),
            "first_to_last": None, "last_to_first": None}


def main():
    smi_line = phase_device()
    from repro_torch.configs import olmo_1b
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
              "lsq_fakequant": check_lsq(timer, dev, gen),
              "lsq_fakequant_bwd": check_lsq_bwd(timer, dev, gen),
              "histogram": check_histogram(timer, dev, gen),
              "paged_kv_decode_attention": check_paged_kv_decode(timer, dev,
                                                                 gen)}
    bad = [(name, c) for name, (_, cases) in checks.items() for c in cases
           if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    del timer
    torch.cuda.empty_cache()

    cfg = olmo_1b.config()
    log(f"select: {cfg.name} d_model={cfg.d_model} layers={cfg.n_repeats} "
        f"heads={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab}")
    t0 = time.perf_counter()
    raw = tf.init_params(cfg, seed=0, device=dev)
    mixed, select = phase_select(cfg, raw, dev)
    if select["launches"]["histogram"] != select["tensors"]:
        raise RuntimeError(f"EAGL launched the histogram kernel "
                           f"{select['launches']['histogram']} times for "
                           f"{select['tensors']} tensors")
    pa = mixed.as_arrays()
    packed = pack_params(raw, pa, cfg, device=dev)
    del raw
    torch.cuda.synchronize()
    log(f"  init + select + pack {time.perf_counter() - t0:.1f} s")
    tokens, lengths = make_prompts(cfg, np.random.default_rng(0))
    log("serve:")
    runs = phase_serve(cfg, packed, pa, dev, tokens, lengths)
    log("schedule (continuous batching, prefix sharing):")
    schedule = phase_schedule(cfg, packed, pa, dev, smi_line)
    log("check (kernel path vs plain path):")
    check = phase_check(cfg, packed, pa, dev, tokens, lengths)
    del packed       # the serve state: the train phase starts from none
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("train (4-bit LSQ QAT):")
    t0 = time.perf_counter()
    state, train = phase_train(cfg, dev, smi_line)
    log(f"  train phase {time.perf_counter() - t0:.1f} s")
    log("alps (from the trained state):")
    t0 = time.perf_counter()
    alps = phase_alps(cfg, dev, state, smi_line)
    log(f"  alps phase {time.perf_counter() - t0:.1f} s")
    log("hawq (HAWQ-v3 from the trained state):")
    t0 = time.perf_counter()
    hawq = phase_hawq(cfg, dev, state, alps, smi_line)
    log(f"  hawq phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    log("frontier (six methods, three budgets):")
    t0 = time.perf_counter()
    front = phase_frontier(cfg, dev, state, selection_methods(
        tf.build_policy(cfg), alps, hawq), smi_line)
    log(f"  frontier phase {time.perf_counter() - t0:.1f} s")
    del state

    # each kernel's launches on the path that runs it
    launches = dict(runs["contiguous-int8"]["launches"])
    launches["paged_kv_decode_attention"] = \
        runs["paged-int8"]["launches"]["paged_kv_decode_attention"]
    launches["histogram"] = select["launches"]["histogram"]
    launches["lsq_fakequant_bwd"] = train["launches"]["lsq_fakequant_bwd"]
    kernels = []
    for name, (head, _) in checks.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{cuda.source_of(name)}.cu",
            "replaces": TPU_SOURCES[name], "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"]})
    tiled_head = next(c for c in checks["quant_matmul"][1]
                      if (c["bits"], c["m"], c["k"], c["n"])
                      == (4, 4096, 2048, 8192))
    OUT.mkdir(exist_ok=True)
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"device": smi_line, "build_s": build_s,
                   "quant_matmul": {"decode_head": checks["quant_matmul"][0],
                                    "tiled_head": tiled_head},
                   "flash_attention": {
                       "prefill_head": checks["flash_attention"][0]},
                   "kernels": {k: cases for k, (_, cases) in checks.items()},
                   "select": select, "serve": runs,
                   "schedule": schedule, "check": check,
                   "train": train, "alps": alps, "hawq": hawq,
                   "frontier": front,
                   "launch_counts_after": dict(cuda.LAUNCHES)}, f, indent=1)
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
