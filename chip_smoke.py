#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi); no card fails.
  2. build   - nvcc builds the kernels from src/repro_torch/csrc into
               build/kernels/ (parallel, one process per source).
  3. kernels - each of the eight kernels against its plain PyTorch version at
               the main paths' shapes (olmo-1b's and bert-base's, and the
               zoo's: quant_matmul at granite-20b's and deepseek-7b's
               projections, dbrx-132b's experts at M = 8 and 1280 and
               qwen2-vl-7b's four projections at M = 8 and 4096,
               decode attention at granite's 48 query heads on one KV
               head, dbrx's 48 on 8 and qwen's 28 on 4 in both layouts,
               flash_attention at granite's MQA prefill, dbrx's GQA 48/8,
               qwen's 28/4, hubert-xlarge's head_dim 80, not causal, and
               deepseek-v3's MLA prefill, 128 heads at head_dim 192 with V
               zero past column 128; quant_matmul at deepseek-v3's MLA,
               prefix and expert projections), with its tolerance,
               kernel / plain / library times (CUDA events, warm-up
               excluded, L2 flushed) and bound; the decode GEMV's shapes
               also in device time alone
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
               (repeat, one device op a call) bit for bit; the float32 flash
               kernel at bert-base's prefill shape beside float32 SDPA, then
               causal, ragged, GQA, D = 128 and Sk > Sq, the precision probe
               and HGMMA in its SASS (check_flash_f32); quant_matmul on
               float32 x at bert-base's four projection shapes, M = 32 x
               384, bits 4 and 2, beside PyTorch's same function, the
               rounding probe bit for bit and a digest of the outputs
               (check_quant_matmul_f32).
  select     - EAGL gains of olmo-1b at full width, weights drawn on the
               card from seed 0, through the histogram kernel and through
               impl="ref" (the same knapsack take), and the 4/2 mix the
               knapsack takes from them at budget 0.7.
  4. serve   - that mix packed, 8 prompts of 128-512 tokens right-padded to
               512, 64 new tokens, max_seq 1024, over an int8 and an int4
               KV cache, contiguous and paged (page 16; the same tokens);
               counts every kernel's launches (a decode step's and a
               prefill's against ``step_launches``: 7 quant_matmul and
               4 lsq_fakequant a layer, the head's lsq_fakequant, one
               attention a layer); the decode steps timed apart, no
               device-to-host copy in 8 decode steps (every run), and for
               the int8 runs a torch.profiler breakdown of one prefill and
               8 decode steps.
  schedule   - the continuous-batching scheduler over that mix (the first
               SCHED_DEPTH layers of olmo-1b, at full width): 24
               requests (12 sharing a 256-token system prompt, 4 repeats, 8
               unique; 8-32 new tokens) through 8 slots, paged full bf16,
               paged int8 and contiguous int4, pools of 160 pages; gates A
               (equal to a serial run), B (sharing on against off), D
               (allocator, hits, deferrals, pages) and the device-to-host
               copies (see phase_schedule).
  5. check   - kernel path against the plain path (impl="ref") on the same
               weights, teacher-forced with the kernel path's tokens over
               the prefill and 16 decode steps, beside two controls: the
               plain path with its prefill attention in float64, and in
               float32 with bf16 probabilities (see phase_check).
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
  joint      - that take served: per-layer int8/int4 KV-cache bits and the
               4/2 weights, packed over contiguous and paged mixed caches
               and in the fake-quant layout, phase 4's traffic; gates J1-J5
               (layouts and bytes, paged tokens, launches, codes, teacher-
               forced logits; see phase_joint).
  bert       - bert-base at its published widths and depth (float32,
               bidirectional, GeLU, LayerNorm, untied head): 4-bit QAT at
               32 x 384, EAGL, ALPS, HAWQ-v3, the frontier, and the packed
               forward of EAGL's take through the float32 flash kernel and
               quant_matmul; gates B2-B6 (see phase_bert).
  zoo        - internlm2-1.8b, deepseek-7b and granite-20b (MQA, 48:1) in
               turn, each at its published widths, its first 4 layers
               (ZOO), from seed 0:
               EAGL's take at 0.7 packed, 8 prompts with 32 new tokens over
               contiguous int8 and int4 and paged int4 caches, the kernel
               path teacher-forced against the plain path; gates Z1-Z4
               (see phase_zoo).
  hubert     - hubert-xlarge at its published widths and depth (bf16,
               frame embeddings, no RoPE, head_dim 80): EAGL's take packed
               and its forward of 8 x 1000 frames through flash_attention
               at D = 80 (see phase_hubert).
  dbrx       - dbrx-132b's mixture of experts (16 experts, top-4, GQA
               48/8, LayerNorm) at its published widths, its first
               DBRX_DEPTH layers: the zoo's phase and gates Z1-Z4, each
               expert its own 4/2-bit unit, every expert projection through
               quant_matmul and every expert activation through
               lsq_fakequant, and the schedule's paged full run over its
               first SCHED_DEPTH layers (gates A, B, D; each admission
               prefill's dropped slots counted) (phase_zoo).
  dbrx method - the paper's method over those experts, dbrx-132b's first
               DBRX_TRAIN_DEPTH layer at full width: 4-bit LSQ QAT with
               int8 AdamW moments (T1-T5), ALPS (A1-A3), HAWQ-v3 per
               expert (H1-H4, distinct gains in each bank) and the frontier
               of EAGL, ALPS and HAWQ-v3 at two budgets (F1-F4)
               (phase_dbrx_method).
  qwen       - qwen2-vl-7b (M-RoPE, GQA 28/4, d_ff 18944, vocab 152064)
               at its published widths and depth: the zoo's phase and gates
               Z1-Z4 over text (the three position streams equal), Z5 (an
               8 x 512 prefill opening with an image's distinct (t, h, w)
               streams, kernel path against plain path), and the
               schedule's paged full run over its first SCHED_DEPTH layers
               (suffix prefills at shifted streams; gates A, B, D).
  deepseek-v3 - deepseek-v3-671b (MLA: q_lora 1536, kv_lora 512, nope /
               rope / v 128 / 64 / 128, 128 heads; vocab 129280) at its
               published widths: its 3 dense prefix layers (d_ff 18432)
               and its first DSV3_DEPTH MoE layer (256 experts, top-8, a
               shared expert): the zoo's phase and gates Z1-Z4 over one
               contiguous full-cache run (the latent is never quantized
               or paged): prefill through flash_attention at head_dim
               192, the absorbed decode in plain products.
The second-to-last line is the kernels JSON, the last the device JSON.
Details go to chiprun_out/chip_smoke.json and chiprun_out/build_log.txt.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

# the caching allocator maps growing segments instead of splitting fixed
# ones: the dbrx method phase churns multi-GB tensors (a 617 M-element
# token table's moments and copies), and split blocks left 8-11 GiB
# reserved and unusable on the H100 (PERF.md §6, PR 29)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
    # the float32 case of the same Pallas kernel (bert-base's prefill)
    "flash_attention_f32": "src/repro/kernels/flash_attention.py:318",
    # quant_matmul on float32 x (bert-base's packed forward)
    "quant_matmul_f32": "src/repro/kernels/quant_matmul.py:72",
}
# a check's kernel, where the check is named after one of its cases
KERNEL_OF = {"quant_matmul_f32": "quant_matmul"}
PAGE = 16                        # the paged serve runs' page size
# BERT's SQuAD v1.1 fine-tuning shape: 32 sequences of 384 tokens, for the
# bert phase's training and its packed forward
BERT_B, BERT_S = 32, 384


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
QMM_F32_TOL = 1e-5       # of max|ref|, float32 x and output (see below)


def qmm_case(timer, dev, gen, bits, m, k, n, wp=None, x=None,
             dtype=torch.bfloat16, alone=False):
    """One quant_matmul shape against its plain version, timed beside
    cuBLAS bf16 on bf16(x) and the dequantized weight.  x of ``dtype``: in
    bf16 within 1 bf16 ulp of max|ref| (the output's rounding); in float32,
    on a tensor-core route, within QMM_F32_TOL of max|ref| (both sides
    multiply bf16(x) by exact codes and sum in float32, in other orders;
    a code off by one moves an output by |x| x scale, typically 3e-4 to
    6e-4 of max|ref| at bert-base's shapes).  A GEMV shape (M <= 16) is
    also read in device time alone (``device_us``); so is, where ``alone``,
    a tiled shape beside the library's same function (on bf16 x cuBLAS
    bf16)."""
    from repro_torch.kernels import cuda, ref
    unpack = ref.unpack_w4 if bits == 4 else ref.unpack_w2
    if wp is None:
        lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
        codes = torch.randint(lo, hi, (k, n), generator=gen, device=dev)
        wp = (ref.pack_w4 if bits == 4 else ref.pack_w2)(codes)
    if x is None:
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    got = cuda.quant_matmul(x, wp, scale, bits).float()
    plain = ref.quant_matmul_w4 if bits == 4 else ref.quant_matmul_w2
    want = plain(x, wp, scale)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if x.dtype == torch.bfloat16:
        tol, tol_is = bf16_ulp(float(want.abs().max())), "1 bf16 ulp"
    else:
        tol, tol_is = QMM_F32_TOL * float(want.abs().max()), "1e-5"
    w_bf16 = (unpack(wp, torch.float32) * scale[None]).to(torch.bfloat16)
    x_bf16 = x.to(torch.bfloat16)
    rec = {"bits": bits, "m": m, "k": k, "n": n,
           "dtype": str(x.dtype).removeprefix("torch."), "max_abs_err": err,
           "tol": tol, "ok": err <= tol,
           "ms": timer(lambda: cuda.quant_matmul(x, wp, scale, bits)),
           "plain_ms": timer(lambda: plain(x, wp, scale)),
           "cublas_bf16_ms": timer(lambda: torch.matmul(x_bf16, w_bf16))}
    # the library's time for the same function: on bf16 x cuBLAS bf16; on
    # float32 x the cast included and float32 out (``mm_f32_out``)
    rec["library_ms"] = rec["cublas_bf16_ms"]
    same = ""
    if x.dtype == torch.float32:
        rec["library"], fn = mm_f32_out()
        rec["library_ms"] = timer(lambda: fn(x, w_bf16))
        same = f", the same function {rec['library_ms']:.4f} ({rec['library']})"
    size = x.element_size()
    nb = m * k * size + wp.numel() + n * 4 + m * n * size
    flop = 2.0 * m * n * k
    rec["bound_ms"], rec["bound_by"] = bound_ms(nb, flop, BF16_OPS_PER_S)
    rate = ""
    rec["route"] = cuda.quant_matmul_route(m, n, k, x.dtype)
    if rec["route"] != "gemv":
        rec["tflops"] = flop / rec["ms"] * 1e-9
        rec["x_cublas"] = rec["ms"] / rec["library_ms"]
        rate = (f", {rec['tflops']:.1f} TFLOP/s, {rec['x_cublas']:.2f}x "
                f"the library")
    log(f"  quant_matmul {rec['route']} w{bits} {rec['dtype']} M={m} K={k} "
        f"N={n}: err {err:.3g} (tol {tol:.3g}, {tol_is} of max|ref|) "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, cuBLAS bf16 "
        f"{rec['cublas_bf16_ms']:.4f}{same}, bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}){rate}")
    if alone and rec["route"] != "gemv":
        # the timer's window holds the wrapper's host work past the flush:
        # the kernel and the library's same function in device time alone
        alone_device(timer, rec, lambda: cuda.quant_matmul(x, wp, scale, bits),
                     (lambda: fn(x, w_bf16)) if x.dtype == torch.float32
                     else (lambda: torch.matmul(x_bf16, w_bf16)))
        log_alone(rec, rec.get("library", "cuBLAS bf16"))
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


# the zoo's projection shapes (K, N) that olmo-1b's do not cover:
# granite-20b's k/v (one KV head, N = 128) and down (K = 24576), and
# deepseek-7b's up (N = 11008 = 256 x 43) and down
ZOO_PROJECTIONS = ((6144, 128), (24576, 6144), (4096, 11008), (11008, 4096))
# dbrx-132b's expert projections (K, N), gate and up, and down, at the rows
# of an expert's capacity buffer: 8 in a decode step at B = 8, 1280 in an
# 8 x 512 prefill (round_up(t k / E x 1.25, 8))
MOE_PROJECTIONS = ((6144, 10752), (10752, 6144))
MOE_ROWS = (8, 1280)
# qwen2-vl-7b's projections (K, N): q and o, k and v (4 KV heads of 128),
# gate and up, down; in a decode step at B = 8 and an 8 x 512 prefill
QWEN_PROJECTIONS = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
# deepseek-v3-671b's projections ((K, N), rows M): MLA's wq_a, wkv_a, wq_b
# and wo and the dense prefix's gate/up and down in a decode step at B = 8
# and an 8 x 512 prefill; an expert's gate/up and down (the shared
# expert's shapes too) at 8, 160 (an expert's capacity in that prefill:
# round_up(4096 x 8 / 256 x 1.25, 8)) and 4096 (the shared expert's)
DSV3_PROJECTIONS = (((7168, 1536), (8, 4096)), ((7168, 576), (8, 4096)),
                    ((1536, 24576), (8, 4096)), ((16384, 7168), (8, 4096)),
                    ((7168, 18432), (8, 4096)), ((18432, 7168), (8, 4096)),
                    ((7168, 2048), (8, 160, 4096)),
                    ((2048, 7168), (8, 160, 4096)))
DSV3_EXPERT = ((7168, 2048), (2048, 7168))


def check_quant_matmul(timer, dev, gen):
    """The main path's twelve shapes (bits 4 and 2, the three projection
    shapes of olmo-1b, decode M = 8 and prefill M = 4096), the zoo's
    (``ZOO_PROJECTIONS``, the same bits and M), dbrx-132b's experts
    (``MOE_PROJECTIONS`` at ``MOE_ROWS``, the tiled ones also in device
    time alone beside cuBLAS bf16), qwen2-vl-7b's (``QWEN_PROJECTIONS``,
    the same bits and M, in device time alone too), deepseek-v3-671b's
    (``DSV3_PROJECTIONS``, bits 4 and 2, its experts' in device time alone
    too), the identity
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
        for (k, n) in ZOO_PROJECTIONS:
            for m in (8, 8 * 512):
                rec = qmm_case(timer, dev, gen, bits, m, k, n)[0]
                rec["zoo"] = True
                cases.append(rec)
    for bits in (4, 2):
        for (k, n) in MOE_PROJECTIONS:
            for m in MOE_ROWS:
                rec = qmm_case(timer, dev, gen, bits, m, k, n, alone=True)[0]
                rec["moe"] = True
                cases.append(rec)
    for bits in (4, 2):
        for (k, n) in QWEN_PROJECTIONS:
            for m in (8, 8 * 512):
                rec = qmm_case(timer, dev, gen, bits, m, k, n, alone=True)[0]
                rec["qwen"] = True
                cases.append(rec)
    for bits in (4, 2):
        for (k, n), rows in DSV3_PROJECTIONS:
            for m in rows:
                rec = qmm_case(timer, dev, gen, bits, m, k, n,
                               alone=(k, n) in DSV3_EXPERT)[0]
                rec["deepseek_v3"] = True
                cases.append(rec)
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


# bert-base's projections (K, N): q/k/v, o, up and down
BERT_PROJECTIONS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def mm_f32_out():
    """PyTorch's call for the function of quant_matmul on float32 x, the
    rounding of x to bf16 included and float32 out: (its name, fn(x,
    w_bf16)).  ``aten::mm.dtype`` where this PyTorch has it for CUDA, else
    the cast, a bf16 matmul and a cast of the product."""
    if torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype",
                                                      "CUDA"):
        return ("torch.mm(x.bfloat16(), w, out_dtype=torch.float32)",
                lambda x, w: torch.mm(x.bfloat16(), w,
                                      out_dtype=torch.float32))
    return ("x.bfloat16() @ w, then .float()",
            lambda x, w: torch.matmul(x.bfloat16(), w).float())


def qmm_rounding_probe(dev, bits, m=300, k=256, n=512):
    """Float32 x on and around bf16 rounding ties through the wgmma route:
    code[c, j] = 1 where c == j % K and 0 elsewhere, scale 1.0, so output
    (i, j) is bf16(x[i, j % K]) exactly.  Rows hold random bf16 values plus
    offsets of their low 16 bits (0x8000 a tie, 0x7FFF and 0x8001 around
    it, 0x0001, 0xFFFF), signed zeros, subnormal ties, values that round to
    +-inf or lie at bf16's largest finite value, +-inf, and NaN rows; M =
    300 leaves a ragged token tile.  Returns (got, want): want is
    x.to(torch.bfloat16).float() at column j % K, NaN where the row holds
    a non-finite value at another K position (0 x inf in the sum);
    ``probe_equal`` compares them."""
    from repro_torch.kernels import cuda, ref
    g = torch.Generator(dev).manual_seed(9)
    base = torch.randn((m, k), generator=g, device=dev).bfloat16().float()
    offs = torch.tensor([0x8000, 0x7FFF, 0x8001, 0x0001, 0xFFFF, 0],
                        dtype=torch.int32, device=dev)
    iv = base.view(torch.int32) + offs[torch.arange(k, device=dev) % 6]
    sign = torch.where(torch.rand((m, k), generator=g, device=dev) < 0.5,
                       torch.tensor(-1, dtype=torch.int32, device=dev),
                       torch.tensor(0, dtype=torch.int32, device=dev))
    # subnormal ties and their neighbours: mantissa (r << 16) | 0x8000 +- 1
    mant = torch.randint(0, 1 << 7, (k,), generator=g,
                         device=dev).to(torch.int32) << 16
    iv[0] = (mant | offs[torch.arange(k, device=dev) % 3]) | (sign[0] << 31)
    x = iv.view(torch.float32).clone()
    x[1] = torch.where(sign[1] < 0, -0.0, 0.0)          # signed zeros
    big = 3.3895e38                                      # bf16's largest
    x[2] = torch.tensor([big, -big, 3.39e38, -3.4e38, 3.4028e38],
                        device=dev).repeat(k // 5 + 1)[:k]
    x[3, 17], x[4, 200], x[5] = math.inf, -math.inf, math.nan
    codes = torch.zeros((k, n), dtype=torch.int64, device=dev)
    cols = torch.arange(n, device=dev)
    codes[cols % k, cols] = 1
    wp = (ref.pack_w4 if bits == 4 else ref.pack_w2)(codes)
    scale = torch.ones((n,), device=dev)
    got = cuda.quant_matmul(x, wp, scale, bits)
    xb = x.to(torch.bfloat16).float()
    want = xb[:, cols % k]
    bad = ~torch.isfinite(xb)
    others = bad.sum(1, keepdim=True) - bad[:, cols % k].int() > 0
    want = torch.where(others, torch.tensor(math.nan, device=dev), want)
    return got, want


def probe_equal(got, want) -> bool:
    """``same_bits`` with signed zeros taken as equal: an output is a sum of
    products, and 0 x code adds +0 whatever the sign of the selected 0."""
    return same_bits(got + 0.0, want + 0.0)


def qmm_f32_digest(dev) -> str:
    """sha256 of quant_matmul's float32 outputs on seeded inputs, bits 4
    and 2 at bert-base's four projection shapes and M = 4099: equal digests
    from two trees in one call show they compute the same bits."""
    import hashlib
    from repro_torch.kernels import cuda, ref
    g = torch.Generator(dev).manual_seed(8)
    h = hashlib.sha256()
    for bits in (4, 2):
        for (k, n) in BERT_PROJECTIONS:
            lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
            codes = torch.randint(lo, hi, (k, n), generator=g, device=dev)
            wp = (ref.pack_w4 if bits == 4 else ref.pack_w2)(codes)
            x = torch.randn((4099, k), generator=g, device=dev)
            scale = torch.rand((n,), generator=g, device=dev) * 0.02 + 1e-3
            out = cuda.quant_matmul(x, wp, scale, bits)
            h.update(out.view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_quant_matmul_f32(timer, dev, gen):
    """quant_matmul as bert-base's packed forward runs it: float32 x and
    output, M = 32 x 384 tokens, each projection shape at bits 4 and 2
    (``qmm_case``; the wgmma route, which rounds x to bf16 in the kernel as
    its plain version rounds it), beside PyTorch's same function
    (``mm_f32_out``); then the rounding probe at both widths, bit for bit,
    and a digest of the outputs."""
    cases = [qmm_case(timer, dev, gen, bits, BERT_B * BERT_S, k, n,
                      dtype=torch.float32,
                      alone=(bits, k, n) == (4, 768, 3072))[0]
             for bits in (4, 2) for (k, n) in BERT_PROJECTIONS]
    for bits in (4, 2):
        got, want = qmm_rounding_probe(dev, bits)
        same = probe_equal(got, want)
        cases.append({"rounding_probe": True, "bits": bits, "m": 300,
                      "k": 256, "n": 512, "bit_equal": same, "ok": same})
        log(f"    rounding probe w{bits} (ties, subnormals, +-0, +-inf, "
            f"NaN rows; M=300 K=256 N=512): outputs equal "
            f"x.to(torch.bfloat16) bit for bit: {same}")
    digest = qmm_f32_digest(dev)
    cases.append({"digest": digest, "ok": True})
    log(f"    float32 outputs (seeded inputs, bert-base's projections, "
        f"M=4099, bits 4 and 2): sha256 {digest}")
    # headline: the up projection at int4
    return cases[2], cases


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
    splits, c, _ = cuda.decode_plan(b, hkv, group, s, bits)
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


# (H, Hkv) of the decode checks: olmo-1b's MHA, granite-20b's MQA (48
# query heads on one KV head: 12 blocks of 4 over each chunk), dbrx-132b's
# GQA 48/8 (groups of 6: 2 blocks of 3) and qwen2-vl-7b's 28/4 (groups of
# 7, a prime: 7 blocks of one query head, each reading its KV head's rows)
DECODE_HEADS = ((16, 16), (48, 1), (48, 8), (28, 4))


def check_kv_decode(timer, dev, gen):
    """The contiguous decode at B = 8, S = 1024, D = 128, H = Hkv = 16,
    granite-20b's H = 48 on Hkv = 1, dbrx-132b's 48 on 8 and qwen2-vl-7b's
    28 on 4, one slot past
    the end and the others
    spread over the cache, int8 and int4: within 1e-4 * max|ref| of the
    plain version, timed on the timer and in device time alone beside SDPA
    on the dequantized bf16 cache, MHA also on plans of other chunk sizes;
    two calls equal bit for bit; then the selector probe, bit for bit, at
    MHA, GQA 16/4, MQA 48/1, GQA 48/8 and GQA 28/4."""
    from repro_torch.kernels import cuda, kv_quant, ref
    b, s, d = 8, 1024, 128
    cases = []
    for (h, hkv), bits in ((heads, bits) for heads in DECODE_HEADS
                           for bits in (8, 4)):
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
            return sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                        enable_gqa=hkv != h)

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
        for rows_cap in ((64, 256) if h == hkv else ()):
            with patched(cuda, "DECODE_CHUNK_ROWS", rows_cap):
                c = cuda.decode_plan(b, hkv, h // hkv, s, bits)[1]
                rec["device_us_by_chunk"][c], _ = device_us(
                    timer, lambda: cuda.kv_decode_attention(*args, bits))
        log(f"  kv_decode_attention int{bits} B={b} S={s} H={h} Hkv={hkv} "
            f"D={d}: err "
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
        for h, hkv in ((16, 16), (16, 4), (48, 1), (48, 8), (28, 4)):
            calls, splits, c, same = kv_decode_selector_probe(
                dev, bits, "contiguous", h=h, hkv=hkv)
            cases.append({"kv_decode_selector_probe": True, "bits": bits,
                          "layout": "contiguous", "h": h, "hkv": hkv,
                          "s": 1024, "plan": [splits, c], "calls": calls,
                          "bit_equal": same, "ok": same})
            log(f"    selector probe int{bits} H={h} Hkv={hkv}: rows in "
                f"every one of {splits} chunks of {c}, {calls} call(s), "
                f"outputs equal the selected V rows bit for bit: {same}")
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


# (B, H, Hkv, S, D, causal, alone) of check_flash: olmo-1b's prefill, a
# ragged GQA shape, granite-20b's MQA prefill of one 2048-token prompt,
# hubert-xlarge's 8 x 1000 frames (head_dim 80, not causal; 1000 is no
# multiple of the 64-row tiles), dbrx-132b's and qwen2-vl-7b's prefills,
# and deepseek-v3's MLA prefill (128 heads at D = 192: [nope ; rope] q
# and k, V padded to 192 as mla_apply pads it; SDPA at the same padded
# width); ``alone``: also timed in device time alone beside SDPA
FLASH_CASES = ((8, 16, 16, 512, 128, True, False),
               (2, 16, 4, 300, 128, True, True),
               (1, 48, 1, 2048, 128, True, True),
               (8, 16, 16, 1000, 80, False, True),
               (8, 48, 8, 512, 128, True, True),
               (8, 28, 4, 512, 128, True, True),
               (8, 128, 128, 512, 192, True, True))
MLA_V_DIM = 128         # deepseek-v3's v_head_dim: V's columns past it are 0


def check_flash(timer, dev, gen):
    """``FLASH_CASES`` against the plain
    version in float32 (max-abs and per-row tolerances), timed beside SDPA;
    the suffix prefill's offset shapes (``FLASH_OFFSET_CASES``) likewise,
    beside SDPA with a bottom-right mask; a digest of the Sk = Sq outputs;
    then the selector probe, bit for bit, at S = 128, 129, 300 and 513 with
    MHA and GQA 16/4, causal and with keys spread over every kv tile, and
    causal with the queries cut to their last rows (q_offset > 0); at D =
    80 (S = 129 and 1000, both masks), at MQA 48/1 (S = 300, both), at
    dbrx-132b's GQA 48/8 and at qwen2-vl-7b's 28/4 (S = 512, both), and
    at D = 192 (S = 300 with 16 heads, and deepseek-v3's 128 heads at S =
    512, both)."""
    from repro_torch.kernels import cuda, ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for (b, h, hkv, s, d, causal, alone) in FLASH_CASES:
        q = torch.randn((b, h, s, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
        if d == 192:             # MLA's V, zero-padded from 128 columns
            v[..., MLA_V_DIM:] = 0
        # the plain version on the same inputs in float32: in bf16 it rounds
        # the scores to bf16 before the softmax, an error of its own
        qf, kf, vf = q.float(), k.float(), v.float()
        out = cuda.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(qf, kf, vf, causal=causal, impl="ref")
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
        rec = {"b": b, "h": h, "hkv": hkv, "s": s, "d": d, "causal": causal,
               "design": FLASH_DESIGN,
               "max_abs_err": err, "tol": tol, "max_row_rel_err": row_err,
               "row_tol": 1e-2, "off_bf16_share": off,
               "ok": err <= tol and row_err <= 1e-2,
               "ms": timer(lambda: cuda.flash_attention(q, k, v, causal)),
               "plain_ms": timer(lambda: ops.flash_attention(
                   qf, kf, vf, causal=causal, impl="ref")),
               "library_ms": timer(lambda: sdpa(q, k, v, is_causal=causal,
                                                 enable_gqa=hkv != h))}
        # the bytes of the caller's rows (D = 80 rows move 160 bytes: the
        # kernel's zero columns are TMA's fill, not reads), the products
        # of the mask's scores at that D
        nb = 2 * (2 * b * h * s * d) + 2 * (2 * b * hkv * s * d)
        flop = 4.0 * b * h * d * s * ((s + 1) / 2 if causal else s)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nb, flop, BF16_OPS_PER_S)
        rec["tflops"] = flop / rec["ms"] * 1e-9
        rec["x_sdpa"] = rec["ms"] / rec["library_ms"]
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
        rec["host_us"] = host_us(lambda: cuda.flash_attention(q, k, v,
                                                              causal))
        rec["library_host_us"] = host_us(
            lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=hkv != h))
        if alone:
            alone_device(timer, rec,
                         lambda: cuda.flash_attention(q, k, v, causal),
                         lambda: sdpa(q, k, v, is_causal=causal,
                                      enable_gqa=hkv != h))
        mask = "causal" if causal else "not causal"
        log(f"  flash_attention B={b} H={h} Hkv={hkv} S={s} D={d} {mask}: "
            f"err {err:.3g} (tol {tol:.3g}), worst row |d|/|ref| "
            f"{row_err:.3g} (tol 0.01), {off:.3g} of outputs off the plain "
            f"bf16 rounding; {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
        log(f"    design {FLASH_DESIGN}: {rec['tflops']:.1f} TFLOP/s (causal "
            f"4BHDS(S+1)/2, else 4BHDS^2), {rec['x_sdpa']:.2f}x SDPA, "
            f"{rec['x_bound']:.2f}x the bound; enqueue {rec['host_us']:.1f} "
            f"us on the host (SDPA {rec['library_host_us']:.1f})")
        if "device_us" in rec:
            log_alone(rec, "SDPA")
        cases.append(rec)
        del q, k, v, qf, kf, vf, out, want, got
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
    for causal in (True, False):
        for (s, h, hkv, d) in ((129, 16, 16, 80), (1000, 16, 16, 80),
                               (300, 48, 1, 128), (512, 48, 8, 128),
                               (512, 28, 4, 128), (300, 16, 16, 192),
                               (512, 128, 128, 192)):
            q, k, v, want = flash_selector_probe(dev, 2, h, hkv, s, d=d,
                                                 causal=causal)
            got = cuda.flash_attention(q, k, v, causal=causal)
            same = bool(torch.equal(got, want))
            cases.append({"selector_probe": True, "b": 2, "h": h,
                          "hkv": hkv, "s": s, "d": d, "causal": causal,
                          "bit_equal": same, "ok": same})
            log(f"    selector probe S={s} H={h} Hkv={hkv} D={d} causal="
                f"{causal}: output row i equals V[pos(pi(i))] bit for bit: "
                f"{same}")
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


# float32 kernel vs its plain version, relative to max|ref| and to each
# row's norm: both sum in float32, in other orders (a score of D = 64 terms
# and a row of up to 456 keys), an error near 1e-6 of the result
FLASH_F32_TOL = 1e-5
FLASH_F32_TERMS = 6   # bf16 products a float32 product takes (flash_f32)
# (b, h, hkv, s, s_k, d, causal, layout): bert-base's prefill first (the
# model's (B, S, H, D) projections passed as (B, H, S, D) views), then
# causal, ragged S, GQA 12/4, D = 128 and keys longer than the queries
FLASH_F32_CASES = ((32, 12, 12, 384, 384, 64, False, "model"),
                   (2, 12, 12, 300, 300, 64, True, "bhsd"),
                   (2, 12, 12, 129, 129, 64, False, "model"),
                   (2, 12, 4, 384, 384, 64, False, "bhsd"),
                   (2, 8, 8, 257, 257, 128, True, "model"),
                   (2, 8, 8, 257, 257, 128, False, "bhsd"),
                   (1, 12, 12, 200, 456, 64, True, "bhsd"),
                   (1, 12, 4, 200, 456, 64, False, "model"))


def check_flash_f32(timer, dev, gen):
    """The float32 flash kernel against its plain version in float32 on
    the same inputs (FLASH_F32_TOL of max|ref| and of every row's norm) at
    FLASH_F32_CASES; the first, bert-base's prefill shape, timed beside
    float32 SDPA and read in device time alone."""
    from repro_torch.kernels import cuda, ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for i, (b, h, hkv, s, s_k, d, causal, layout) in enumerate(
            FLASH_F32_CASES):
        def make(heads, n):
            if layout == "model":
                return torch.randn((b, n, heads, d), generator=gen,
                                   device=dev).transpose(1, 2)
            return torch.randn((b, heads, n, d), generator=gen, device=dev)
        q, k, v = make(h, s), make(hkv, s_k), make(hkv, s_k)
        got = cuda.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = FLASH_F32_TOL * float(want.abs().max())
        row_err = float((torch.linalg.vector_norm(got - want, dim=-1)
                         / torch.linalg.vector_norm(want, dim=-1)).max())
        rec = {"b": b, "h": h, "hkv": hkv, "s": s, "s_k": s_k, "d": d,
               "causal": causal, "layout": layout, "max_abs_err": err,
               "tol": tol, "max_row_rel_err": row_err,
               "row_tol": FLASH_F32_TOL,
               "ok": err <= tol and row_err <= FLASH_F32_TOL}
        log(f"  flash_attention f32 B={b} H={h} Hkv={hkv} Sq={s} Sk={s_k} "
            f"D={d} causal={causal} {layout}: err {err:.3g} (tol "
            f"{tol:.3g}), worst row |d|/|ref| {row_err:.3g} (tol "
            f"{FLASH_F32_TOL})")
        if i == 0:
            def kern():
                return cuda.flash_attention(q, k, v, causal=causal)

            def lib():
                return sdpa(q, k, v, enable_gqa=hkv != h)
            rec["ms"] = timer(kern)
            rec["plain_ms"] = timer(lambda: ops.flash_attention(
                q, k, v, causal=causal, impl="ref"))
            rec["library_ms"] = timer(lib)
            nb = 4 * (2 * b * h * s * d) + 4 * (2 * b * hkv * s_k * d)
            flop = 4.0 * b * h * s * s_k * d
            # the kernel's six bf16 products on the tensor cores; beside
            # it the float32 FMA bound of the products themselves
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                nb, FLASH_F32_TERMS * flop, BF16_OPS_PER_S)
            rec["ffma_bound_ms"], _ = bound_ms(nb, flop, F32_OPS_PER_S)
            rec["tflops"] = flop / rec["ms"] * 1e-9
            alone_device(timer, rec, kern, lib)
            rec["sdpa_max_abs_err"] = float((lib() - want).abs().max())
            log(f"    {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
                f"float32 SDPA {rec['library_ms']:.4f} (its error "
                f"{rec['sdpa_max_abs_err']:.3g}), bound "
                f"{rec['bound_ms']:.4f} ({rec['bound_by']}: "
                f"{FLASH_F32_TERMS} bf16 products at 989 TFLOP/s; float32 "
                f"FMA bound {rec['ffma_bound_ms']:.4f}); "
                f"{rec['tflops']:.1f} TFLOP/s (4 B H Sq Sk D)")
            log_alone(rec, "float32 SDPA")
        cases.append(rec)
    probe = flash_f32_precision_probe(dev)
    probe["ok"] = probe["ok"] and probe["control_rel_err"] > 10 * FLASH_F32_TOL
    cases.append(probe)
    log(f"    precision probe (24-bit mantissas, B=2 H=12 S=384 D=64): "
        f"err {probe['rel_err']:.3g} of max|ref|, worst row "
        f"{probe['max_row_rel_err']:.3g} (tol {FLASH_F32_TOL}); the hi "
        f"terms alone (bf16 q, k, v) {probe['control_rel_err']:.3g}, worst "
        f"row {probe['control_row_rel_err']:.3g}")
    hgmma = sass_hgmma("flash_attention", "flash_f32")
    cases.append({"sass_hgmma": hgmma, "ok": hgmma is None or (
        len(hgmma) == 2 and all(n > 0 for n in hgmma.values()))})
    log(f"    SASS HGMMA instructions of each flash_f32 instantiation: "
        f"{hgmma if hgmma is not None else 'not checked (no cuobjdump)'}")
    return cases[0], cases


def flash_f32_precision_probe(dev, b=2, h=12, s=384, d=64):
    """The float32 flash kernel on inputs whose mantissas use all 24 bits
    (q = 2 randn, k and v randn; not causal), against the plain version in
    float32: its error relative to max|ref| and to each row's norm, beside
    the control, the plain version on q, k and v rounded to bf16 (what the
    hi terms alone would compute), which misses FLASH_F32_TOL by far."""
    from repro_torch.kernels import cuda, ops
    g = torch.Generator(dev).manual_seed(11)
    q = 2 * torch.randn((b, h, s, d), generator=g, device=dev)
    k, v = (torch.randn((b, h, s, d), generator=g, device=dev)
            for _ in range(2))
    got = cuda.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention(q, k, v, causal=False, impl="ref")
    hi = ops.flash_attention(*(t.bfloat16().float() for t in (q, k, v)),
                             causal=False, impl="ref")
    top = float(want.abs().max())
    norm = torch.linalg.vector_norm(want, dim=-1)

    def errs(x):
        return (float((x - want).abs().max()) / top,
                float((torch.linalg.vector_norm(x - want, dim=-1)
                       / norm).max()))
    rec = {"precision_probe": True, "b": b, "h": h, "s": s, "d": d}
    rec["rel_err"], rec["max_row_rel_err"] = errs(got)
    rec["control_rel_err"], rec["control_row_rel_err"] = errs(hi)
    rec["ok"] = (rec["rel_err"] <= FLASH_F32_TOL
                 and rec["max_row_rel_err"] <= FLASH_F32_TOL)
    return rec


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


def sass_ops(source: str, kernel: str):
    """The SASS opcodes of each instantiation of ``kernel`` in a built
    library, in order, from cuobjdump: {mangled name: [opcode]}; None
    where the toolkit has no cuobjdump."""
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
    return ops


def sass_hgmma(source: str, kernel: str):
    """{instantiation of ``kernel``: its HGMMA (wgmma) instructions}, or
    None where the toolkit has no cuobjdump."""
    ops = sass_ops(source, kernel)
    if ops is None:
        return None
    return {name: sum(op.startswith("HGMMA") for op in seq)
            for name, seq in ops.items()}


def sass_count(source: str, kernel: str):
    """SASS instructions of each instantiation of ``kernel`` in a built
    library, from cuobjdump: {mangled name: (all, main path)}, the main
    path being the instructions up to the last EXIT before the first RET
    (what follows is the division's slow path, a subroutine); None where
    the toolkit has no cuobjdump.  Static counts: the kernels have no
    loops, so the main path is what a thread executes, the tail's branch
    included."""
    ops = sass_ops(source, kernel)
    if ops is None:
        return None
    counts = {}
    for name, seq in ops.items():
        ret = next((i for i, op in enumerate(seq) if op.startswith("RET")),
                   len(seq))
        exits = [i for i, op in enumerate(seq[:ret]) if op == "EXIT"]
        counts[name] = (len(seq), exits[-1] + 1 if exits else ret)
    return counts


# one expert of dbrx-132b: its gate/up weight (d_model, d_ff); a train
# step fake-quantizes 3 E of them a layer (gate, up and down)
DBRX_EXPERT_SHAPE = (6144, 10752)
# deepseek-v3-671b's prefix SwiGLU gate weight (d_model, its d_ff) at 4
# bits, and its token table (vocab, d_model), pinned at 8 bits: the largest
# tensors its method phase fake-quantizes (the table twice a step, the MTP
# head's second gather)
DSV3_PREFIX_GATE_SHAPE = (7168, 18432)
DSV3_TABLE_SHAPE = (129280, 7168)


def dsv3_weights(gen, dev) -> list:
    """(what, float32 weight, bits) of deepseek-v3's largest fake-quant
    sites, drawn as ``init_params`` draws them: the prefix gate weight
    (normal x d_in ** -0.5) at 4 bits and the table (normal x 0.02) at 8."""
    gate = torch.randn(DSV3_PREFIX_GATE_SHAPE, generator=gen, device=dev) \
        * DSV3_PREFIX_GATE_SHAPE[0] ** -0.5
    table = torch.randn(DSV3_TABLE_SHAPE, generator=gen, device=dev) * 0.02
    return [("deepseek-v3 prefix gate weight", gate, 4),
            ("deepseek-v3 token table", table, 8)]


def lsq_case(timer, x, steps, bits, what):
    """lsq_fakequant of ``x`` at ``steps`` (one tensor, or a list of up to
    3) against its plain version, bit for bit; timed beside the plain
    version and fake_quantize_per_tensor_affine (once a step), in device
    time alone, and beside torch.cat moving the same bytes."""
    from repro_torch.kernels import cuda, ref
    group = steps if isinstance(steps, list) else [steps]
    n_steps, half = len(group), 2 ** (bits - 1)

    def kernel():
        return cuda.lsq_fakequant(x, steps, bits)

    def plain():
        return ref.lsq_fakequant_grouped(x, group, bits)

    def library():
        return [torch.fake_quantize_per_tensor_affine(
            x, float(s), 0, -half, half - 1) for s in group]

    got = kernel()
    got = [got] if n_steps == 1 else got
    want = plain()
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    equal = all(same_bits(a, b) for a, b in zip(got, want))
    rec = {"what": what, "bits": bits, "steps": n_steps,
           "shape": list(x.shape), "max_abs_err": err, "tol": 0.0,
           "bit_equal": equal, "ok": equal, "ms": timer(kernel),
           "plain_ms": timer(plain), "library_ms": timer(library)}
    n = x.numel()
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        2.0 * n * (1 + n_steps), 6.0 * n * n_steps, F32_OPS_PER_S)
    alone_device(timer, rec, kernel, library)
    # PyTorch moving at least the same bytes: a copy of x (one step), or x
    # concatenated with itself, once an output
    rec["same_bytes_device_us"], _ = device_us(
        timer, lambda: torch.cat([x] * n_steps))
    log(f"  lsq_fakequant {what}, {bits}-bit, {n_steps} step(s), "
        f"{tuple(x.shape)} bf16: err {err} (exact; bit for bit: {equal}) "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
        f"fake_quantize_per_tensor_affine x{n_steps} "
        f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']})")
    log_alone(rec, f"fake_quantize_per_tensor_affine x{n_steps}")
    log(f"    torch.cat of x, once an output (the same bytes): "
        f"{rec['same_bytes_device_us']:.2f} us")
    return rec


def check_lsq(timer, dev, gen):
    """The main path's shape (a prefill's 4096 x 2048 bf16 activations) at
    2, 4 and 8 bits, with one step and with three (q/k/v's grouped call),
    and one dbrx-132b expert's weight (DBRX_EXPERT_SHAPE, bf16, 4 bits, its
    LSQ step, and three steps), and deepseek-v3's prefix gate weight and
    token table (``dsv3_weights``, bf16, one step): bit for bit against
    the plain version,
    timed, and in device time alone beside fake_quantize_per_tensor_affine
    (called once a step) (``lsq_case``); then the probe (``lsq_probe``)
    and the kernel's static SASS count."""
    from repro_torch.core import quant
    x = torch.randn((8 * 512, 2048), generator=gen, device=dev).bfloat16()
    steps = [torch.tensor(v, device=dev) for v in LSQ_STEPS]
    cases = [lsq_case(timer, x, steps[0] if n_steps == 1 else
                      steps[:n_steps], bits, "prefill activations")
             for n_steps in (1, 3) for bits in (2, 4, 8)]
    w = (torch.randn(DBRX_EXPERT_SHAPE, generator=gen, device=dev)
         * DBRX_EXPERT_SHAPE[0] ** -0.5).bfloat16()
    sw = quant.init_step_from_tensor(w, 4.0)
    for group in (sw, [sw, sw * 0.5, sw * 2.0]):
        cases.append(lsq_case(timer, w, group, 4, "dbrx expert weight"))
    del w
    for what, w, bits in dsv3_weights(gen, dev):
        w = w.bfloat16()
        cases.append(lsq_case(timer, w, quant.init_step_from_tensor(
            w, float(bits)), bits, what))
        del w
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
    8192, its LSQ step) and one dbrx-132b expert's gate weight
    (DBRX_EXPERT_SHAPE, its LSQ step), all at 4 bits, and deepseek-v3's
    prefix gate weight (4 bits) and token table (8 bits)
    (``dsv3_weights``, their LSQ steps); then a ragged
    length and the forward probe's values (NaN, +-inf, ties, clamp edges)
    at 2, 4 and 8 bits, bf16 and float32, 1-3 steps.  gx bit for bit
    against the plain version, gs within its bound (``lsq_bwd_compare``);
    timed beside the plain version and beside PyTorch's learnable per-
    tensor LSQ (``torch._fake_quantize_learnable_per_tensor_affine``,
    forward and backward, zero point 0, once a step: it recomputes the
    forward's codes in its backward and takes no shared input), and in
    device time alone against the byte bound."""
    from repro_torch.core import quant
    from repro_torch.kernels import cuda, ref
    w = torch.randn((2048, 8192), generator=gen, device=dev) * 0.02
    we = torch.randn(DBRX_EXPERT_SHAPE, generator=gen, device=dev) * \
        DBRX_EXPERT_SHAPE[0] ** -0.5
    weights = {"gate weight": w, "dbrx expert gate weight": we}
    shapes = [("qkv input", (8 * 512, 2048), [torch.tensor(v, device=dev)
                                               for v in LSQ_STEPS], 4),
              ("down input", (8 * 512, 8192), [torch.tensor(0.31,
                                                            device=dev)], 4),
              ("gate weight", (2048, 8192), [quant.init_step_from_tensor(
                  w, 4.0)], 4),
              ("dbrx expert gate weight", DBRX_EXPERT_SHAPE,
               [quant.init_step_from_tensor(we, 4.0)], 4)]
    for what, wd, bits in dsv3_weights(gen, dev):
        weights[what] = wd
        shapes.append((what, tuple(wd.shape),
                       [quant.init_step_from_tensor(wd, float(bits))], bits))
    del wd
    cases = []
    for what, shape, steps, bits in shapes:
        x = (weights.pop(what).bfloat16() if what in weights
             else torch.randn(shape, generator=gen, device=dev).bfloat16())
        grads = [torch.randn(shape, generator=gen, device=dev).bfloat16()
                 * 1e-3 for _ in steps]
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


HIST_PLAIN_CHUNK = 1 << 24   # codes a plain histogram call: its (codes,
                              # bins) compare and the int64 sum of it


def plain_histogram(codes: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The plain histogram (``ref.histogram``) over HIST_PLAIN_CHUNK codes
    at a time, the chunks' counts added in int64: exact counts, which the
    kernel's float32 output holds rounded once past 2^24 a bin (the
    table's 927 M codes would take the plain version's compare 110 GiB in
    one piece)."""
    from repro_torch.kernels import ref
    return sum(ref.histogram(c, n_bins).long()
               for c in codes.split(HIST_PLAIN_CHUNK))


def check_histogram(timer, dev, gen):
    """EAGL's histogram at the largest olmo-1b tensor (2048 x 8192 codes of
    normal weights quantized at 4 and 2 bits), at deepseek-v3's prefix gate
    weight (4 and 2 bits) and its token table (4 bits) (``dsv3_weights``),
    and ragged lengths with
    negatives and the sentinel n_bins at 16 bins and at 17 and 4096 (the
    shared-counter path).  Exact against the plain version
    (``plain_histogram``'s counts in float32), its counts summing to the
    in-range codes, two calls in a row equal (the counters reset), one
    device op a call; timed against torch.bincount on the in-range
    codes."""
    from repro_torch.core import quant
    from repro_torch.kernels import cuda
    cases = []
    w = torch.randn((2048 * 8192,), generator=gen, device=dev) * 0.02
    weights = [(w, (16, 4))] + [(wd.reshape(-1), (16, 4) if bits == 4
                                 else (16,))
                                for _, wd, bits in dsv3_weights(gen, dev)]
    for w, bins in weights:
        for n_bins in bins:
            bits = float(n_bins.bit_length() - 1)
            step = quant.init_step_from_tensor(w, bits)
            codes = (quant.quantize_int(w, step, bits) + n_bins // 2).to(
                torch.int32)
            cases.append((n_bins, codes))
    del weights, w
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
        counts = plain_histogram(codes, n_bins)
        want = counts.float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        repeat = bool(torch.equal(got, again))
        kept = codes[(codes >= 0) & (codes < n_bins)]
        n = codes.numel()
        rec = {"n": n, "n_bins": n_bins, "max_abs_err": err, "tol": 0.0,
               "repeat_equal": repeat,
               "ok": (err == 0.0 and repeat
                      and int(counts.sum()) == kept.numel()),
               "ms": timer(lambda: cuda.histogram(codes, n_bins)),
               "plain_ms": timer(lambda: plain_histogram(codes, n_bins)),
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
    pages a slot, positions up to 1023), int8 and int4, GQA 16/4,
    granite-20b's MQA 48/1, dbrx-132b's GQA 48/8 and qwen2-vl-7b's 28/4:
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
    for bits, h, hkv in ((8, 16, 16), (4, 16, 16), (4, 16, 4), (8, 48, 1),
                         (4, 48, 1), (8, 48, 8), (4, 48, 8), (8, 28, 4),
                         (4, 28, 4)):
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
        for h, hkv in ((16, 16), (16, 4), (48, 1), (48, 8), (28, 4)):
            calls, splits, c, same = kv_decode_selector_probe(
                dev, bits, "paged", h=h, hkv=hkv)
            cases.append({"kv_decode_selector_probe": True, "bits": bits,
                          "layout": "paged", "h": h, "hkv": hkv, "s": 1024,
                          "plan": [splits, c], "calls": calls,
                          "bit_equal": same, "ok": same})
            log(f"    selector probe int{bits} H={h} Hkv={hkv} paged: rows in "
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
    """{kernel: (device us, launches)} of a finished torch.profiler run: its
    raw device events summed by name, spans over kernels (user annotations
    such as Optimizer.step) left out.  ``key_averages`` gives the same
    sums, but parses every host and device event first: seconds over the
    tens of thousands of kernels of a large model's 8 decode steps."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation()):
            continue
        us, n = rows.get(e.name(), (0.0, 0))
        rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    out = {}
    for name, (us, n) in rows.items():
        if us > 0:
            key = torch._C._demangle(name)
            was = out.get(key, (0.0, 0))
            out[key] = (was[0] + us, was[1] + n)
    return out


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
            # PyTorch's copy kernels (dtype casts among them)
            "copy_kernel_ms": sum(us for k, us, _ in rows
                                  if "copy_kernel" in k) / 1e3,
            "copy_kernels": sum(n for k, _, n in rows if "copy_kernel" in k),
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for k, us, n in rows[:top]]}


def dtoh_copies(fn, dev) -> int:
    """The device-to-host copies ``fn`` makes on ``dev`` (to pageable or
    pinned memory, blocking or not): torch.profiler with device activity
    only, cheap enough for every run."""
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if dev.type == "cuda" else \
        ProfilerActivity.CPU
    sync(dev)
    with profile(activities=[act]) as prof:
        fn()
        sync(dev)
    return sum(n for k, (_, n) in device_table(prof).items()
               if k.startswith("Memcpy DtoH"))


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
    log(f"  the weights are random (seed 0) or trained for 16 steps on "
        f"synthetic tokens, so this mix says nothing about which layers of "
        f"a trained {cfg.name} need 4 bits")
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


def step_launches(cfg) -> dict:
    """The launches one decode step makes, from the config: a packed
    matmul a projection (q, k, v, o, and gate, up and down for SwiGLU or
    up and down for GeLU) a layer; one grouped LSQ fake-quant for q/k/v,
    o, the FFN's input and down a layer, and the head's; one attention a
    layer (``"attention"``): the decode attention in a decode step over a
    quantized GQA cache, one flash_attention in a prefill or an encoder's
    forward, which make the same launches otherwise.  A MoE layer makes q,
    k, v, o and each expert's gate, up and down (4 + 3 E packed matmuls;
    the pinned 8-bit router is a plain matmul) and fake-quantizes q/k/v, o,
    the router's input and each expert's buffer and hidden (3 + 2 E): every
    expert runs its capacity rows in every step, whether a token chose it
    or not; a shared expert adds its gate, up and down (3) and its two
    fake-quants.  An MLA block (deepseek-v3) projects wq_a, wkv_a, wq_b
    and wo (4: wk_b and wv_b are read as dequantized weights, no matmul
    of packed codes) and fake-quantizes x for wq_a and wkv_a together, q_c
    and o (3).  The prefix blocks count as layers."""
    qmm = lsq = 0
    blocks = tuple(cfg.prefix) + tuple(cfg.pattern) * cfg.n_repeats
    for b in blocks:
        qmm += 4
        lsq += 3 if b.mixer == "mla" else 2
        if b.ffn == "moe":
            qmm += 3 * cfg.n_experts + 3 * (cfg.n_shared_experts > 0)
            lsq += 1 + 2 * cfg.n_experts + 2 * (cfg.n_shared_experts > 0)
        else:
            qmm += 3 if b.ffn == "swiglu" else 2
            lsq += 2
    return {"quant_matmul": qmm, "lsq_fakequant": lsq + 1,
            "attention": len(blocks)}


def decode_attention_launches(cfg, bits) -> int:
    """Decode attention kernel launches a decode step makes: one a causal
    GQA layer over a quantized cache (``bits`` 4 or 8); none over a full
    cache (plain attention) or in an MLA layer (the absorbed decode is
    plain products over its full-precision latent)."""
    blocks = tuple(cfg.prefix) + tuple(cfg.pattern) * cfg.n_repeats
    return 0 if bits is None else sum(b.mixer == "gqa" for b in blocks)


def log_serve_run(what: str, rec: dict) -> None:
    res = rec["residency"]
    log(f"  {what}: generate 8x{rec['new_tokens']} in "
        f"{rec['generate_s']:.3f} s "
        f"({rec['tokens_per_s']:.1f} tok/s), prefill "
        f"{rec['prefill_ms']:.1f} ms, decode "
        f"{rec['decode_ms_per_step']:.2f} ms/step, weights "
        f"{res['resident_weight_bytes'] / 1e6:.1f} MB resident vs "
        f"{rec['weight_bytes_bf16'] / 1e6:.1f} MB bf16, KV "
        f"{res['resident_kv_bytes'] / 1e6:.1f} MB, peak "
        f"{rec['max_memory_allocated'] / 1e9:.2f} GB; "
        f"{rec['dtoh_copies_8_steps']} device-to-host copies in 8 decode "
        f"steps")


SERVE_RUNS = tuple((layout, bits) for layout in SERVE_PATHS
                   for bits in (8, 4))
# the kernels a full-cache run must launch, and those it must not
FULL_CACHE_PATH = ({"quant_matmul", "flash_attention", "lsq_fakequant"},
                   {"kv_decode_attention", "paged_kv_decode_attention"})


def phase_serve(cfg, packed, pa, dev, tokens, lengths, runs_of=SERVE_RUNS,
                n_new=64):
    """``generate`` of the prompts, ``n_new`` tokens, over each (layout,
    bits) cache of ``runs_of`` (bits 8 or 4: a quantized cache; None: the
    full cache, as MLA's latent always is; a paged run after the
    contiguous run of its bits), with its launches, bytes and timings
    (``serve_run``), and for the int8 and full runs a torch.profiler
    breakdown of a prefill and 8 decode steps (``serve_breakdown``; the
    summaries take seconds a run).
    Gates: the kernels of each path launched and no other decode kernel;
    no device-to-host copy in 8 decode steps (``serve_run``, every run);
    the launches a decode step and a prefill that ``step_launches`` works
    out from the config; paged tokens equal to the contiguous run's."""
    from repro_torch.serve import EngineSpec, ServeEngine, packing
    runs = {}
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    want = step_launches(cfg)
    for layout, bits in runs_of:
        need, never = SERVE_PATHS[layout] if bits else FULL_CACHE_PATH
        name = f"{layout}-int{bits}" if bits else f"{layout}-full"
        cache = (dict(cache="quantized", cache_bits=bits) if bits
                 else dict(cache="full"))
        engine = ServeEngine(cfg, packed, pa, max_seq=1024,
                             spec=EngineSpec(cache_layout=layout,
                                             page_size=PAGE, **cache),
                             device=dev)
        rec = serve_run(engine, cfg, tok_t, len_t, lengths, n_new)
        launches = rec["launches"]
        missing = sorted(k for k in need if launches[k] == 0)
        stray = sorted(k for k in never if launches[k] != 0)
        if missing or stray:
            raise RuntimeError(f"{name}: the path launched no {missing}"
                               f" and launched {stray}")
        step, pre = rec["launches_per_decode_step"], \
            rec["launches_per_prefill"]
        decode_kernel = ("paged_kv_decode_attention" if layout == "paged"
                         else "kv_decode_attention")
        got = {"attention": (step[decode_kernel],
                                    pre["flash_attention"])}
        expect = {"attention": (decode_attention_launches(cfg, bits),
                                want["attention"])}
        for k in ("quant_matmul", "lsq_fakequant"):
            got[k] = (step[k], pre[k])
            expect[k] = (want[k],) * 2
        wrong = {k: v for k, v in got.items() if v != expect[k]}
        if wrong:
            raise RuntimeError(f"{name}: launches (a decode step, a "
                               f"prefill) {wrong}, expected {expect}")
        if layout == "paged":
            base = runs[f"contiguous-int{bits}"]
            if rec["tokens"] != base["tokens"]:
                raise RuntimeError(f"{name}: tokens differ from the "
                                   f"contiguous run's")
        rec["weight_bytes_bf16"] = packing.bf16_weight_bytes(packed)
        log_serve_run(f"serve {name} cache", rec)
        log(f"    launches in generate: {launches}")
        log(f"    per prefill: {pre}; per decode step: {step}")
        if bits in (8, None):
            rec["profile"] = serve_breakdown(engine, tok_t, len_t)
            for what, brk in rec["profile"].items():
                log_breakdown(what, brk)
        if layout == "paged":
            log(f"    tokens equal to the contiguous int{bits} run's")
        runs[name] = rec
        # free this run's cache before the next run's peak is taken
        del engine
        torch.cuda.empty_cache()
    return runs


def serve_run(engine, cfg, tok_t, len_t, lengths, n_new=64):
    """One engine: generate 8 x ``n_new`` with the launches counted, then
    one prefill timed apart and one decode step, their launches counted,
    the other decode steps timed apart, and the device-to-host copies of 8
    more decode steps counted (``dtoh_copies``); RuntimeError if there is
    one."""
    from repro_torch.kernels import cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(tok_t, n_new, lengths=lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (8, n_new) or out.dtype != torch.int32:
        raise RuntimeError(f"generate returned {tuple(out.shape)} "
                           f"{out.dtype}")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise RuntimeError("generated token ids out of the vocabulary")
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    last, pre = engine.prefill(tok_t, len_t)
    per_prefill = dict(cuda.LAUNCHES)
    cache = engine.splice_prefill(pre, len_t)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = last.argmax(-1, keepdim=True)
    cuda.reset_launches()
    cache, _ = engine.decode_step(cache, tok)
    per_step = dict(cuda.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, tok, _ = engine.decode_chunk_step(cache, tok, n_steps=n_new - 2)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / (n_new - 2) * 1e3
    copies = dtoh_copies(
        lambda: engine.decode_chunk_step(cache, tok, n_steps=8), tok.device)
    if copies:
        raise RuntimeError(f"{copies} device-to-host copies in 8 decode "
                           f"steps")
    return {"new_tokens": n_new, "generate_s": wall,
            "tokens_per_s": 8 * n_new / wall,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_ms, "dtoh_copies_8_steps": copies,
            "launches": launches, "launches_per_prefill": per_prefill,
            "launches_per_decode_step": per_step,
            "residency": engine.residency(cache),
            "max_memory_allocated": peak, "tokens": out.tolist()}


def serve_breakdown(engine, tok_t, len_t) -> dict:
    """torch.profiler breakdowns (``device_breakdown``) of one prefill and
    of the 8 decode steps after it."""
    got = []
    prefill = device_breakdown(
        lambda: got.append(engine.prefill(tok_t, len_t)))
    last, pre = got[0]
    cache = engine.splice_prefill(pre, len_t)
    tok = last.argmax(-1, keepdim=True)
    return {"prefill": prefill, "decode_8_steps": device_breakdown(
        lambda: engine.decode_chunk_step(cache, tok, n_steps=8))}


# ------------------------------------------------------------- schedule
SCHED_SLOTS = 8
SCHED_DEPTH = 2                  # olmo-1b's first layers: gates A, B and D
                                 # hold at any depth, and the script's time
                                 # limit holds the zoo's phases too
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
    # MLA's latent (deepseek-v3): never paged or quantized, decoded by the
    # absorbed form's plain products
    "contiguous-full": ({"cache": "full"},
                        {"quant_matmul", "flash_attention", "lsq_fakequant"},
                        {"kv_decode_attention",
                         "paged_kv_decode_attention"}),
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
            # over a mixture of experts (``counting_drops``): each
            # admission's dropped slots a token, a layer (device tensors),
            # and the decode steps'
            self.drops = {"decode": []}
            self._tag = "decode"

        def counting_drops(self):
            """``mlp._moe_local`` patched to record, beside each call, the
            slots of each token that its expert's capacity dropped, under
            the admission being prefilled (or "decode"): device ops, no
            host read."""
            from repro_torch.models import mlp
            orig = mlp._moe_local

            def counted(x_flat, top_ids, top_w, banks, sa_gate, sa_down,
                        bits_gateup, bits_down, capacity, *rest):
                _, order, pos = mlp.slot_ranks(top_ids.reshape(-1),
                                               len(bits_gateup))
                per_token = torch.zeros(
                    (top_ids.shape[0],), dtype=torch.int32,
                    device=top_ids.device).scatter_add_(
                    0, order // top_ids.shape[1],
                    (pos >= capacity).to(torch.int32))
                self.drops.setdefault(self._tag, []).append(per_token)
                return orig(x_flat, top_ids, top_w, banks, sa_gate, sa_down,
                            bits_gateup, bits_down, capacity, *rest)
            return patched(mlp, "_moe_local", counted)

        def dropped(self, uid, rows=None) -> int:
            """Slots of the first ``rows`` tokens of ``uid``'s admission
            prefill (all of them by default) that capacity dropped, over
            the layers."""
            return int(sum(int(d[:rows].sum()) for d in
                           self.drops.get(uid, [])))

        def _record(self, plan, *args, **kw):
            self._plan = plan(*args, **kw)
            return self._plan

        def _admit_contiguous(self, j, req):
            self._tag = req.uid
            try:
                last = super()._admit_contiguous(j, req)
            finally:
                self._tag = "decode"
            self.plans[req.uid] = ("miss", 0)
            self.first_logits[req.uid] = last[0].float().clone()
            return last

        def _admit_paged(self, j, req):
            orig = paging.plan_admission
            self._tag = req.uid
            try:
                with patched(paging, "plan_admission",
                             lambda *a, **k: self._record(orig, *a, **k)):
                    last = super()._admit_paged(j, req)
            finally:
                self._tag = "decode"
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
    from repro_torch.serve import Request, residency
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
    moe = any(b.ffn == "moe" for b in engine.cfg.pattern)
    drops = (sched.counting_drops() if moe and not profile
             else contextlib.nullcontext())
    with ctx as prof, drops:
        t0 = time.perf_counter()
        sched.run()
        sync(dev)
        wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "launches": dict(cuda.LAUNCHES),
           "admissions": len(sched.first_logits), "chunks": sched.chunks,
           "deferrals": sched.deferrals, "plans": sched.plans,
           "latency_report": sched.latency_report(),
           "pool_bytes": residency.resident_kv_bytes(sched.cache),
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
    if moe and not profile:
        rec["dropped_slots"] = {u: sched.dropped(u) for u in sched.plans}
        rec["decode_dropped_slots"] = sched.dropped("decode")
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


OLMO_SCHED_RUNS = ("paged-full", "paged-int8", "contiguous-int4")


def phase_schedule(cfg, packed, pa, dev, smi_line, runs=OLMO_SCHED_RUNS):
    """The continuous-batching scheduler over a decoder at full width
    (olmo-1b; qwen2-vl-7b's paged full run, whose suffix prefills rotate
    by shifted M-RoPE streams; deepseek-v3's contiguous full run over
    MLA's latent): the 24
    requests of ``schedule_requests`` through 8 slots (max_seq 1024, page
    16, decode chunk 16, prompt bucket 16), each run of ``runs``: paged
    full bf16 (aligned hits
    through the suffix prefill), paged int8 (identical hits and
    copy-on-write), contiguous int4 and contiguous full; the paged pools
    hold 160 pages, so
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
    for name in runs:
        spec, need, never = SCHED_RUNS[name]
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
        with (serial.counting_drops() if "dropped_slots" in rec
              else contextlib.nullcontext()):
            for uid, prompt, n, e in reqs:
                serial.submit(Request(uid=uid, prompt=prompt,
                                      max_new_tokens=n, eos_id=e))
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
        if "dropped_slots" in rec:
            # over a mixture of experts: each request's admission prefill
            # dropped slots in both runs (the same computation where the
            # plans agree) and the decode steps' (none: n_slots tokens
            # send at most one slot each to an expert of 8 rows or more)
            rec["gate_a"]["dropped_slots"] = {
                u: [rec["dropped_slots"][u], serial.dropped(u)]
                for u, *_ in reqs}
            rec["gate_a"]["decode_dropped_slots"] = [
                rec["decode_dropped_slots"], serial.dropped("decode")]
            dropping = {u: d for u, d in rec["gate_a"][
                "dropped_slots"].items() if any(d)}
            log(f"    experts' capacity: {len(dropping)} admission "
                f"prefills dropped slots (concurrent, serial): {dropping}; "
                f"decode steps dropped "
                f"{rec['gate_a']['decode_dropped_slots']}")
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
    from repro_torch.models.mlp import capacity_of
    from repro_torch.serve import EngineSpec, ServeEngine
    moe = "dropped_slots" in rec
    off, off_rec = schedule_run(engine, reqs, dev, share=False)
    hits = [u for u, p in conc.plans.items() if p[0] == "aligned"]
    if not hits:
        raise RuntimeError("schedule paged-full: no aligned prefix hit")
    ref = ServeEngine(cfg, packed, pa, SCHED_MAX_SEQ, EngineSpec(),
                      device=dev, impl="ref")
    gaps, control, control64, equal, exact = {}, {}, {}, {}, {}
    dropped = {}
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
        pad = conc._bucket_pad(len(prompt) - st, SCHED_MAX_SEQ - st)
        tiled = pad > GEMV_MAX_M
        if moe:
            # the experts' buffers take the tiled kernel too, and no slot
            # of a token that reaches the logits was dropped: of the
            # suffix, of the prefix rows in the misses that registered it,
            # or of the whole prompt without sharing
            tiled = tiled and capacity_of(cfg, pad) > GEMV_MAX_M
            donors = [u for u, p, _, _ in reqs
                      if conc.plans[u][0] == "miss" and p[:st] == prompt[:st]]
            dropped[uid] = {
                "suffix": conc.dropped(uid, len(prompt) - st),
                "prefix_in_donors": sum(conc.dropped(u, st) for u in donors),
                "whole_without_sharing": off.dropped(uid, len(prompt))}
            tiled = tiled and not any(dropped[uid].values())
        if tiled:
            exact[uid] = torch.equal(got, got_off)
        equal[uid] = conc.completed[uid].tokens == off.completed[uid].tokens
    control_bound = CONTROL_FACTOR * max(control64.values())
    bound = CONTROL_FACTOR * max(control.values())
    worst = max(control, key=control.get)
    prompt = next(p for u, p, _, _ in reqs if u == worst)
    toks = conc._prompt_tokens(prompt, conc._bucket_pad(len(prompt),
                                                         SCHED_MAX_SEQ))
    first = first_difference(engine, toks, len(prompt))
    first["uid"] = worst
    if first["first"] is not None:
        # the first differing block's ops on its first differing row
        first["ops"] = op_trace(engine, toks, len(prompt),
                                first["first"]["block"],
                                first["first"]["row"])
    gemv = {u: g for u, g in gaps.items() if u not in exact}
    # a gap over the bound where the experts' capacity dropped a slot of
    # the hit (in either run) is that drop's, and is named; any other fails
    explained = {u: dropped[u] for u, g in gemv.items()
                 if g > bound and any(dropped.get(u, {}).values())}
    res = {"sharing_off": {k: off_rec[k] for k in (
               "peak_pages", "live_peak_pages", "pages_in_use_after",
               "wall_s", "tokens_per_s")},
           "gate_b_aligned": {"gap": gaps, "bit_equal": exact,
                              "control": control,
                              "control_f64": control64,
                              "control_bound": control_bound,
                              "bound": bound, "tokens_equal": equal,
                              "dropped_slots": dropped,
                              "over_bound_by_drops": explained,
                              "first_difference": first}}
    log(f"    gate B: {len(hits)} aligned hits; first-token logits bit for "
        f"bit those of share_prefixes=False for {sum(exact.values())} of "
        f"{len(exact)} tiled suffixes; {len(gemv)} GEMV suffixes "
        f"{sorted(gemv)}, gap at most {max(gemv.values(), default=0.0):.4g} "
        f"(bound {CONTROL_FACTOR} x control {max(control.values()):.4g} = "
        f"{bound:.4g}); control within {CONTROL_FACTOR} x float64 control "
        f"{max(control64.values()):.4g} = {control_bound:.4g}; tokens equal "
        f"for {sum(equal.values())} of {len(hits)}")
    log(f"    gate B control, {worst}'s whole prefill ({len(prompt)} tokens),"
        f" each block against its plain version on the same input: "
        f"max|d|/max|ref| per block "
        f"{' '.join(f'{e:.3g}' for e in first['block_rel_err'])} (the "
        f"first block's bound {ONE_BLOCK_BOUND}); first difference "
        f"{first['first']}")
    for op in first.get("ops", []):
        log(f"      {op}")
    if moe:
        log(f"    gate B, experts: hits with dropped slots (suffix, prefix "
            f"rows in donors, whole without sharing): "
            f"{ {u: d for u, d in dropped.items() if any(d.values())} }; "
            f"over the bound by those drops: {sorted(explained)}")
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
    if not max((g for u, g in gemv.items() if u not in explained),
               default=0.0) <= bound:
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


def first_difference(engine, toks, n: int) -> dict:
    """One prompt's whole prefill (``toks`` (1, S), ``n`` valid rows) on
    the engine's kernel path, each block shadowed by its plain version
    (impl="ref") on the same input and a copy of the same cache: each
    block's max|d|/max|ref| over the valid rows, and the first block and
    row where the two differ, with the column of that row's largest
    difference and both values there."""
    from repro_torch.models import transformer as tf
    outs, real = [], tf.block_apply

    def both(p, x, bits, cfg, bdef, mode, cache, positions, impl="auto",
             hvp=False, mrope_positions=None):
        copy = None if cache is None else {k: v.clone()
                                           for k, v in cache.items()}
        want, _, _ = real(p, x, bits, cfg, bdef, mode, copy, positions,
                          "ref", hvp, mrope_positions)
        got, new, aux = real(p, x, bits, cfg, bdef, mode, cache, positions,
                             impl, hvp, mrope_positions)
        outs.append((got[0, :n].float(), want[0, :n].float()))
        return got, new, aux
    with patched(tf, "block_apply", both), torch.no_grad():
        engine.prefill(toks, torch.tensor([n]))
    rec = {"n": n, "block_rel_err": [], "first": None}
    for i, (got, want) in enumerate(outs):
        d = (got - want).abs()
        rec["block_rel_err"].append(float(d.max() / want.abs().max()))
        if rec["first"] is None and bool((d > 0).any()):
            row = int(torch.nonzero(d.amax(-1) > 0)[0, 0])
            col = int(d[row].argmax())
            rec["first"] = {"block": i, "row": row, "col": col,
                            "kernel": float(got[row, col]),
                            "plain": float(want[row, col]),
                            "row_max_abs_diff": float(d[row, col]),
                            "block_rows_differing": int(
                                (d.amax(-1) > 0).sum())}
    return rec


def op_trace(engine, toks, n: int, block: int, row: int) -> list:
    """Block ``block`` of one prompt's whole prefill (``toks`` (1, S), ``n``
    valid rows), op by op: the block's plain version (impl="ref") and its
    kernel path run on the same block input, each recording the output of
    every activation fake-quant, matmul and attention in call order.  For
    the i-th op of the two: the rows of the n where they differ, the
    largest difference and max|plain|, the difference on ``row``, and for
    a fake-quant its step and the codes of ``row`` that differ.  Tells a
    kernel that computes a row wrongly (its op's row differs past
    rounding) from an activation code that flips at a rounding boundary
    (a fake-quant's row one step apart where its input differed by a
    rounding)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    real_block, rows = tf.block_apply, toks.shape[1]
    real = {"lsq": kops.lsq_fakequant, "mm": kops.packed_matmul,
            "flash": kops.flash_attention, "plain": attn.chunked_attention}
    calls, sink = [0], {"kernel": [], "plain": []}
    into, in_flash = [None], [False]

    def keep(name, t, step=None):
        if into[0] is not None and t.dim() >= 3 and t.shape[:2] == (1, rows):
            into[0].append((name, t.detach().reshape(rows, -1)[:n].float(),
                            step))

    def lsq(x, step, bits, impl="auto"):
        out = real["lsq"](x, step, bits, impl)
        for o, st in zip(out if isinstance(out, list) else [out],
                         step if isinstance(step, (list, tuple)) else [step]):
            keep("lsq_fakequant", o, float(st))
        return out

    def mm(x, p, impl="auto"):
        out = real["mm"](x, p, impl)
        keep("matmul", out)
        return out

    def flash(q, k, v, causal=True, impl="auto"):
        in_flash[0] = True     # a stand-in that calls the plain one
        try:
            out = real["flash"](q, k, v, causal, impl)
        finally:
            in_flash[0] = False
        keep("attention", out.transpose(1, 2))
        return out

    def plain(*a, **k):
        out = real["plain"](*a, **k)
        if not in_flash[0]:
            keep("attention", out)
        return out

    def traced(p, x, bits, cfg, bdef, mode, cache, positions, impl="auto",
               hvp=False, mrope_positions=None):
        i, calls[0] = calls[0], calls[0] + 1
        if i == block:
            copy = None if cache is None else {k: v.clone()
                                               for k, v in cache.items()}
            into[0] = sink["plain"]
            real_block(p, x, bits, cfg, bdef, mode, copy, positions, "ref",
                       hvp, mrope_positions)
            into[0] = sink["kernel"]
        try:
            return real_block(p, x, bits, cfg, bdef, mode, cache, positions,
                              impl, hvp, mrope_positions)
        finally:
            into[0] = None
    with contextlib.ExitStack() as stack, torch.no_grad():
        for module, name, fn in ((kops, "lsq_fakequant", lsq),
                                 (kops, "packed_matmul", mm),
                                 (kops, "flash_attention", flash),
                                 (attn, "chunked_attention", plain),
                                 (tf, "block_apply", traced)):
            stack.enter_context(patched(module, name, fn))
        engine.prefill(toks, torch.tensor([n]))
    got, want = sink["kernel"], sink["plain"]
    if [o[0] for o in got] != [o[0] for o in want]:
        return [{"ops_kernel": [o[0] for o in got],
                 "ops_plain": [o[0] for o in want]}]
    trace = []
    for (name, g, step), (_, w, _) in zip(got, want):
        d = (g - w).abs()
        differ = torch.nonzero(d.amax(-1) > 0)[:, 0].tolist()
        rec = {"op": name, "rows_differing": len(differ),
               "first_rows": differ[:8], "max_abs_diff": float(d.max()),
               "max_abs_plain": float(w.abs().max()),
               "row_max_abs_diff": float(d[row].max())}
        if step is not None:
            rec.update(step=step, row_codes_differing=int(
                (d[row] > 0).sum()), row_max_diff_in_steps=float(
                    d[row].max()) / step)
        trace.append(rec)
    return trace


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


def plain_attention(dtype, probs_dtype):
    """The plain prefill attention (``chunked_attention``'s arguments: q, k,
    v (B, S, H, D) at the query head count) in one piece, computed in
    ``dtype`` with its probabilities rounded to ``probs_dtype`` before the
    product with V: a control attention, exact in its own way and rounded
    otherwise than the plain version."""
    def attend(q, k, v, chunk, causal, scale=None):
        s, d = q.shape[1], q.shape[-1]
        logits = torch.einsum("bshd,bthd->bhst", q.to(dtype), k.to(dtype)) * (
            d ** -0.5 if scale is None else scale)
        if causal:
            keep = torch.ones((s, s), dtype=torch.bool,
                              device=q.device).tril()
            logits = logits.masked_fill(~keep, float("-inf"))
        p = torch.softmax(logits, dim=-1).to(probs_dtype).to(dtype)
        return torch.einsum("bhst,bthd->bshd", p, v.to(dtype)).to(q.dtype)
    return attend


# as exact as the float32 plain version (phase_check's control)
attention_f64 = plain_attention(torch.float64, torch.float64)
# float32 with bf16 probabilities: the one rounding the flash kernel adds to
# the plain version (its PV product takes bf16 probabilities)
attention_bf16_probs = plain_attention(torch.float32, torch.bfloat16)


def shadowed(block_apply, errs: list):
    """``block_apply`` that also runs the plain version of each block
    (impl="ref") on the same input and a copy of the same cache, and
    appends the relative RMS and max-abs errors of the block's output."""
    def both(p, x, bits, cfg, bdef, mode, cache, positions, impl="auto",
             hvp=False, mrope_positions=None):
        copy = None if cache is None else {k: v.clone()
                                           for k, v in cache.items()}
        want, _, _ = block_apply(p, x, bits, cfg, bdef, mode, copy,
                                 positions, "ref", hvp, mrope_positions)
        got, new, aux = block_apply(p, x, bits, cfg, bdef, mode, cache,
                                    positions, impl, hvp, mrope_positions)
        errs.append((rel_rms_err(got, want), rel_err(got, want)))
        return got, new, aux
    return both


def teacher_forced(cfg, packed, pa, dev, tok_t, len_t, bits, n_decode,
                   fake_quant=None):
    """The kernel path, the plain path (impl="ref") and two controls - the
    plain path with its prefill attention in float64 ("control"), and in
    float32 with bf16 probabilities ("control_bf16") - on the same weights
    and cache kind (``bits``: an int or per-layer cache bits), all fed the
    kernel path's greedy tokens over the prefill and ``n_decode`` decode
    steps; with ``fake_quant`` (the same weights in the fake-quant layout)
    also that layout's kernel and plain paths.  The kernel path runs
    through the engine's own loop, each of its blocks shadowed by the plain
    block.
    Returns each path's logits per step and the block errors, steps by
    blocks."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.serve import EngineSpec, ServeEngine
    spec = EngineSpec(cache="quantized", cache_bits=bits)
    engines = {name: ServeEngine(cfg, packed, pa, 1024, spec, device=dev,
                                 impl=impl)
               for name, impl in (("kernel", "auto"), ("plain", "ref"),
                                  ("control", "ref"), ("control_bf16", "ref"))}
    if fake_quant is not None:
        for name, impl in (("fake_quant", "auto"),
                           ("fake_quant_plain", "ref")):
            engines[name] = ServeEngine(
                cfg, fake_quant, pa, 1024,
                EngineSpec(weights="fake_quant", cache="quantized",
                           cache_bits=bits), device=dev, impl=impl)
    errs, blocks = [], []
    swaps = {"kernel": (tf, "block_apply", shadowed(tf.block_apply, errs)),
             "control": (attn, "chunked_attention", attention_f64),
             "control_bf16": (attn, "chunked_attention",
                              attention_bf16_probs)}

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


def phase_check(cfg, packed, pa, dev, tokens, lengths, n_decode=16,
                cache_bits=(8, 4)):
    """Kernel path against the plain path (impl="ref") on the same weights,
    teacher-forced over the prefill and ``n_decode`` decode steps, over
    each cache width of ``cache_bits``, with three readings:

      all blocks - max|dlogit|/max|logit| over the steps, bounded by
        CONTROL_FACTOR times the larger of two controls against the plain
        path: the plain path with its prefill attention in float64, and in
        float32 with bf16 probabilities (the yardstick of the joint phase's
        J5).  Each projection's activation fake-quant turns an output that
        rounds to another bf16 into a whole code step, and the blocks that
        follow amplify it: two exact attentions that round apart already
        drift far apart over 16 blocks of this random model (PERF.md), so a
        fixed bound below their drift cannot hold for any kernel, and on a
        random stack the drift is chaotic: a rounding-level change of the
        inputs (RoPE's frequencies rounded right) moved it across the
        float64 control alone;
      the first block alone - bounded by ONE_BLOCK_BOUND: nothing to
        amplify, and the projections are exact in any summation order;
      each block's own output - the plain block takes the kernel block's
        input and cache (``shadowed``); RMS bounded by BLOCK_RMS_BOUND, as
        one flipped code moves one token's row by one code step.
    """
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    # the first block: a model's first prefix block where it has them
    if cfg.prefix:
        one = cfg.replace(prefix=cfg.prefix[:1], n_repeats=0)
        one_block = dict(packed, pat=[])
    else:
        one = cfg.replace(n_repeats=1)
        one_block = dict(packed, pat=packed["pat"][:1])
    res, bad = {}, {}
    for bits in cache_bits:
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
            "control_bf16_rel_logit_err": [
                rel_err(a, b) for a, b in zip(logits["control_bf16"],
                                              plain)],
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
        rec["yardstick"] = max(worst["control_rel_logit_err"],
                               worst["control_bf16_rel_logit_err"])
        e2e_bound = CONTROL_FACTOR * rec["yardstick"]
        log(f"  check int{bits}: {len(cfg.prefix) + cfg.n_repeats} "
            f"blocks: max|dlogit|/"
            f"max|logit| {worst['rel_logit_err']:.4g} (bound "
            f"{CONTROL_FACTOR} x the larger control = {e2e_bound:.4g}), "
            f"RMS {worst['rel_rms_logit_err']:.4g}, top-1 agreement "
            f"{rec['top1_agreement']:.3f}; per step "
            f"{' '.join(f'{e:.2g}' for e in rec['rel_logit_err'])}")
        log(f"    control (float64 prefill attention vs plain): "
            f"{worst['control_rel_logit_err']:.4g}, RMS "
            f"{worst['control_rel_rms_logit_err']:.4g}; bf16-probability "
            f"control {worst['control_bf16_rel_logit_err']:.4g}; kernel vs "
            f"control "
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


def block_sites(cfg, bdef) -> tuple:
    """(activation, weight) fake-quant sites of one block in a train step
    (steps that share an input grouped into one launch).  The mixer: GQA's
    q/k/v input and o's (2) and its q, k, v and o weights (4); or MLA's
    input of wq_a and wkv_a, q_c (wq_b's input) and wo's input (3) and its
    six weights (wq_a, wq_b, wkv_a, wk_b, wv_b, wo: wk_b and wv_b are read
    as weights only, with no activation site).  The FFN: gate/up's input
    (up alone in a GeLU FFN) and down's (2) and 3 weights (2 with GeLU);
    or the router's input and weight, each expert's gate/up buffer and
    down input (2E) and gate, up and down weights (3E), and a shared
    expert's 2 and 3 as a dense SwiGLU's."""
    if bdef.mixer == "mla":
        acts, weights = 3, 6
    else:
        acts, weights = 2, 4
    if bdef.ffn == "moe":
        shared = 1 if cfg.n_shared_experts else 0
        acts += 1 + 2 * cfg.n_experts + 2 * shared
        weights += 1 + 3 * cfg.n_experts + 3 * shared
    else:
        acts += 2
        weights += 3 if bdef.ffn == "swiglu" else 2
    return acts, weights


def lsq_sites(cfg) -> dict:
    """Fake-quant sites of a train step (one launch each way): each block's
    (``block_sites``: the prefix blocks, then the pattern over its
    repeats), and the edges: the head's input and two weights, the
    embedding table twice (the gather's and the tied head's) or the table
    and the untied head once each; a multi-token head (``cfg.mtp``) adds
    its projection's input and weight, a second gather from the table
    and a second pass through the head (its input and weight again).  The
    backward recomputes each block (checkpointing), so its activation
    sites launch the forward a second time."""
    blocks = [block_sites(cfg, b) for b in cfg.prefix]
    blocks += [block_sites(cfg, b) for b in cfg.pattern] * cfg.n_repeats
    acts = sum(a for a, _ in blocks)
    weights = sum(w for _, w in blocks)
    mtp = 1 if cfg.mtp else 0
    return {"activations": acts + 1 + 2 * mtp,
            "weights": weights + 2 + 3 * mtp, "recomputed": acts}


def grads_of(state, cfg, batch, impl):
    """Step 1's loss and every leaf's gradient, with no update."""
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    loss, _ = tf.loss_fn(state.params, state.policy, batch, cfg, impl)
    leaves = tree.leaves(state.params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g.detach()
                           for g, p in zip(grads, leaves)]


# leaves that no forward reads, so their gradient is zero, as in the
# reference: an expert bank's up projection shares the gate's fake-quant of
# each buffer (the up bank's activation steps), and MLA reads wk_b and wv_b
# as weights only (their activation steps)
UNREAD_LEAVES = (("moe", "up", "sa"), ("attn", "wk_b", "sa"),
                 ("attn", "wv_b", "sa"))


def compare_grads(state, g_kernel, g_again, g_ref) -> dict:
    """T2: each gradient finite and not all zero (all zero for an
    UNREAD_LEAVES leaf); each gradient of a weight or another leaf that is
    not an LSQ step (a LayerNorm's scale or bias) of the kernel path bit
    for bit with impl="ref", or else equal to a second kernel-path run's
    (a difference the run itself makes); each step's (0-d, or an expert
    bank's one an expert) within STEP_GRAD_TOL relative."""
    from repro_torch import tree
    rec = {"leaves": 0, "w_equal": 0, "w_differ": [], "w_unexplained": [],
           "step_max_rel": 0.0, "unread": 0, "bad": []}
    for (path, _), a, b, c in zip(tree.flatten(state.params), g_kernel,
                                  g_again, g_ref):
        name = ".".join(str(x) for x in path)
        rec["leaves"] += 1
        if tuple(path[-3:]) in UNREAD_LEAVES:
            rec["unread"] += 1
            if bool((a != 0).any()) or bool((c != 0).any()):
                rec["bad"].append(f"{name}: an unread leaf's gradient is "
                                  f"not zero")
            continue
        if not (bool(torch.isfinite(a).all()) and bool((a != 0).any())):
            rec["bad"].append(f"{name}: not finite or all zero")
        if path[-1] not in ("sw", "sa"):   # weights, LayerNorm scale/bias
            if torch.equal(a, c):
                rec["w_equal"] += 1
            else:
                d = float((a.float() - c.float()).abs().max())
                rec["w_differ"].append((name, d))
                if torch.equal(a, b):
                    rec["w_unexplained"].append((name, d))
        else:                              # LSQ steps, 0-d or a bank's
            rel = float(((a.double() - c.double()).abs()
                         / c.double().abs().clamp(min=1e-30)).max())
            rec["step_max_rel"] = max(rec["step_max_rel"], rel)
            if not rel <= STEP_GRAD_TOL:
                rec["bad"].append(f"{name}: step gradient {a.tolist()} vs "
                                  f"{c.tolist()} ({rel:.3g} relative)")
    rec["bad"] += [f"{n}: w gradient differs from impl='ref' by {d}, and "
                   f"two kernel-path runs agree" for n, d in
                   rec["w_unexplained"]]
    return rec


def phase_train(cfg, dev, smi_line, batch=None, state_dtype="f32",
                lr=None):
    """QAT of ``cfg`` at full width and depth (weights from seed 0, in the
    config's dtype), uniform 4-bit, AdamW (``lr``, LR by default, clip
    1.0, moments in
    ``state_dtype``: float32, or the port's rowwise int8), the port's
    synthetic batches of ``batch`` (B, S) tokens (default TRAIN_B x
    TRAIN_S, olmo-1b's), TRAIN_STEPS steps.  Gates: (T1)
    step 1's loss on the kernel path equals impl="ref"'s bit for bit; (T2)
    ``compare_grads``; (T3) the mean loss of the last 4 steps below step
    1's; (T4) each step launches the LSQ forward once a site and once more
    a recomputed site, and the backward once a site; (T5) no flash
    attention (bf16 or float32), quant_matmul or decode attention launch.
    Readings: ms/step on the host clock (synchronized), tokens/s, MFU
    (against the dense peak of the compute dtype: bf16 tensor cores, or
    float32 outside them), peak memory, and a profiled step (device ms,
    idle share, top 20, LSQ ms).  Returns the final state and the
    record."""
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
        AdamW, learning_rate=lr or LR, grad_clip=GRAD_CLIP,
        state_dtype=state_dtype), 0, policy, device=dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    n_b, n_s = batch or (TRAIN_B, TRAIN_S)
    batches = [make_batch(0, i, n_b, n_s, cfg.vocab, device=dev)
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
    tokens = n_b * n_s
    peak_ops = (F32_OPS_PER_S if cfg.compute_dtype == torch.float32
                else BF16_OPS_PER_S)
    rec = {"config": f"{cfg.name} d_model={cfg.d_model} layers="
                     f"{cfg.n_repeats} heads={cfg.n_heads} d_ff={cfg.d_ff} "
                     f"vocab={cfg.vocab} {cfg.param_dtype}",
           "device": smi_line, "batch": [n_b, n_s],
           "state_dtype": state_dtype,
           "steps": TRAIN_STEPS, "n_params": n_params, "losses": losses,
           "step_ms": [w * 1e3 for w in wall], "ms_per_step": ms,
           "first_step_ms": wall[0] * 1e3,
           "tokens_per_s": tokens / (ms / 1e3),
           "mfu": 6.0 * n_params * tokens / ((ms / 1e3) * peak_ops),
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "launches_step1_grads": once, "sites": sites, "grads": grads,
           "t1_loss_equal": t1_equal, "profile": prof,
           "last4_mean": float(np.mean(losses[-4:]))}
    rec["t3_margin"] = losses[0] - rec["last4_mean"]
    log(f"  {rec['config']}: {TRAIN_STEPS} steps of {n_b} x {n_s}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (last 4 mean "
        f"{rec['last4_mean']:.4f}, margin {rec['t3_margin']:.4f})")
    log(f"  {ms:.1f} ms/step (host clock, median of steps 2-{TRAIN_STEPS}; "
        f"step 1 {wall[0] * 1e3:.1f}), {rec['tokens_per_s']:.0f} tokens/s, "
        f"MFU {rec['mfu']:.4f} (6 N tokens, N = {n_params}, at "
        f"{peak_ops / 1e12:.0f} TFLOP/s);"
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
    for name in ("flash_attention", "flash_attention_f32", "quant_matmul",
                 "kv_decode_attention", "paged_kv_decode_attention"):
        if launches[name]:
            bad.append(f"T5: {name} launched {launches[name]} times")
    if bad:
        raise RuntimeError(f"train phase: {bad}")
    return state, rec


def phase_alps(cfg, dev, state, smi_line, ref_units=None):
    """ALPS over every selectable unit from the train phase's final state
    (ALPS_STEPS steps a probe at ALPS_B x ALPS_S on make_batch(11, i)),
    then EAGL through the histogram kernel on the same weights; the
    knapsack take at budget 0.7 from each, their overlap, and their wall
    seconds.  Gates: (A1) after ALPS the params equal the b_hi state bit
    for bit; (A2) the first unit's probe, run again at the end, gives its
    gain bit for bit; (A3) on ``ref_units`` (unit names; the first
    ALPS_REF_UNITS units by default) the kernel path's gains within
    ALPS_REF_TOL relative of impl="ref"'s."""
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
    b_hi = host_params(state)
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
    a1 = params_equal(state, b_hi)
    first = units[0]
    again = probe(policy=policy.apply_selection({first.name: False}),
                  steps=ALPS_STEPS)["loss"]
    a2 = again == gains[first.name]
    del probe      # its copy of the b_hi state, before the next one's
    ref_probe = make_probe(state, make_train_step(cfg, impl="ref"),
                           lambda i: batches[i])
    a3 = {}
    for name in ref_units or [u.name for u in units[:ALPS_REF_UNITS]]:
        g = ref_probe(policy=policy.apply_selection({name: False}),
                      steps=ALPS_STEPS)["loss"]
        a3[name] = abs(gains[name] - g) / abs(g)
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


def host_params(state) -> list:
    """A copy of the params in host memory: the b_hi state that gates A1
    and H2 compare with, kept off the card (9 GB at dbrx-132b's layer)."""
    from repro_torch import tree
    return [p.detach().to("cpu", copy=True)
            for p in tree.leaves(state.params)]


def params_equal(state, saved) -> bool:
    from repro_torch import tree
    return all(torch.equal(p.detach().to(q.device), q) for p, q in
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
    (H3) on A3's units (``alps["a3_rel"]``), with the same HAWQ_REF_PROBES
    injected probes, the kernel route's traces within HAWQ_REF_TOL of impl="ref"'s
    (relative to the largest); (H4) no lsq_fakequant_bwd launch during the
    products."""
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
    b_hi = host_params(state)
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
            if k.split("/")[0] in alps["a3_rel"]}
    # the same probes on both routes, drawn anew for each (a generator
    # from one seed), so that no list of whole-model probes is held
    traces = {impl: hawq.hutchinson_traces(
        hawq.hvp_loss(cfg, pa, impl), state.params, some, hcfg, batch,
        probes=hawq.rademacher_probes(state.params, hawq.HawqConfig(
            n_probes=HAWQ_REF_PROBES, seed=1)))
        for impl in ("auto", "ref")}
    top = max(abs(v) for v in traces["ref"].values())
    h3 = max(abs(traces["auto"][k] - traces["ref"][k]) for k in some) / top

    # per-expert HAWQ: the experts of one bank read their own gains
    banks = {}
    for u in units:
        if u.sub is not None:
            banks.setdefault((u.slot, u.layer), []).append(gains[u.name])
    same_bank = [k for k, v in banks.items() if len(set(v)) < len(v)]
    take_h = knapsack.select_for_budget(policy, gains, budget_frac=0.7).take
    rec = {"device": smi_line, "units": len(units), "probes": hcfg.n_probes,
           "expert_banks": len(banks), "banks_with_equal_gains": same_bank,
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
        f"{launches['lsq_fakequant_bwd']}"
        + (f"; {len(banks)} expert banks, each expert its own gain: "
           f"{not same_bank}" if banks else ""))
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
    if same_bank:
        bad.append(f"experts of one bank read equal gains: {same_bank}")
    if bad:
        raise RuntimeError(f"hawq phase: {bad}")
    return rec


def phase_frontier(cfg, dev, state, gains, smi_line,
                   budgets=FRONTIER_BUDGETS):
    """``frontier.sweep`` over the methods of ``gains`` (method -> gains,
    None for the greedy ones; eagl, alps, hawq_v3, uniform, first_to_last
    and last_to_first from ``selection_methods``) at ``budgets``.  Each
    point restores the b_hi state, fine-tunes FRONTIER_STEPS steps
    (make_batch(7, i), frontier_bench's fine-tune seed, at ALPS_B x
    ALPS_S, the train phase's AdamW) and
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
    points = frontier.sweep(policy, gains, finetune_eval, list(budgets))
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
    rec = {"device": smi_line, "budgets": list(budgets),
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
                         joint.take).kv_bytes_per_token(),
                     "take": joint.take}}
    log(f"  {len(points)} points ({len(gains)} methods x "
        f"{len(budgets)} budgets), {FRONTIER_STEPS} fine-tune "
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


def projection_pairs(a, b):
    """(PackedLinear, fake-quant node) of each projection of two serve
    trees of one model."""
    from repro_torch.core.quant import PackedLinear
    if isinstance(a, PackedLinear):
        yield a, b
    elif isinstance(a, dict):
        for k in a:
            yield from projection_pairs(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            yield from projection_pairs(x, y)


def leaf_layout_ok(leaf: dict, bits: int, layout: str, cfg) -> bool:
    """Does a cache leaf hold the layout its bits select: full-dtype K/V at
    16, else codes of ``bits`` (int8 rows of head_dim, or uint8 rows of
    head_dim / 2)?"""
    from repro_torch.kernels import kv_quant as kvq
    paged = "p" if layout == "paged" else ""
    if bits == 16:
        return f"{paged}k" in leaf and f"{paged}kq" not in leaf
    codes = leaf.get(f"{paged}kq")
    return (codes is not None and codes.dtype == kvq.code_dtype(bits)
            and codes.shape[-1] == kvq.packed_dim(cfg.head_dim, bits))


JOINT_DECODE = 16                # J5's teacher-forced decode steps


def phase_joint(cfg, dev, raw, take, smi_line):
    """Serve the joint weight-and-cache knapsack's ``take`` (the frontier
    phase's, at JOINT_BUDGET and JOINT_CONTEXT) from the raw b_hi params
    ``raw``: the weights packed at its 4/2 bits and, once more, in the
    fake-quant layout (``quantize_for_serving``), each layer's KV cache at
    its own bits (``policy.apply_cache_selection(take).cache_bits_arrays()``).
    Phase 4's traffic (8 prompts of 128-512 tokens padded to 512, 64 new
    tokens, max_seq 1024) runs packed over the contiguous and the paged
    (page PAGE) mixed cache, then fake-quant over the contiguous one.
    Gates:
      J1 each layer's cache leaf has the layout its bits select, and the
         mixed cache's resident KV bytes are the sum of its layers' bytes
         in the uniform caches of those bits, strictly between the uniform
         int4 and int8 totals (both layouts);
      J2 paged tokens equal contiguous tokens, 8 x 64;
      J3 per prefill flash_attention once a layer; per prefill and decode
         step quant_matmul 7 a layer (packed) or never (fake-quant) and
         lsq_fakequant 4 a layer and the head's; per decode step the
         layout's decode attention once a quantized layer, the other
         layout's never;
      J4 the fake-quant codes equal the packed codes unpacked, bit for bit,
         and their scales the packed scales, for every projection and the
         embedding;
      J5 teacher-forced over the prefill and JOINT_DECODE decode steps on
         the mixed cache (phase_check's rule, each reading at most
         CONTROL_FACTOR times its control, and each block's own output
         within BLOCK_RMS_BOUND): the kernel path against impl="ref" in
         each layout, over the larger of two controls, the plain path with
         its prefill attention in float64 (phase_check's) and in float32
         with bf16 probabilities (the rounding the flash kernel adds); the
         fake-quant engine against the packed engine, over the larger of
         those and the layout control, their two plain paths against each
         other.  Two controls: on the b_hi state the drift over 16 blocks
         is 0.03-0.04, far from the saturated 0.3 of phase_check's random
         weights, and there it grows with the perturbation's size; the
         float64 control perturbs by float32 roundings (2^-24), the
         kernel by bf16 probabilities (2^-9), and read 0.0304 against the
         kernel path's 0.0390 (an H100 80GB HBM3 at 700 W).  The layout
         control: the fake-quant layout multiplies by its weights cast to
         the compute dtype (bf16), as the reference and the training
         forward do; the packed kernel keeps the codes exact and scales
         after its float32 accumulator, so the layouts differ by a
         rounding of every weight."""
    from repro_torch.core import quant
    from repro_torch.models import transformer as tf
    from repro_torch.serve import (EngineSpec, ServeEngine, pack_params,
                                   packing, quantize_for_serving, residency)
    policy = tf.build_policy(cfg)
    pa = policy.apply_selection(take).as_arrays()
    cache_bits = policy.apply_cache_selection(take).cache_bits_arrays()
    bits = [[int(cache_bits[f"pat{j}"][r]) for j in range(len(cfg.pattern))]
            for r in range(cfg.n_repeats)]
    n_layers = cfg.n_repeats * len(cfg.pattern)
    n_quant = sum(b != 16 for row in bits for b in row)
    packed = pack_params(raw, pa, cfg, device=dev)
    fake = quantize_for_serving(raw, pa, cfg, device=dev)
    bad = []

    def engine(params, layout, cbits=cache_bits, weights="packed"):
        return ServeEngine(cfg, params, pa, 1024,
                           EngineSpec(weights=weights, cache="quantized",
                                      cache_bits=cbits, cache_layout=layout,
                                      page_size=PAGE), device=dev)

    kv = {}
    for layout in ("contiguous", "paged"):
        mixed = engine(packed, layout).new_cache(8).layers["pat"]
        per_layer = {b: [{k: residency.resident_kv_bytes(leaf)
                          for k, leaf in layer.items()}
                         for layer in engine(packed, layout, b).new_cache(
                             8).layers["pat"]]
                     for b in {4, 8} | {b for row in bits for b in row}}
        total = {b: sum(sum(layer.values()) for layer in per_layer[b])
                 for b in per_layer}
        got = residency.resident_kv_bytes(mixed)
        want = sum(per_layer[b][r][f"p{j}"] for r, row in enumerate(bits)
                   for j, b in enumerate(row))
        wrong = [(r, j) for r, row in enumerate(bits)
                 for j, b in enumerate(row)
                 if not leaf_layout_ok(mixed[r][f"p{j}"], b, layout, cfg)]
        kv[layout] = {"mixed": got, "int8": total[8], "int4": total[4],
                      "sum_of_layers": want, "wrong_layers": wrong}
        if wrong or got != want or not total[4] < got < total[8]:
            bad.append(f"J1: {layout}: {kv[layout]}")
        log(f"  J1 {layout}: KV bytes {got} mixed = {want} summed over its "
            f"layers, between int4's {total[4]} and int8's {total[8]}; "
            f"layers of the wrong layout: {wrong}")
        del mixed, per_layer
    torch.cuda.empty_cache()

    tokens, lengths = make_prompts(cfg, np.random.default_rng(0))
    tok_t = torch.as_tensor(tokens, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    runs = {}
    for name, params, layout, weights in (
            ("packed-contiguous", packed, "contiguous", "packed"),
            ("packed-paged", packed, "paged", "packed"),
            ("fake_quant-contiguous", fake, "contiguous", "fake_quant")):
        eng = engine(params, layout, weights=weights)
        rec = serve_run(eng, cfg, tok_t, len_t, lengths)
        rec["weight_bytes_bf16"] = packing.bf16_weight_bytes(params)
        qmm = 7 * n_layers if weights == "packed" else 0
        lsq = 4 * n_layers + 1
        decode, other = ("kv_decode_attention", "paged_kv_decode_attention")
        if layout == "paged":
            decode, other = other, decode
        want = {"prefill": {"flash_attention": n_layers, "quant_matmul": qmm,
                            "lsq_fakequant": lsq},
                "decode step": {"quant_matmul": qmm, "lsq_fakequant": lsq,
                                decode: n_quant, other: 0,
                                "flash_attention": 0}}
        got = {"prefill": rec["launches_per_prefill"],
               "decode step": rec["launches_per_decode_step"]}
        bad += [f"J3: {name}: {k} launched {got[what][k]} times per {what},"
                f" {n} expected" for what in want
                for k, n in want[what].items() if got[what][k] != n]
        log_serve_run(f"joint {name}", rec)
        log(f"    per prefill: {got['prefill']}; per decode step: "
            f"{got['decode step']}")
        if layout == "contiguous":   # phase 4 profiles paged decode
            rec["profile"] = serve_breakdown(eng, tok_t, len_t)
            for what, brk in rec["profile"].items():
                log_breakdown(what, brk)
        runs[name] = rec
        del eng
        torch.cuda.empty_cache()
    same_tokens = runs["packed-paged"]["tokens"] == \
        runs["packed-contiguous"]["tokens"]
    if not same_tokens:
        bad.append("J2: the paged tokens differ from the contiguous ones")

    n_proj = 0
    codes_equal = all(torch.equal(packed["embed"][k], fake["embed"][k])
                      for k in ("wq", "scale"))
    for p, f in projection_pairs(packed["pat"], fake["pat"]):
        codes = (p.wp if p.bits == 8 else
                 quant.unpack_codes_kmajor(p.wp, p.bits, torch.int8)[
                     :p.k_dim])
        codes_equal &= (torch.equal(codes, f["wq"])
                        and torch.equal(p.scale, f["scale"].expand(p.n_dim)))
        n_proj += 1
    if not codes_equal or n_proj != 7 * n_layers:
        bad.append(f"J4: codes or scales differ over {n_proj} projections")

    logits, blocks = teacher_forced(cfg, packed, pa, dev, tok_t, len_t,
                                    cache_bits, JOINT_DECODE,
                                    fake_quant=fake)
    def drift(a, b):
        return [rel_err(x, y) for x, y in zip(logits[a], logits[b])]

    j5 = {"kernel_vs_plain": drift("kernel", "plain"),
          "fake_quant_vs_plain": drift("fake_quant", "fake_quant_plain"),
          "fake_quant_vs_packed": drift("fake_quant", "kernel"),
          "control": drift("control", "plain"),
          "control_bf16": drift("control_bf16", "plain"),
          "layout_control": drift("fake_quant_plain", "plain"),
          "block_rel_rms_err": [max(e[0] for e in row) for row in blocks]}
    worst = {k: max(v) for k, v in j5.items()}
    kernel_bound = CONTROL_FACTOR * max(worst["control"],
                                        worst["control_bf16"])
    bound = {"kernel_vs_plain": kernel_bound,
             "fake_quant_vs_plain": kernel_bound,
             "fake_quant_vs_packed": max(kernel_bound, CONTROL_FACTOR
                                         * worst["layout_control"]),
             "block_rel_rms_err": BLOCK_RMS_BOUND}
    bad += [f"J5: {k} {worst[k]} over {b}" for k, b in bound.items()
            if not worst[k] <= b]
    res = {w: runs[f"{w}-contiguous"]["residency"]
           for w in ("packed", "fake_quant")}
    rec = {"device": smi_line, "cache_bits": bits,
           "cache_int8": sum(b == 8 for row in bits for b in row),
           "cache_int4": sum(b == 4 for row in bits for b in row),
           "weights_4bit": sum(policy.apply_selection(take).bits_of(u.name)
                               == policy.b_hi
                               for u in policy.selectable_units()),
           "kv_bytes": kv, "runs": runs, "tokens_equal": same_tokens,
           "j4_projections": n_proj, "j4_equal": codes_equal, "j5": j5,
           "j5_bounds": bound,
           "weight_bytes": {"packed": res["packed"]["resident_weight_bytes"],
                            "fake_quant":
                                res["fake_quant"]["resident_weight_bytes"],
                            "bf16": packing.bf16_weight_bytes(packed)}}
    log(f"  cache bits by layer {[row[0] for row in bits]}: "
        f"{rec['cache_int8']} int8, {rec['cache_int4']} int4; "
        f"{rec['weights_4bit']} weight units at 4 bits; weights "
        f"{rec['weight_bytes']}")
    log(f"  J2 paged tokens equal contiguous: {same_tokens}; J4 codes and "
        f"scales equal over {n_proj} projections and the embedding: "
        f"{codes_equal}")
    log(f"  J5 teacher-forced, {JOINT_DECODE} decode steps: kernel vs plain "
        f"{worst['kernel_vs_plain']:.4g} packed, "
        f"{worst['fake_quant_vs_plain']:.4g} fake-quant (bound "
        f"{kernel_bound:.4g}: controls {worst['control']:.4g} float64, "
        f"{worst['control_bf16']:.4g} bf16 probabilities); fake-quant vs "
        f"packed {worst['fake_quant_vs_packed']:.4g} (bound "
        f"{bound['fake_quant_vs_packed']:.4g}: their plain paths "
        f"{worst['layout_control']:.4g}); each block's own output at most "
        f"{worst['block_rel_rms_err']:.4g} RMS (bound {BLOCK_RMS_BOUND})")
    if bad:
        raise RuntimeError(f"joint phase: {bad}")
    return rec


def selection_methods(policy, alps, hawq) -> dict:
    """The frontier's methods, as benchmarks/frontier_bench.py names them:
    method -> gains (None for the greedy baselines)."""
    from repro_torch.core.metrics import uniform_gains
    return {"eagl": alps["eagl"], "alps": alps["gains"],
            "hawq_v3": hawq["gains"], "uniform": uniform_gains(policy),
            "first_to_last": None, "last_to_first": None}


def encoder_forward(cfg, dev, raw, mixed, smi_line, inputs, tag):
    """The packed forward of an encoder (bert-base's B5, hubert-xlarge's
    H3): ``mixed`` (EAGL's take at 0.7) packed, then
    ``transformer.apply(..., mode="prefill")`` over ``inputs`` ({"tokens":
    (B, S)} or {"embeds": (B, S, d)}): its launches (``step_launches``: 6
    packed matmuls and 4 LSQ fake-quants a layer, one more for the head,
    and one flash_attention a layer, the float32 kernel's for a float32
    model; nothing else), finite logits of the expected shape, and the
    kernel path against impl="ref" within CONTROL_FACTOR times the
    control's drift: the plain path with its attention in float64 (as in
    phase_check: a whole code step of some activation fake-quant follows
    any rounding difference, and the blocks amplify it).  Readings: host
    ms (synchronized, median of 3), tokens/s, the profiled forward (device
    ms, idle share, top 10) and the resident weight bytes beside the same
    weights in float32 and bf16."""
    from repro_torch.kernels import cuda
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.serve import pack_params, packing, residency
    pa = mixed.as_arrays()
    packed = pack_params(raw, pa, cfg, device=dev)
    tokens, embeds = inputs.get("tokens"), inputs.get("embeds")
    b, s = (tokens if tokens is not None else embeds).shape[:2]
    per = step_launches(cfg)
    flash = ("flash_attention_f32" if cfg.compute_dtype == torch.float32
             else "flash_attention")
    want = {"quant_matmul": per["quant_matmul"],
            "lsq_fakequant": per["lsq_fakequant"],
            flash: per["attention"]}

    def forward(impl="auto"):
        return tf.apply(packed, pa, tokens, cfg, mode="prefill", impl=impl,
                        embeds=embeds)[0]

    with torch.no_grad():
        forward()
        sync(dev)
        cuda.reset_launches()
        got = forward()
        sync(dev)
        launches = dict(cuda.LAUNCHES)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward()
            sync(dev)
            walls.append(time.perf_counter() - t0)
        prof = device_breakdown(forward, top=10)
        plain = forward("ref")
        with patched(attn, "chunked_attention", attention_f64):
            control = forward("ref")
    ms = float(np.median(walls)) * 1e3
    weights_f32 = 2 * packing.bf16_weight_bytes(packed)
    rec = {"device": smi_line, "batch": [b, s],
           "inputs": "tokens" if tokens is not None else "embeds",
           "launches": launches, "expected_launches": want,
           "shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
           "rel_logit_err": rel_err(got, plain),
           "rel_rms_logit_err": rel_rms_err(got, plain),
           "control_rel_logit_err": rel_err(control, plain),
           "control_rel_rms_logit_err": rel_rms_err(control, plain),
           "kernel_vs_control_rel_logit_err": rel_err(got, control),
           "top1_agreement": float((got.argmax(-1) == plain.argmax(-1))
                                   .float().mean()),
           "host_ms": ms, "host_ms_runs": [w * 1e3 for w in walls],
           "tokens_per_s": b * s / (ms / 1e3), "profile": prof,
           "resident_weight_bytes": residency.resident_bytes(packed),
           "weight_bytes_bf16": packing.bf16_weight_bytes(packed),
           "weight_bytes_f32": weights_f32}
    rec["bound"] = CONTROL_FACTOR * rec["control_rel_logit_err"]
    log(f"  {tag} packed forward of EAGL's 0.7 take, {b} x {s} "
        f"{rec['inputs']} (mode='prefill'): {ms:.2f} ms host (median of 3), "
        f"{rec['tokens_per_s']:.0f} tokens/s; logits {rec['shape']} finite "
        f"{rec['finite']}; launches {launches} (expected {want})")
    log(f"    kernel vs plain max|dlogit|/max|logit| "
        f"{rec['rel_logit_err']:.4g} (bound {CONTROL_FACTOR} x control = "
        f"{rec['bound']:.4g}), RMS {rec['rel_rms_logit_err']:.4g}, top-1 "
        f"agreement {rec['top1_agreement']:.4f}; control (float64 "
        f"attention vs plain) {rec['control_rel_logit_err']:.4g}, RMS "
        f"{rec['control_rel_rms_logit_err']:.4g}; kernel vs control "
        f"{rec['kernel_vs_control_rel_logit_err']:.4g}")
    log(f"    weights {rec['resident_weight_bytes'] / 1e6:.1f} MB resident "
        f"vs {weights_f32 / 1e6:.1f} MB float32, "
        f"{rec['weight_bytes_bf16'] / 1e6:.1f} MB bf16")
    log_breakdown("the packed forward", prof)
    for row in prof["top"][6:]:
        log(f"      {row['ms']:9.3f} ms  x{row['count']:<5d} {row['kernel']}")
    log(f"    copy kernels (dtype casts among them): "
        f"{prof['copy_kernel_ms']:.3f} ms in {prof['copy_kernels']} launches")
    bad = []
    if rec["shape"] != [b, s, cfg.vocab] or not rec["finite"]:
        bad.append(f"logits of shape {rec['shape']}, finite {rec['finite']}")
    wrong = {k: n for k, n in launches.items() if n != want.get(k, 0)}
    if wrong:
        bad.append(f"launches {wrong}, expected {want}")
    if not rec["rel_logit_err"] <= rec["bound"]:
        bad.append(f"kernel vs plain {rec['rel_logit_err']} over "
                   f"{rec['bound']}")
    del packed, got, plain, control
    if bad:
        raise RuntimeError(f"{tag}: {bad}")
    return rec


def phase_bert(cfg, dev, smi_line):
    """``cfg``: bert-base, the paper's NLP network, at its published widths
    and depth (12 layers, d 768, 12 heads of 64, d_ff 3072, vocab 30522,
    float32, bidirectional, GeLU, LayerNorm, untied head; weights from seed
    0).  B6: ``EngineSpec.validate`` refuses it (an encoder has no
    autoregressive decode).  B2: ``phase_train`` at BERT_B x BERT_S (T1-T5,
    the LSQ launches worked out for its 12 layers by ``lsq_sites``).  B3:
    ``phase_select`` on the trained weights (EAGL through the histogram
    kernel takes what impl="ref" takes), then ``phase_alps`` (A1-A3) and
    ``phase_hawq`` (H1-H4) over its 48 selectable units.  B4:
    ``phase_frontier`` (F1-F4; the losses reported, not gated: the
    synthetic task's next-token labels are visible to a bidirectional
    model).  B5: ``encoder_forward`` of EAGL's take."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import EngineSpec
    log(f"  {cfg.name} d_model={cfg.d_model} layers={cfg.n_repeats} heads="
        f"{cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
        f"{cfg.param_dtype} causal={cfg.causal}")
    try:
        EngineSpec().validate(cfg)
        b6 = None
    except ValueError as e:
        b6 = str(e)
    log(f"  B6 EngineSpec.validate refuses it: {b6}")
    if b6 is None or "autoregressive" not in b6:
        raise RuntimeError("bert phase B6: EngineSpec.validate accepted a "
                           "non-causal config")
    rec = {"config": cfg.name, "device": smi_line, "b6": b6}
    t0 = time.perf_counter()
    state, rec["train"] = phase_train(cfg, dev, smi_line,
                                      batch=(BERT_B, BERT_S))
    log(f"  B2 train {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.no_grad():
        mixed, rec["select"] = phase_select(cfg, state.params, dev)
    rec["alps"] = alps = phase_alps(cfg, dev, state, smi_line)
    rec["hawq"] = hawq = phase_hawq(cfg, dev, state, alps, smi_line)
    log(f"  B3 select, alps and hawq {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["frontier"] = phase_frontier(cfg, dev, state, selection_methods(
        tf.build_policy(cfg), alps, hawq), smi_line)
    log(f"  B4 frontier {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    from repro_torch.data.synthetic import make_batch
    tokens = make_batch(21, 0, BERT_B, BERT_S, cfg.vocab,
                        device=dev)["tokens"]
    rec["forward"] = encoder_forward(cfg, dev, state.params, mixed, smi_line,
                                     {"tokens": tokens}, "bert phase B5")
    log(f"  B5 forward {time.perf_counter() - t0:.1f} s")
    return rec


# the dense zoo's depths on the card, at full width: each decoder's first
# layers (24, 30 and 52 in all), cut so that the script keeps inside its
# time limit as the zoo grows; gates Z1-Z4 hold at any depth
ZOO = {"internlm2-1.8b": 4, "deepseek-7b": 4, "granite-20b": 4}
# bert-base's depth on the card (12 in all), cut for the deepseek-v3
# method phase so that the script keeps inside its time limit
BERT_DEPTH = 4
ZOO_RUNS = (("contiguous", 8), ("contiguous", 4), ("paged", 4))
MLA_RUNS = (("contiguous", None),)   # MLA's latent: full, never paged
ZOO_NEW = 32            # new tokens of a zoo run
ZOO_CHECK_DECODE = 8    # decode steps of the zoo's teacher-forced check


def phase_zoo(cfg, dev, smi_line):
    """One decoder of the dense zoo at its published widths and depth,
    weights drawn on the card from seed 0.  Z1: EAGL through the histogram
    kernel (one launch a tensor) takes what impl="ref" takes at 0.7
    (``phase_select``); the take is packed and the raw weights freed.  Z2:
    ``phase_serve`` of phase 4's prompts, ZOO_NEW new tokens over
    contiguous int8, contiguous int4 and paged int4 caches: each path's
    kernels, the launches a decode step and a prefill that
    ``step_launches`` works out, no device-to-host copy in 8 decode steps
    (every run), paged tokens
    equal to contiguous.  Z3: ``phase_check`` over the
    prefill and ZOO_CHECK_DECODE decode steps on the int8 cache, kernel
    path against plain within CONTROL_FACTOR x the larger of the
    float64-attention and bf16-probability controls.  Z4: the peak of
    device memory (init, selection and packing, and every run) below the
    card's.  An MLA model (deepseek-v3) serves one contiguous full-cache
    run (MLA_RUNS: its latent is never quantized or paged), whose decode
    steps launch no decode attention; its prefix blocks count as layers,
    and its first block alone is its first prefix block; it also runs
    ``phase_schedule``'s contiguous full run at the served depth (gate A
    over its experts, the copies gate).  An M-RoPE model
    (qwen2-vl-7b) also
    runs Z5, ``mrope_prefill_check``'s image-and-text prefill; it and a
    mixture of experts (dbrx-132b) run ``phase_schedule``'s paged full run
    over their first SCHED_DEPTH layers (suffix prefills at shifted
    streams; each admission's expert capacity its own, each prefill's
    dropped slots counted; gates A, B and D).  Readings:
    init, select and pack
    seconds, raw weight bytes (in all, and of the token table, the head,
    the attention and the FFNs or experts over the layers), packed weight
    bytes, and phase_serve's."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import pack_params, residency
    moe = (f" experts={cfg.n_experts} top_k={cfg.top_k} capacity_factor="
           f"{cfg.capacity_factor:g} shared={cfg.n_shared_experts}"
           if cfg.n_experts else "")
    mla = (f" MLA q_lora={cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} "
           f"nope/rope/v={cfg.qk_nope_dim}/{cfg.qk_rope_dim}/"
           f"{cfg.v_head_dim} prefix={len(cfg.prefix)} x "
           f"{cfg.prefix[0].mixer}+{cfg.prefix[0].ffn} d_ff "
           f"{cfg.prefix[0].d_ff} mtp={cfg.mtp}" if cfg.prefix else "")
    log(f"  {cfg.name} d_model={cfg.d_model} layers={len(cfg.prefix)} + "
        f"{cfg.n_repeats} heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} norm={cfg.norm} "
        f"ffn={cfg.pattern[0].ffn}{moe}{mla} rope_base={cfg.rope_base:g}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    rec = {"config": cfg.name, "device": smi_line,
           "init_s": time.perf_counter() - t0,
           "raw_weight_bytes": residency.resident_bytes(raw),
           "raw_bytes_of": raw_parts(raw)}
    log("  raw bytes: " + ", ".join(f"{k} {v / 1e9:.3f} GB"
                                    for k, v in rec["raw_bytes_of"].items()))
    t0 = time.perf_counter()
    mixed, rec["select"] = phase_select(cfg, raw, dev)
    if rec["select"]["launches"]["histogram"] != rec["select"]["tensors"]:
        raise RuntimeError(f"{cfg.name} Z1: EAGL launched the histogram "
                           f"kernel {rec['select']['launches']['histogram']}"
                           f" times for {rec['select']['tensors']} tensors")
    pa = mixed.as_arrays()
    packed = pack_params(raw, pa, cfg, device=dev)
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec["select_pack_s"] = time.perf_counter() - t0
    rec["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["packed_weight_bytes"] = residency.resident_bytes(packed)
    log(f"  Z1 init {rec['init_s']:.1f} s ({rec['raw_weight_bytes'] / 1e9:.2f}"
        f" GB raw), select + pack {rec['select_pack_s']:.1f} s "
        f"({rec['packed_weight_bytes'] / 1e9:.3f} GB packed); peak "
        f"{rec['build_peak_bytes'] / 2**30:.2f} GiB")
    tokens, lengths = make_prompts(cfg, np.random.default_rng(0))
    t0 = time.perf_counter()
    mla = any(b.mixer == "mla" for b in tuple(cfg.prefix) + cfg.pattern)
    rec["serve"] = phase_serve(cfg, packed, pa, dev, tokens, lengths,
                               MLA_RUNS if mla else ZOO_RUNS, ZOO_NEW)
    log(f"  Z2 serve {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["check"] = phase_check(cfg, packed, pa, dev, tokens, lengths,
                               n_decode=ZOO_CHECK_DECODE, cache_bits=(8,))
    log(f"  Z3 check {time.perf_counter() - t0:.1f} s")
    if cfg.rope == "mrope":
        t0 = time.perf_counter()
        rec["mrope"] = mrope_prefill_check(cfg, packed, pa, dev)
        log(f"  Z5 image-and-text prefill {time.perf_counter() - t0:.1f} s")
    if mla:
        # at the served depth: the latent is contiguous, full precision
        t0 = time.perf_counter()
        rec["schedule"] = phase_schedule(cfg, packed, pa, dev, smi_line,
                                         runs=("contiguous-full",))
        log(f"  schedule contiguous-full ({len(cfg.prefix)} + "
            f"{cfg.n_repeats} layers) {time.perf_counter() - t0:.1f} s")
    elif cfg.rope == "mrope" or cfg.n_experts:
        t0 = time.perf_counter()
        rec["schedule"] = phase_schedule(
            cfg.replace(n_repeats=SCHED_DEPTH),
            dict(packed, pat=packed["pat"][:SCHED_DEPTH]), pa, dev, smi_line,
            runs=("paged-full",))
        log(f"  schedule paged-full (the first {SCHED_DEPTH} layers) "
            f"{time.perf_counter() - t0:.1f} s")
    rec["peak_bytes"] = max([rec["build_peak_bytes"]]
                            + [r["max_memory_allocated"]
                               for r in rec["serve"].values()])
    card = torch.cuda.get_device_properties(dev).total_memory
    log(f"  Z4 peak device memory {rec['peak_bytes'] / 2**30:.2f} GiB of the "
        f"card's {card / 2**30:.2f} GiB")
    del packed
    torch.cuda.empty_cache()
    if not rec["peak_bytes"] < card:
        raise RuntimeError(f"{cfg.name} Z4: peak {rec['peak_bytes']} bytes")
    return rec


# Z5: an 8 x 512 prefill whose rows open with an image of one frame on 16 x
# 16 patches (Qwen2-VL's merged grid of a 448 x 448 image), then text
MROPE_B, MROPE_S, MROPE_GRID = 8, 512, (1, 16, 16)


def image_text_streams(b: int, s: int, grid, dev) -> torch.Tensor:
    """Qwen2-VL's (3, B, S) position streams of an image followed by text:
    the image's t x h x w patches first (each stream the patch's frame,
    row and column), then text on all three streams from the grid's
    largest position plus one."""
    t, gh, gw = grid
    i = torch.arange(t * gh * gw)
    image = torch.stack([i // (gh * gw), (i // gw) % gh, i % gw])
    text = max(t, gh, gw) + torch.arange(s - t * gh * gw)
    streams = torch.cat([image, text.expand(3, -1)], dim=1)
    return streams[:, None].expand(3, b, s).contiguous().to(dev)


def mrope_prefill_check(cfg, packed, pa, dev) -> dict:
    """Z5, where M-RoPE's sections matter: MROPE_B prompts of MROPE_S
    seeded tokens whose first positions carry an image's distinct (t, h,
    w) streams (``image_text_streams``), through the packed prefill
    forward (``transformer.apply``, every position's logits): the kernel
    path against the plain path (impl="ref") within CONTROL_FACTOR x the
    control (the plain path with its attention in float64), as phase
    check's gate; the kernel path launches L flash_attention and
    ``step_launches``' quant_matmul and lsq_fakequant; and the same tokens
    on text streams (the 1-D positions three times) move the logits by
    more than 1e-3 of max|logit|, so the sections reached the rotation."""
    from repro_torch.kernels import cuda
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (MROPE_B, MROPE_S)), device=dev)
    streams = image_text_streams(MROPE_B, MROPE_S, MROPE_GRID, dev)
    text = torch.arange(MROPE_S, device=dev).expand(3, MROPE_B, MROPE_S)

    def forward(impl, pos):
        with torch.no_grad():
            return tf.apply(packed, pa, tokens, cfg, mode="prefill",
                            impl=impl, mrope_positions=pos)[0]
    sync(dev)
    cuda.reset_launches()
    kernel = forward("auto", streams)
    sync(dev)
    launches = dict(cuda.LAUNCHES)
    plain = forward("ref", streams)
    with patched(attn, "chunked_attention", attention_f64):
        control = forward("ref", streams)
    as_text = forward("auto", text)
    want = step_launches(cfg)
    rec = {"b": MROPE_B, "s": MROPE_S, "grid": list(MROPE_GRID),
           "finite": bool(torch.isfinite(kernel).all()),
           "launches": {k: v for k, v in launches.items() if v},
           "rel_logit_err": rel_err(kernel, plain),
           "control_rel_logit_err": rel_err(control, plain),
           "text_streams_rel_logit_diff": rel_err(as_text, kernel)}
    del kernel, plain, control, as_text
    bound = CONTROL_FACTOR * rec["control_rel_logit_err"]
    log(f"  Z5 image ({'x'.join(map(str, MROPE_GRID))} patches) and text, "
        f"{MROPE_B} x {MROPE_S}: max|dlogit|/max|logit| "
        f"{rec['rel_logit_err']:.4g} (bound {CONTROL_FACTOR} x control "
        f"{rec['control_rel_logit_err']:.4g} = {bound:.4g}); text streams "
        f"move the logits by {rec['text_streams_rel_logit_diff']:.4g} of "
        f"max|logit|; launches {rec['launches']}")
    bad = []
    if not rec["finite"]:
        bad.append("non-finite logits")
    if not rec["rel_logit_err"] <= bound:
        bad.append(f"kernel vs plain {rec['rel_logit_err']} over {bound}")
    if not rec["text_streams_rel_logit_diff"] > 1e-3:
        bad.append(f"text streams moved the logits by only "
                   f"{rec['text_streams_rel_logit_diff']}")
    got = (launches["quant_matmul"], launches["lsq_fakequant"],
           launches["flash_attention"])
    if got != (want["quant_matmul"], want["lsq_fakequant"],
               want["attention"]):
        bad.append(f"launches {got}, expected {want}")
    if bad:
        raise RuntimeError(f"{cfg.name} Z5: {bad}")
    return rec


def raw_parts(raw) -> dict:
    """Bytes of a raw param tree by part: the token table, the head, the
    multi-token head (``mtp``), over the layers (the prefix blocks and the
    pattern) the attention and the FFNs (``mlp``) or experts (``moe``:
    router, banks and the shared expert), and the norms (the rest)."""
    from repro_torch.serve import residency
    out = {k: residency.resident_bytes(raw[k])
           for k in ("embed", "head", "mtp") if k in raw}
    blocks = [raw[k] for k in raw if k.startswith("prefix")]
    blocks += [block for layer in raw["pat"] for block in layer.values()]
    for block in blocks:
        for part in ("attn", "mlp", "moe"):
            if part in block:
                out[part] = (out.get(part, 0)
                             + residency.resident_bytes(block[part]))
    out["norms"] = residency.resident_bytes(raw) - sum(out.values())
    return out


# dbrx-132b's first layers at full width: 4 x 6.34 GB of experts and the
# 1.23 GB token table and head keep the raw build near 28.5 GB; all 40
# layers would take about 260 GB
DBRX_DEPTH = 4

# deepseek-v3-671b's MoE layers on the card at full width, after its 3 dense
# prefix layers: one MoE layer's experts take 22.55 GB raw (256 x 3 x 7168
# x 2048 bf16), the prefix 3 x 1.17 GB, the token table and head 1.85 GB
# each and the MTP projection 0.21 GB, about 30.4 GB raw; a second MoE
# layer would raise the raw build to about 53 GB, and granite-20b's 40.6 GB
# raw already peaked at 59.28 GiB of the card's 79.18
DSV3_DEPTH = 1


# the dbrx method phase's depth: one layer at full width holds 4.49 B
# parameters (the experts 3.17 B, the table and untied head 1.23 B, the
# attention 88 M), 8.98 GB in bf16 and as much again in gradients; with
# int8 AdamW moments (9 GB) and ALPS's in-memory copy of params and
# moments (18 GB) it stays near 45 GB; float32 moments (35.9 GB) and their
# copy would take about 99 GB, over the card's 79.18 GiB
DBRX_TRAIN_DEPTH = 1
DBRX_METHODS = ("eagl", "alps", "hawq_v3")   # the frontier's, over experts
DBRX_BUDGETS = (0.75, 0.6)


@contextlib.contextmanager
def moments_on_host(state):
    """The optimizer's moments in host memory inside the block and back on
    the params' device after it, bit for bit: HAWQ-v3 reads the params
    alone, and its Hessian-vector products over deepseek-v3's table and
    head (the table read twice, the head twice with the MTP loss) ran out
    of the card's memory beside the moments of 3.60 B parameters."""
    from repro_torch import tree
    opt, leaves = state.optimizer, tree.leaves(state.params)
    dev = leaves[0].device
    for p in leaves:
        opt.state[p] = tree.map_tree(lambda t: t.to("cpu"), opt.state[p])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        yield
    finally:
        for p in leaves:
            opt.state[p] = tree.map_tree(lambda t: t.to(dev), opt.state[p])


def method_phases(cfg, dev, smi_line, ref_units=None, lr=None,
                  hawq_moments_on_host=False) -> dict:
    """The paper's method over ``cfg`` at full width, weights from seed 0:
    ``phase_train`` at ALPS_B x ALPS_S with int8 AdamW moments and ``lr``
    (T1-T5; ALPS's probes and the frontier's fine-tunes take the same
    optimizer);
    ``phase_alps`` over the selectable units (A1-A3, A3 on ``ref_units``);
    ``phase_hawq`` (H1-H4), with the moments in host memory if
    ``hawq_moments_on_host``; ``phase_frontier`` over EAGL, ALPS and
    HAWQ-v3 at DBRX_BUDGETS (F1-F4).  The peak of device memory of each,
    gated below the card's."""
    from repro_torch.models import transformer as tf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec, peaks = {"config": cfg.name, "device": smi_line}, {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, rec["train"] = phase_train(cfg, dev, smi_line,
                                      batch=(ALPS_B, ALPS_S),
                                      state_dtype="int8", lr=lr)
    peaks["train"] = torch.cuda.max_memory_allocated()
    log(f"  train {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rec["alps"] = phase_alps(cfg, dev, state, smi_line, ref_units)
    peaks["alps"] = torch.cuda.max_memory_allocated()
    log(f"  alps {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with (moments_on_host(state) if hawq_moments_on_host
          else contextlib.nullcontext()):
        rec["hawq"] = phase_hawq(cfg, dev, state, rec["alps"], smi_line)
    peaks["hawq"] = torch.cuda.max_memory_allocated()
    log(f"  hawq {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    methods = selection_methods(tf.build_policy(cfg), rec["alps"],
                                rec["hawq"])
    rec["frontier"] = phase_frontier(
        cfg, dev, state, {k: methods[k] for k in DBRX_METHODS}, smi_line,
        DBRX_BUDGETS)
    peaks["frontier"] = torch.cuda.max_memory_allocated()
    log(f"  frontier {time.perf_counter() - t0:.1f} s")
    del state
    torch.cuda.empty_cache()
    card = torch.cuda.get_device_properties(dev).total_memory
    rec["peak_bytes"] = peaks
    log(f"  peak device memory by phase (GiB): "
        f"{ {k: round(v / 2**30, 2) for k, v in peaks.items()} } of the "
        f"card's {card / 2**30:.2f}")
    if not max(peaks.values()) < card:
        raise RuntimeError(f"{cfg.name} method: peak {peaks} bytes")
    return rec


def phase_dbrx_method(cfg, dev, smi_line):
    """The paper's method over dbrx-132b's experts at its published widths
    (``cfg``: its first DBRX_TRAIN_DEPTH layers), each expert's gate/up
    and down their own 4/2-bit units, through ``method_phases``: T4's
    launches from ``lsq_sites`` (3 + 2E activation and 5 + 3E weight
    sites a layer, every expert through lsq_fakequant and its backward);
    A3's units (the first ALPS_REF_UNITS) two of them experts; the experts
    of each bank read different HAWQ-v3 gains."""
    from repro_torch.models import transformer as tf
    log(f"  {cfg.name} d_model={cfg.d_model} layers={cfg.n_repeats} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} experts="
        f"{cfg.n_experts} top_k={cfg.top_k} vocab={cfg.vocab}; "
        f"{ALPS_B} x {ALPS_S} tokens, int8 AdamW moments")
    units = tf.build_policy(cfg).selectable_units()
    ref_experts = [u.name for u in units[:ALPS_REF_UNITS]
                   if u.sub is not None]
    if len(ref_experts) != 2:
        raise RuntimeError(f"dbrx method: A3's units {units[:4]} hold "
                           f"{len(ref_experts)} experts, not 2")
    rec = method_phases(cfg, dev, smi_line)
    rec.update(units=len(units), experts=sum(u.sub is not None
                                             for u in units),
               a3_experts=ref_experts)
    log(f"  {len(units)} selectable units ({rec['experts']} experts)")
    return rec


# deepseek-v3-671b's method phase at full width on its 3 dense prefix
# layers alone (MLA + SwiGLU), with the 129280-row table, the untied head
# and the MTP head: 3.60 B parameters in 20 units, 18 selectable.  One MoE
# layer holds 256 x 3 x 7168 x 2048 = 11.3 B expert parameters, 22.6 GB in
# bf16 and as much again in gradients: it does not fit beside the moments
# and ALPS's copy; the per-expert method runs on the card through dbrx
DSV3_TRAIN_DEPTH = 0
# A3's (and H3's) units: MLA's grouped input projection and its wk_b/wv_b
# unit (read as weights only), and a prefix SwiGLU's gate/up and down
DSV3_REF_SLOTS = ("attn_q_a", "attn_kv_b", "mlp_gateup", "mlp_down")
# AdamW's rate for deepseek-v3 at d_model 7168: at LR (olmo-1b's 4e-4) its
# loss rose over the 16 steps on the H100 (PERF.md §6), as olmo-1b's did at
# 1e-3 and 2e-3; Adam's first steps move each weight by about lr, so an
# output of d_model inputs by about lr x d_model, and 1e-4 x 7168 is about
# olmo's 4e-4 x 2048, which lowered its loss (DeepSeek-V3's published peak
# of 2.2e-4 comes after 2000 warmup steps)
DSV3_LR = 1e-4


def phase_dsv3_method(cfg, dev, smi_line):
    """The paper's method over deepseek-v3-671b at its published widths
    (``cfg``: its prefix blocks and its first DSV3_TRAIN_DEPTH MoE
    layers), with the MTP loss in every step, at DSV3_LR, through
    ``method_phases``:
    T4's launches from ``lsq_sites`` (MLA's 3 activation and 6 weight
    sites, a SwiGLU's 2 and 3, the MTP head's 3 and 3 more at the edges);
    T2 counts wk_b's and wv_b's activation steps as unread (zero gradient);
    A3's and H3's units: one of each DSV3_REF_SLOTS that is selectable,
    the i-th slot's from the i-th block round the blocks (MLA's and a
    prefix SwiGLU's)."""
    from repro_torch.models import transformer as tf
    log(f"  {cfg.name} d_model={cfg.d_model} layers={len(cfg.prefix)} + "
        f"{cfg.n_repeats} heads={cfg.n_heads} MLA q_lora={cfg.q_lora_rank} "
        f"kv_lora={cfg.kv_lora_rank} prefix d_ff={cfg.prefix[0].d_ff} "
        f"vocab={cfg.vocab} mtp={cfg.mtp}; {ALPS_B} x {ALPS_S} tokens, int8 "
        f"AdamW moments")
    units = tf.build_policy(cfg).selectable_units()
    ref_units = []
    for i, slot in enumerate(DSV3_REF_SLOTS):
        of_slot = [u.name for u in units if u.slot == slot]
        if of_slot:            # the i-th block's, round the blocks
            ref_units.append(of_slot[i % len(of_slot)])
    rec = method_phases(cfg, dev, smi_line, ref_units, DSV3_LR,
                        hawq_moments_on_host=True)
    unread = rec["train"]["grads"]["unread"]
    # two a MLA block (wk_b's and wv_b's) and one a MoE block (the up bank's)
    want = sum(2 * (b.mixer == "mla") + (b.ffn == "moe") for b in
               cfg.prefix + tuple(cfg.pattern) * cfg.n_repeats)
    rec.update(units=len(units), a3_units=ref_units)
    log(f"  {len(units)} selectable units; A3's {ref_units}; T2 unread "
        f"leaves {unread} (MLA's wk_b and wv_b activation steps, and any "
        f"up bank's)")
    if unread != want:
        raise RuntimeError(f"deepseek-v3 method: T2 counted {unread} unread "
                           f"leaves, {want} expected")
    return rec


HUBERT_B, HUBERT_S = 8, 1000   # 8 clips of 20 s at HuBERT's 20 ms frames


def phase_hubert(cfg, dev, smi_line):
    """hubert-xlarge at its published widths and depth (48 layers, d 1280,
    16 heads of 80, d_ff 5120, 504 cluster targets; bidirectional, no RoPE,
    bf16, frame embeddings in place of a token table), weights drawn on
    the card from seed 0.  ``EngineSpec.validate`` refuses it (no
    autoregressive decode); EAGL through the histogram kernel takes what
    impl="ref" takes at 0.7; ``encoder_forward`` of HUBERT_B x HUBERT_S
    frame embeddings (normal, from seed 0; 1000 rows leave a ragged last
    tile in flash_attention at D = 80, not causal)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import EngineSpec
    log(f"  {cfg.name} d_model={cfg.d_model} layers={cfg.n_repeats} heads="
        f"{cfg.n_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab} rope={cfg.rope} causal={cfg.causal} "
        f"embed_input={cfg.embed_input}")
    try:
        EngineSpec().validate(cfg)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or "autoregressive" not in refused:
        raise RuntimeError("hubert phase: EngineSpec.validate accepted a "
                           "non-causal config")
    raw = tf.init_params(cfg, seed=0, device=dev)
    if "embed" in raw:
        raise RuntimeError("hubert phase: an embed_input model made a token "
                           "table")
    rec = {"config": cfg.name, "device": smi_line, "refused": refused}
    mixed, rec["select"] = phase_select(cfg, raw, dev)
    if rec["select"]["launches"]["histogram"] != rec["select"]["tensors"]:
        raise RuntimeError("hubert phase: EAGL's histogram launches")
    g = torch.Generator(dev).manual_seed(0)
    embeds = torch.randn((HUBERT_B, HUBERT_S, cfg.d_model), generator=g,
                         device=dev).to(cfg.compute_dtype)
    rec["forward"] = encoder_forward(cfg, dev, raw, mixed, smi_line,
                                     {"embeds": embeds}, "hubert phase")
    del raw, embeds
    torch.cuda.empty_cache()
    return rec


def main():
    t_start = time.perf_counter()
    smi_line = phase_device()
    from repro_torch.configs import get_config, olmo_1b
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
                                                                 gen),
              "flash_attention_f32": check_flash_f32(timer, dev, gen),
              "quant_matmul_f32": check_quant_matmul_f32(timer, dev, gen)}
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
    t0 = time.perf_counter()
    runs = phase_serve(cfg, packed, pa, dev, tokens, lengths)
    log(f"  serve phase {time.perf_counter() - t0:.1f} s")
    log(f"schedule (continuous batching, prefix sharing; the first "
        f"{SCHED_DEPTH} of {cfg.n_repeats} layers):")
    t0 = time.perf_counter()
    schedule = phase_schedule(cfg.replace(n_repeats=SCHED_DEPTH),
                              dict(packed, pat=packed["pat"][:SCHED_DEPTH]),
                              pa, dev, smi_line)
    log(f"  schedule phase {time.perf_counter() - t0:.1f} s")
    log("check (kernel path vs plain path):")
    t0 = time.perf_counter()
    check = phase_check(cfg, packed, pa, dev, tokens, lengths)
    log(f"  check phase {time.perf_counter() - t0:.1f} s")
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
    log("joint (serve the joint weight-and-cache take):")
    t0 = time.perf_counter()
    joint = phase_joint(cfg, dev, state.params, front["joint"]["take"],
                        smi_line)
    log(f"  joint phase {time.perf_counter() - t0:.1f} s")
    del state
    torch.cuda.empty_cache()
    log(f"bert (bert-base, the first {BERT_DEPTH} of 12 layers: QAT, "
        f"selection, frontier, packed forward):")
    t0 = time.perf_counter()
    bert = phase_bert(get_config("bert-base").replace(
        n_repeats=BERT_DEPTH), dev, smi_line)
    log(f"  bert phase {time.perf_counter() - t0:.1f} s")
    zoo = {}
    for name, depth in ZOO.items():
        log(f"zoo ({name}, the first {depth} layers: select, pack, serve, "
            f"check):")
        t0 = time.perf_counter()
        zoo[name] = phase_zoo(get_config(name).replace(n_repeats=depth), dev,
                              smi_line)
        zoo[name]["phase_s"] = time.perf_counter() - t0
        log(f"  zoo {name} phase {zoo[name]['phase_s']:.1f} s")
    log("hubert (hubert-xlarge: select, packed forward of frames):")
    t0 = time.perf_counter()
    hubert = phase_hubert(get_config("hubert-xlarge"), dev, smi_line)
    log(f"  hubert phase {time.perf_counter() - t0:.1f} s")
    log(f"dbrx (dbrx-132b's mixture of experts, the first {DBRX_DEPTH} of "
        f"40 layers: select, pack, serve, check):")
    t0 = time.perf_counter()
    dbrx = phase_zoo(get_config("dbrx-132b").replace(n_repeats=DBRX_DEPTH),
                     dev, smi_line)
    dbrx["phase_s"] = time.perf_counter() - t0
    log(f"  dbrx phase {dbrx['phase_s']:.1f} s")
    log(f"dbrx method (dbrx-132b's experts, the first {DBRX_TRAIN_DEPTH} of "
        f"40 layers: QAT, ALPS, HAWQ-v3, the frontier):")
    t0 = time.perf_counter()
    dbrx_method = phase_dbrx_method(get_config("dbrx-132b").replace(
        n_repeats=DBRX_TRAIN_DEPTH), dev, smi_line)
    dbrx_method["phase_s"] = time.perf_counter() - t0
    log(f"  dbrx method phase {dbrx_method['phase_s']:.1f} s")
    log("qwen (qwen2-vl-7b, M-RoPE: select, pack, serve, check, an image-"
        "and-text prefill, the scheduler):")
    t0 = time.perf_counter()
    qwen = phase_zoo(get_config("qwen2-vl-7b"), dev, smi_line)
    qwen["phase_s"] = time.perf_counter() - t0
    log(f"  qwen phase {qwen['phase_s']:.1f} s")
    log(f"deepseek-v3 (deepseek-v3-671b: MLA, the 3 dense prefix layers and "
        f"the first {DSV3_DEPTH} of 58 MoE layers with the shared expert: "
        f"select, pack, serve, check, the scheduler):")
    t0 = time.perf_counter()
    dsv3 = phase_zoo(get_config("deepseek-v3-671b").replace(
        n_repeats=DSV3_DEPTH), dev, smi_line)
    dsv3["phase_s"] = time.perf_counter() - t0
    log(f"  deepseek-v3 phase {dsv3['phase_s']:.1f} s")
    log(f"deepseek-v3 method (deepseek-v3-671b: MLA, the 3 dense prefix "
        f"layers and the first {DSV3_TRAIN_DEPTH} MoE layers, the MTP loss: "
        f"QAT, ALPS, HAWQ-v3, the frontier):")
    t0 = time.perf_counter()
    dsv3_method = phase_dsv3_method(get_config("deepseek-v3-671b").replace(
        n_repeats=DSV3_TRAIN_DEPTH), dev, smi_line)
    dsv3_method["phase_s"] = time.perf_counter() - t0
    log(f"  deepseek-v3 method phase {dsv3_method['phase_s']:.1f} s")

    # each kernel's launches on the path that runs it
    launches = dict(runs["contiguous-int8"]["launches"])
    launches["paged_kv_decode_attention"] = \
        runs["paged-int8"]["launches"]["paged_kv_decode_attention"]
    launches["histogram"] = select["launches"]["histogram"]
    launches["lsq_fakequant_bwd"] = train["launches"]["lsq_fakequant_bwd"]
    launches["flash_attention_f32"] = \
        bert["forward"]["launches"]["flash_attention_f32"]
    launches["quant_matmul_f32"] = bert["forward"]["launches"]["quant_matmul"]
    kernels = []
    for name, (head, _) in checks.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/"
                      f"{cuda.source_of(KERNEL_OF.get(name, name))}.cu",
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
                   "frontier": front, "joint": joint, "bert": bert,
                   "zoo": zoo, "hubert": hubert, "dbrx": dbrx,
                   "dbrx_method": dbrx_method, "qwen": qwen,
                   "deepseek_v3": dsv3, "deepseek_v3_method": dsv3_method,
                   "total_s": time.perf_counter() - t_start,
                   "launch_counts_after": dict(cuda.LAUNCHES)}, f, indent=1)
    log(f"chip_smoke: {time.perf_counter() - t_start:.0f} s in all")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
