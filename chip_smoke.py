#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi); no card fails.
  2. build   - nvcc builds the kernels from src/repro_torch/csrc into
               build/kernels/ (parallel, one process per source).
  3. kernels - each of the six kernels against its plain PyTorch version at
               the main path's shapes, with its tolerance, kernel / plain /
               library times (CUDA events, warm-up excluded, L2 flushed) and
               bound; the decode GEMV's shapes also in device time alone
               (torch.profiler) beside cuBLAS's, both decode attentions
               beside SDPA's, lsq_fakequant (one step and q/k/v's three)
               beside fake_quantize_per_tensor_affine and the histogram
               beside torch.bincount; the paged decode also bit for bit
               against the contiguous kernel on the gathered cache, and the
               probes of quant_matmul (identity, and the GEMV's selector and
               repeat), decode attention (selector in both layouts, and
               repeat), flash_attention (selector), lsq_fakequant (NaN,
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
    then the selector probe, bit for bit, at S = 128, 129, 300 and 513 with
    MHA and GQA 16/4, causal and with keys spread over every kv tile."""
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
    return cases[0], cases


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
    log("check (kernel path vs plain path):")
    check = phase_check(cfg, packed, pa, dev, tokens, lengths)

    # each kernel's launches on the path that runs it
    launches = dict(runs["contiguous-int8"]["launches"])
    launches["paged_kv_decode_attention"] = \
        runs["paged-int8"]["launches"]["paged_kv_decode_attention"]
    launches["histogram"] = select["launches"]["histogram"]
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
                   "select": select, "serve": runs, "check": check,
                   "launch_counts_after": dict(cuda.LAUNCHES)}, f, indent=1)
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
