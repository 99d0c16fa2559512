"""ctypes wrappers of the CUDA kernels, with their launch counters.

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything its kernel does not take, and on an operand that
requires grad while grad mode is on (a launch records no gradient);
allocates the output with ``torch.empty``; launches on
``torch.cuda.current_stream()``; raises if the C launcher reports a CUDA
error; and adds one to its counter in
``LAUNCHES``.  Nothing else touches the counters, so a caller that zeroes
them (``reset_launches``) before a run reads afterwards how often the run
went through each kernel.  The libraries build on first use
(``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.autograd import forward_ad

from repro_torch.core.quant import lsq_step_grad_scale
from repro_torch.kernels import build

LAUNCHES: Dict[str, int] = {"quant_matmul": 0, "kv_decode_attention": 0,
                            "flash_attention": 0, "lsq_fakequant": 0,
                            "histogram": 0, "paged_kv_decode_attention": 0,
                            "lsq_fakequant_bwd": 0}
HIST_MAX_BINS = 4096            # the kernel's shared-memory counters
LSQ_MAX_STEPS = 3               # steps (outputs) of one lsq_fakequant launch
LSQ_BWD_THREADS = 256           # the backward's block
LSQ_BWD_MAX_BLOCKS = 4 * 132    # four blocks on each of an H100's 132 SMs
GEMV_MAX_M = 16                 # quant_matmul rows of the GEMV; above, tiles
GEMV_CHANNELS = 128             # output channels a GEMV block: 8 x 16 bytes
GEMV_STEP_ROWS = 8              # packed rows a GEMV K step
GEMV_SLICE_MAX_K = 1024         # K a block stages: x fits its shared memory
GEMV_MIN_STEPS = 4              # K steps a slice at least
GEMV_TARGET_BLOCKS = 132        # one block on each of an H100's 132 SMs
QMM_ROUTES = ("gemv", "mma.sync", "wgmma")   # the C launcher's route codes
DECODE_UNIT_ROWS = 16           # a decode chunk is whole units (and pages)
DECODE_CHUNK_ROWS = 128         # rows a decode block at most, group <= 4
DECODE_MIN_BLOCKS = 2 * 132     # two waves over an H100's 132 SMs
DECODE_MAX_SPLITS = 256         # the kernel's merge holds this many
DECODE_WARPS = 4                # query rows a decode block holds at once

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_LL12 = _LL * 12                # flash_attention's 12 strides
_FLASH_STRIDES: Dict[tuple, ctypes.Array] = {}   # strides -> their array
_SIGNATURES = {
    "quant_matmul": ("quant_matmul_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _I, _I, _P]),
    "kv_decode_attention": ("kv_decode_attention_launch",
                            [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         ctypes.POINTER(_LL), _I, _F, _P]),
    "lsq_fakequant": ("lsq_fakequant_launch",
                      [_P, _P, _P, _P, _LL, _P, _P, _P, _F, _F, _F, _I, _I,
                       _I, _P]),
    "lsq_fakequant_bwd": ("lsq_fakequant_bwd_launch",
                          [_P, _P, _P, _P, _P, _LL, _P, _P, _P, _F, _F, _F,
                           _I, _I, _I, _F, _P, _I, _P, _P, _P]),
    "histogram": ("histogram_launch", [_P, _LL, _I, _P, _P, _P]),
    "paged_kv_decode_attention": ("paged_kv_decode_attention_launch",
                                  [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _P]),
}
_SHARED_SOURCE = {"histogram": "entropy_hist",
                  "paged_kv_decode_attention": "kv_decode_attention",
                  "lsq_fakequant_bwd": "lsq_fakequant"}


def source_of(name: str) -> str:
    """The ``csrc/*.cu`` source (and ``build.SOURCES`` library) that holds
    a kernel's launcher."""
    return _SHARED_SOURCE.get(name, name)


_FNS: Dict[str, object] = {}
# the split kernels' counters (the GEMV's split K, decode attention's split
# rows, the histogram's counts), one buffer for each (device, stream): zero
# when made, and every launch leaves them zero again
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    if name not in _FNS:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(source_of(name)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _launch(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
    LAUNCHES[name] += 1


def _stream() -> int:
    # the raw handle, without building a torch.cuda.Stream object per launch
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _transformed(tensors) -> bool:
    """A ``torch.func`` (functorch) wrapper or a forward-mode dual tensor
    among ``tensors``: its tangent or its transform would not see the
    launch.  Neither exists outside a transform or a dual level, so each
    tensor is looked at only inside one (a launch pays two flag reads)."""
    if torch._C._are_functorch_transforms_active() and any(
            torch._C._functorch.is_functorch_wrapped_tensor(t)
            for t in tensors):
        return True
    return forward_ad._current_level >= 0 and any(
        forward_ad.unpack_dual(t).tangent is not None for t in tensors)


def _refuse_grad(name: str, tensors) -> None:
    """A kernel launch writes into a tensor it allocated and records no
    gradient: with grad mode on, an operand that requires grad would lose
    its gradient without an error, and a functorch-wrapped or dual operand
    its tangent, so the call raises instead.  The LSQ kernels are
    differentiated through ``core.quant.LsqFakeQuant``."""
    if _transformed(tensors):
        raise RuntimeError(
            f"{name}: the kernel has no forward-mode rule and is not a "
            f"torch.func transform's operation, and an operand is a "
            f"functorch-wrapped or dual tensor (HAWQ's products take "
            f"quant.fake_quant(..., hvp=True))")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no gradient, and an operand requires "
            f"grad with grad mode on (train mode runs chunked_attention and "
            f"the dict layout; fake-quant goes through quant.fake_quant)")


def _on_card(name: str, *tensors: torch.Tensor) -> torch.device:
    _refuse_grad(name, tensors)
    return _same_card(name, tensors)


def _same_card(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: every operand must lie on one CUDA device, "
                         f"got {[str(x.device) for x in tensors]}")
    return dev


def lsq_fakequant(x: torch.Tensor, step, bits):
    """Fake-quantize a contiguous float32/bf16 tensor at one integer
    bit-width.  ``step`` is one step, or a list or tuple of 1 to
    LSQ_MAX_STEPS steps for the projections that share ``x``; each is a
    0-d float32 tensor on x's device or a Python float.  One launch reads
    x once and writes one output per step: a tensor for one step, a list
    for a sequence.  x must be 16-byte aligned (the kernel moves 16-byte
    vectors; there is no scalar kernel)."""
    name = "lsq_fakequant"
    _on_card(name, x)
    many = isinstance(step, (list, tuple))
    steps = list(step) if many else [step]
    _require(x.dtype in _DTYPE_CODE, f"{name}: x must be float32 or "
             f"bfloat16, got {x.dtype}")
    _require(x.is_contiguous(), f"{name}: x must be contiguous")
    b = _lsq_bits(name, bits)
    ptrs, vals = _lsq_steps(name, x, steps)
    outs = [torch.empty_like(x) for _ in steps]
    _require(all(t.data_ptr() % 16 == 0 for t in [x] + outs),
             f"{name}: x and the outputs must be 16-byte aligned")
    optrs = [t.data_ptr() for t in outs] + [None] * (LSQ_MAX_STEPS
                                                      - len(outs))
    _launch(name, x.data_ptr(), *optrs, x.numel(), *ptrs, *vals, len(steps),
            b, _DTYPE_CODE[x.dtype], _stream())
    return outs if many else outs[0]


def _lsq_steps(name, x, steps):
    """(pointers, values) of 1 to LSQ_MAX_STEPS steps padded to
    LSQ_MAX_STEPS: a tensor step (one float32 value on x's card) by
    pointer, a float by value."""
    _require(1 <= len(steps) <= LSQ_MAX_STEPS, f"{name}: 1 to "
             f"{LSQ_MAX_STEPS} steps, got {len(steps)}")
    ptrs, vals = [None] * LSQ_MAX_STEPS, [0.0] * LSQ_MAX_STEPS
    for k, s in enumerate(steps):
        if isinstance(s, torch.Tensor):
            _on_card(name, x, s)
            _require(s.dtype == torch.float32 and s.numel() == 1,
                     f"{name}: a tensor step must be one float32 value")
            ptrs[k] = s.data_ptr()
        else:
            vals[k] = float(s)
    return ptrs, vals


def _lsq_bits(name, bits) -> int:
    b = int(round(float(bits)))
    _require(b == float(bits) and 1 <= b <= 16,
             f"{name}: bits must be an integer in [1, 16], got {bits}")
    return b


def lsq_bwd_blocks(n: int, dtype) -> int:
    """The backward's grid: one 16-byte vector a thread, at most
    LSQ_BWD_MAX_BLOCKS blocks (each thread then walks several vectors).  A
    function of n and the dtype alone, so a sum's order is the same for
    equal shapes."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return max(1, min(-(-(n // vec) // LSQ_BWD_THREADS), LSQ_BWD_MAX_BLOCKS))


def lsq_fakequant_bwd(x: torch.Tensor, grads, steps, bits):
    """The backward of ``lsq_fakequant(x, steps, bits)`` for one cotangent
    a step, in one launch: (gx in x's dtype, [gs_k]) as
    ``ref.lsq_fakequant_bwd`` defines them, each gs_k a 0-d float32 view of
    one output.  x and the grads: contiguous, 16-byte aligned, of one
    shape and dtype; steps as ``lsq_fakequant`` takes them (scalar).  The
    blocks' partial sums go to a float64 workspace made here, and the last
    block, found by the stream's counter, adds them in block order."""
    name = "lsq_fakequant_bwd"
    grads, steps = list(grads), list(steps)
    _on_card(name, x, *grads)
    _require(len(grads) == len(steps), f"{name}: one cotangent a step, got "
             f"{len(grads)} for {len(steps)}")
    _require(x.dtype in _DTYPE_CODE, f"{name}: x must be float32 or "
             f"bfloat16, got {x.dtype}")
    _require(all(g.dtype == x.dtype and g.shape == x.shape for g in grads),
             f"{name}: every cotangent must have x's shape and dtype")
    ts = [x] + grads
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts),
             f"{name}: x and the cotangents must be contiguous and 16-byte "
             f"aligned")
    b = _lsq_bits(name, bits)
    ptrs, vals = _lsq_steps(name, x, steps)
    n = x.numel()
    gscale = lsq_step_grad_scale(n, b)
    blocks = lsq_bwd_blocks(n, x.dtype)
    stream = _stream()
    counter = _split_counters(x.device, stream, 1)
    partials = torch.empty((len(steps) * blocks,), dtype=torch.float64,
                           device=x.device)
    gx = torch.empty_like(x)
    gs = torch.empty((len(steps),), dtype=torch.float32, device=x.device)
    gptrs = [g.data_ptr() for g in grads] + [None] * (LSQ_MAX_STEPS
                                                      - len(grads))
    _launch(name, x.data_ptr(), *gptrs, gx.data_ptr(), n, *ptrs, *vals,
            len(steps), b, _DTYPE_CODE[x.dtype], gscale, partials.data_ptr(),
            blocks, counter.data_ptr(), gs.data_ptr(), stream)
    return gx, [gs[k] for k in range(len(steps))]


def quant_matmul(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """x (M, K) @ K-major packed codes (K/pack, N) * scale (N,) -> (M, N)
    in x's dtype.  K must be the packed K (a multiple of 8 // bits).
    ``quant_matmul_route`` picks the kernel: the GEMV on x as it is, or a
    tensor-core kernel on bf16(x).  The GEMV splits K by ``gemv_plan``;
    with more than one slice it takes an fp32 workspace for the slices'
    partial sums, made here, and the stream's counters."""
    _on_card("quant_matmul", x, wp, scale)
    _require(bits in (2, 4), f"quant_matmul: bits must be 2 or 4, got {bits}")
    _require(x.dtype in _DTYPE_CODE, f"quant_matmul: x must be float32 or "
             f"bfloat16, got {x.dtype}")
    _require(wp.dtype == torch.uint8 and scale.dtype == torch.float32,
             "quant_matmul: wp must be uint8 and scale float32")
    _require(x.ndim == 2 and wp.ndim == 2 and scale.ndim == 1,
             f"quant_matmul: need x (M, K), wp (K/pack, N), scale (N,), got "
             f"{tuple(x.shape)}, {tuple(wp.shape)}, {tuple(scale.shape)}")
    m, k = x.shape
    kp, n = wp.shape
    _require(kp * (8 // bits) == k and scale.shape[0] == n,
             f"quant_matmul: x {tuple(x.shape)} does not match wp "
             f"{tuple(wp.shape)} at {bits} bits / scale {tuple(scale.shape)}")
    _require(x.is_contiguous() and wp.is_contiguous()
             and scale.is_contiguous(), "quant_matmul: operands must be "
             "contiguous")
    _require(wp.data_ptr() % 4 == 0, "quant_matmul: wp must be 4-byte "
             "aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    route = quant_matmul_route(m, n, k)
    ws = counters = None
    slices = per_slice = 0
    stream = _stream()
    if route == "gemv":
        slices, per_slice = gemv_plan(m, n, k, bits)
        if slices > 1:
            # the slices' fp32 partial sums; held until the launch
            counters = _split_counters(x.device, stream,
                                       -(-n // GEMV_CHANNELS))
            ws = torch.empty((slices, m, n), dtype=torch.float32,
                             device=x.device)
    else:
        # the tensor-core kernels read bf16 x (a float32 x rounds to
        # nearest even here, once) and write x's dtype; their copies need
        # 16-byte aligned bases, which a fresh copy has
        x = x.to(torch.bfloat16)
        if x.data_ptr() % 16:
            x = x.clone()
        if route == "wgmma" and wp.data_ptr() % 16:
            wp = wp.clone()
    _launch("quant_matmul", x.data_ptr(), wp.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, n, k, bits, _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out.dtype], QMM_ROUTES.index(route),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), slices,
            per_slice, stream)
    return out


def _split_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters for a split kernel's launch on
    ``stream`` (the GEMV, both decode attentions and the histogram share
    them).  Launches on one stream run in order, and each leaves its
    counters at zero, so the buffer is made (with ``torch.zeros``) once."""
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(
            (max(n, 1024),), dtype=torch.int32, device=dev)
    return buf


def quant_matmul_route(m: int, n: int, k: int) -> str:
    """The kernel of a quant_matmul launch, by shape alone: "gemv" for
    M <= GEMV_MAX_M; above it "wgmma" where TMA's 16-byte row strides hold
    (K % 8 == 0 for bf16 x, N % 16 == 0 for the codes), else "mma.sync"."""
    if m <= GEMV_MAX_M:
        return "gemv"
    return "wgmma" if k > 0 and k % 8 == 0 and n % 16 == 0 else "mma.sync"


def gemv_plan(m: int, n: int, k: int, bits: int) -> Tuple[int, int]:
    """The GEMV's split of K: (slices, K steps a slice).

    A K step is GEMV_STEP_ROWS packed rows (16 K at int4, 32 at int2), and
    a block computes GEMV_CHANNELS channels over one slice.  K is cut into
    equal slices of whole steps, the last one shorter, as many as the
    ceil(N / 128) column tiles leave room for in one wave of
    GEMV_TARGET_BLOCKS blocks, with at least GEMV_MIN_STEPS steps and at
    most GEMV_SLICE_MAX_K of K a slice.  The plan does not depend on M
    (<= GEMV_MAX_M)."""
    if not 0 < m <= GEMV_MAX_M:
        raise ValueError(f"gemv_plan: M must be in [1, {GEMV_MAX_M}], got {m}")
    kc = GEMV_STEP_ROWS * (8 // bits)
    steps = max(-(-k // kc), 1)
    tiles = -(-n // GEMV_CHANNELS)
    want = max(GEMV_TARGET_BLOCKS // tiles, 1)
    per = max(-(-steps // want), GEMV_MIN_STEPS)
    per = min(per, GEMV_SLICE_MAX_K // kc, steps)
    return -(-steps // per), per


def histogram(codes: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts of int32 codes in [0, n_bins) -> (n_bins,) float32; codes
    outside the range fall in no bin.  codes: contiguous, 16-byte
    aligned, any length.  One launch: the counts go to the stream's
    counters (``_split_counters``; n_bins counts and a block counter),
    which the kernel's last block converts and leaves at zero."""
    _on_card("histogram", codes)
    _require(codes.dtype == torch.int32 and codes.ndim == 1,
             f"histogram: codes must be (n,) int32, got "
             f"{tuple(codes.shape)} {codes.dtype}")
    _require(1 <= n_bins <= HIST_MAX_BINS, f"histogram: n_bins must be in "
             f"[1, {HIST_MAX_BINS}], got {n_bins}")
    _require(codes.is_contiguous() and codes.data_ptr() % 16 == 0,
             "histogram: codes must be contiguous and 16-byte aligned")
    stream = _stream()
    counters = _split_counters(codes.device, stream, n_bins + 1)
    out = torch.empty((n_bins,), dtype=torch.float32, device=codes.device)
    _launch("histogram", codes.data_ptr(), codes.numel(), n_bins,
            counters.data_ptr(), out.data_ptr(), stream)
    return out


def decode_plan(b: int, hkv: int, group: int, rows: int,
                bits: int) -> Tuple[int, int]:
    """Decode attention's split of a slot's rows: (splits, C).  Block
    (kv head, slot, split) takes rows [split C, split C + C).

    ``rows`` is the cache's row count, S for the contiguous cache and
    n * page for the paged one, so equal lengths plan alike; the plan reads
    shapes alone, never the positions (a decode step makes no device-to-
    host copy).  C is whole DECODE_UNIT_ROWS units (a paged chunk is whole
    pages of 16), as small as two waves of blocks (DECODE_MIN_BLOCKS) over
    the B * Hkv heads allow, at most DECODE_CHUNK_ROWS (divided by the
    rounds a group of more than DECODE_WARPS query rows takes over a
    chunk), and at least rows / DECODE_MAX_SPLITS.  At the serve shapes
    (B = 8, Hkv = 16, max_seq 1024) that is 8 splits of 128 rows: 1,024
    blocks, of which the prompts' 128-576 live rows fill about 400.  Larger
    chunks mean fewer partial sums for the last block to merge and fewer
    blocks' fixed costs (a position, a counter, a merge); on the H100 64 and
    256 rows read slower than 128 at the serve shapes (PERF.md).  Bits do
    not change the plan."""
    if min(b, hkv, group, rows) < 1 or bits not in (4, 8):
        raise ValueError(f"decode_plan: need B, Hkv, group, rows >= 1 and "
                         f"bits 4 or 8, got {(b, hkv, group, rows, bits)}")
    unit = DECODE_UNIT_ROWS
    rounds = -(-group // DECODE_WARPS)
    cap = max(DECODE_CHUNK_ROWS // rounds, unit)
    c = min(-(-rows * b * hkv // DECODE_MIN_BLOCKS), cap)
    c = max(c, -(-rows // DECODE_MAX_SPLITS))
    c = unit * -(-c // unit)
    return -(-rows // c), c


def _check_decode_operands(name, q, kq, vq, k_scale, bits):
    """The operands both decode kernels share; returns (b, h, d, hkv)."""
    _require(bits in (4, 8), f"{name}: bits must be 4 or 8, got {bits}")
    _require(q.dtype in _DTYPE_CODE, f"{name}: q must be float32 or "
             f"bfloat16, got {q.dtype}")
    _require(q.ndim == 3 and kq.ndim == 4, f"{name}: need q (B, H, D) and "
             f"4-d code buffers, got {tuple(q.shape)}, {tuple(kq.shape)}")
    b, h, d = q.shape
    _require(d in (64, 128), f"{name}: head_dim must be 64 or 128, got {d}")
    code = torch.int8 if bits == 8 else torch.uint8
    _require(kq.dtype == code and vq.dtype == code,
             f"{name}: {bits}-bit codes must be {code}")
    hkv = kq.shape[2]
    _require(kq.shape[3] == (d if bits == 8 else d // 2)
             and vq.shape == kq.shape,
             f"{name}: bad code shapes {tuple(kq.shape)}, {tuple(vq.shape)} "
             f"for q {tuple(q.shape)}")
    _require(hkv > 0 and h % hkv == 0, f"{name}: H={h} is not a multiple "
             f"of Hkv={hkv}")
    _require(tuple(k_scale.shape) == (b, hkv, d)
             and k_scale.dtype == torch.float32,
             f"{name}: k_scale must be (B, Hkv, D) float32")
    _require(kq.data_ptr() % 16 == 0 and vq.data_ptr() % 16 == 0,
             f"{name}: code buffers must be 16-byte aligned (the kernel "
             f"copies their rows 16 bytes at a time)")
    return b, h, d, hkv


def _decode_scratch(dev, stream, b, h, d, hkv, splits):
    """The split merge's fp32 workspace (made for each call) and the
    stream's counters; none for a plan of one split."""
    if splits == 1:
        return None, None
    ws = torch.empty((b * h * splits * (d + 4),), dtype=torch.float32,
                     device=dev)
    return ws, _split_counters(dev, stream, b * hkv)


def kv_decode_attention(q: torch.Tensor, kq: torch.Tensor,
                        k_scale: torch.Tensor, vq: torch.Tensor,
                        v_scale: torch.Tensor, positions: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """One-query decode attention over an int8 / packed-int4 cache ->
    (B, H, D) float32, in one launch: the rows split by ``decode_plan``,
    the splits merged by the last block of each (slot, kv head).
    positions (B,) int32 must be >= 0."""
    name = "kv_decode_attention"
    _on_card(name, q, kq, k_scale, vq, v_scale, positions)
    b, h, d, hkv = _check_decode_operands(name, q, kq, vq, k_scale, bits)
    s = kq.shape[1]
    _require(kq.shape[0] == b and tuple(v_scale.shape) == (b, s, hkv)
             and v_scale.dtype == torch.float32,
             f"{name}: codes must be (B, S, ...) and v_scale (B, S, Hkv) "
             f"float32")
    _require(tuple(positions.shape) == (b,) and positions.dtype == torch.int32,
             f"{name}: positions must be (B,) int32")
    ts = (q, kq, k_scale, vq, v_scale, positions)
    _require(all(t.is_contiguous() for t in ts),
             f"{name}: operands must be contiguous")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out.zero_()
    splits, chunk = decode_plan(b, hkv, h // hkv, s, bits)
    stream = _stream()
    ws, counters = _decode_scratch(q.device, stream, b, h, d, hkv, splits)
    _launch(name, q.data_ptr(), _DTYPE_CODE[q.dtype], kq.data_ptr(),
            k_scale.data_ptr(), vq.data_ptr(), v_scale.data_ptr(),
            positions.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, h, s, hkv, d, bits, chunk, splits, d ** -0.5, stream)
    return out


def paged_kv_decode_attention(q: torch.Tensor, kq_pool: torch.Tensor,
                              k_scale: torch.Tensor, vq_pool: torch.Tensor,
                              v_scale_pool: torch.Tensor, tbl: torch.Tensor,
                              positions: torch.Tensor,
                              bits: int) -> torch.Tensor:
    """``kv_decode_attention`` over page pools (P, page, Hkv, D or D/2)
    with per-page V scales (P, page, Hkv), a per-slot K scale (B, Hkv, D)
    and a (B, n) int32 block table -> (B, H, D) float32, on the plan of a
    contiguous cache of n * page rows.  Table entries clamp to [0, P - 1];
    positions (B,) int32 must be >= 0."""
    name = "paged_kv_decode_attention"
    _on_card(name, q, kq_pool, k_scale, vq_pool, v_scale_pool, tbl,
             positions)
    b, h, d, hkv = _check_decode_operands(name, q, kq_pool, vq_pool, k_scale,
                                          bits)
    p, page = kq_pool.shape[:2]
    _require(tuple(v_scale_pool.shape) == (p, page, hkv)
             and v_scale_pool.dtype == torch.float32,
             f"{name}: v_scale_pool must be (P, page, Hkv) float32")
    _require(tbl.ndim == 2 and tbl.shape[0] == b and tbl.dtype == torch.int32,
             f"{name}: tbl must be (B, n) int32, got {tuple(tbl.shape)} "
             f"{tbl.dtype}")
    _require(tuple(positions.shape) == (b,) and positions.dtype == torch.int32,
             f"{name}: positions must be (B,) int32")
    ts = (q, kq_pool, k_scale, vq_pool, v_scale_pool, tbl, positions)
    _require(all(t.is_contiguous() for t in ts),
             f"{name}: operands must be contiguous")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    n = tbl.shape[1]
    if b == 0 or n == 0 or p == 0 or page == 0:
        return out.zero_()
    splits, chunk = decode_plan(b, hkv, h // hkv, n * page, bits)
    stream = _stream()
    ws, counters = _decode_scratch(q.device, stream, b, h, d, hkv, splits)
    _launch(name, q.data_ptr(), _DTYPE_CODE[q.dtype], kq_pool.data_ptr(),
            k_scale.data_ptr(), vq_pool.data_ptr(), v_scale_pool.data_ptr(),
            tbl.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), b, h, p,
            page, n, hkv, d, bits, chunk, splits, d ** -0.5, stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16 with Sk >= Sq, head_dim
    contiguous (any batch/head/sequence strides) -> (B, H, Sq, D) bf16
    with q's strides.  Causal rows are aligned bottom-right: query row i
    sits at position Sk - Sq + i (the suffix prefill over shared prefix
    rows; Sk = Sq for a whole prompt).  Prefill calls it once a layer, so
    its host work stays small: messages are formatted only when a check
    fails, and the array of strides is made once for each set of
    strides."""
    name = "flash_attention"
    _on_card(name, q, k, v)
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
             "flash_attention: q, k, v must be bfloat16")
    qs, ks = q.shape, k.shape
    _require(len(qs) == 4 and len(ks) == 4 and ks == v.shape,
             "flash_attention: need q (B, H, Sq, D) and k, v (B, Hkv, Sk, "
             "D)")
    b, h, s, d = qs
    hkv, s_k = ks[1], ks[2]
    if not (ks[0] == b and s_k >= s and ks[3] == d):
        raise ValueError(f"{name}: k/v {tuple(ks)} do not match q "
                         f"{tuple(qs)} (need the same B and D, and Sk >= "
                         f"Sq)")
    if not (hkv > 0 and h % hkv == 0):
        raise ValueError(f"{name}: H={h} is not a multiple of Hkv={hkv}")
    if d != 64 and d != 128:
        raise ValueError(f"{name}: head_dim must be 64 or 128, got {d}")
    out = torch.empty_like(q)
    st = q.stride() + k.stride() + v.stride() + out.stride()
    _require(st[3] == st[7] == st[11] == st[15] == 1,
             "flash_attention: head_dim must be contiguous")
    strides = st[0:3] + st[4:7] + st[8:11] + st[12:15]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    _require(not any(x % 8 for x in strides)
             and not any(p % 16 for p in ptrs),
             "flash_attention: strides must be multiples of 8 elements and "
             "bases 16-byte aligned")
    if b == 0 or s == 0:
        return out
    arr = _FLASH_STRIDES.get(strides)
    if arr is None:
        if len(_FLASH_STRIDES) >= 1024:
            _FLASH_STRIDES.clear()
        arr = _FLASH_STRIDES[strides] = _LL12(*strides)
    _launch(name, *ptrs, b, h, hkv, s, s_k, d, arr, int(causal), d ** -0.5,
            _stream())
    return out
