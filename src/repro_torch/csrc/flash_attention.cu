// Blocked online-softmax (flash) attention for prefill, bf16 in and out
// (flash_wg), and float32 in and out (flash_f32, further down):
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, hk, j] * scale) @ v[b, hk]
// over j <= q_off + i when causal, with hk = h / (H / Hkv) (GQA).  q has
// Sq rows and k, v have Sk >= Sq: query row i sits at absolute position
// q_off + i with q_off = Sk - Sq, the bottom-right alignment of the plain
// version (a prefix-hit admission prefills its suffix over the shared
// prefix rows; a whole prompt has Sk = Sq and q_off = 0).  Running max,
// sum and accumulator stay in fp32.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  The JAX model runs the XLA chunked_attention scan in
// its place; the port's prefill calls this kernel on the card.
// Plain version: repro_torch/kernels/ref.py::attention.
//
// Bound on the H100: at B = 8, H = 16, S = 512, D = 128 the causal work is
// 8.6 GFLOP (8.7 us at 989 TFLOP/s) against 67 MB of q, k, v and out
// (20 us at 3.35 TB/s): bytes, narrowly.  P enters P.V as three bf16 terms,
// p_hi = bf16(p), p_mid = bf16(p - p_hi) and p_lo = bf16(p - p_hi - p_mid),
// so P.V keeps all 24 bits of the fp32 P rather than bf16's 8: the serving
// path's plain version (chunked_attention) keeps P in fp32, and every bit
// dropped here moves more bf16 outputs off the plain version's rounding,
// which the next projection's activation fake-quant turns into whole code
// steps.  That doubles the tensor work to about 17 GFLOP (17 us at the bf16
// peak), still under the byte bound.
//
// Design: one block per (64-query tile, h, b), warp-specialised.
//  * A producer warpgroup, one thread of it issuing, copies with TMA: Q
//    once, then K and V tiles of 64 rows into a 2-stage ring of mbarriers
//    (`full`: the copy's bytes have landed; `empty`: all 128 consumer
//    threads are done with the stage).  The tensor maps are 4-D, (D, S,
//    heads, B) with the caller's strides (S = Sq for Q, Sk for K and V),
//    so the model's transposed views need no copy; a box is 64 columns
//    (128 bytes, the 128-byte swizzle's limit) by 64 rows, so a D = 128
//    row arrives as two boxes.  Rows past S arrive as zeros.  setmaxnreg
//    hands the producer's registers to the consumer (40 and 216 a thread;
//    two blocks an SM).
//  * The consumer warpgroup owns the 64 query rows, warp w rows 16w ..
//    16w + 15.  S = Q.K^T runs on wgmma.m64n64k16 with both operands
//    K-major in shared memory (D contiguous), one wgmma a 16-deep step.
//  * The softmax works on the accumulator layout: a lane holds rows g and
//    g + 8 of its warp at 2 columns of each 8-column tile, so a row's max
//    needs two __shfl_xor_sync over the lane quad, and its sum stays per
//    lane until the end.  log2(e) is folded into the scale; one ex2 a
//    score.  Masks are applied only on tiles that need them.
//  * The accumulators of two neighbouring 8-key tiles are, lane for lane,
//    the register A fragment of a 16-key step (the m16n8k16 layout, which
//    wgmma's register A has per warp), so P splits into its three bf16
//    terms in registers and never touches shared memory.  P.V runs on
//    wgmma.m64n{64|128}k16 with that A and V as the B operand straight from
//    TMA's tile: V rows have D contiguous, an MN-major B, read with the
//    transpose bit.  Three wgmmas a 16-key step, the smallest term first.
//    O (64 fp32 a thread at D = 128) stays in registers and is rescaled in
//    place by alpha.
//  * The output is scaled by one reciprocal of the row sum and passes
//    through the (by then free) Q tile, so it leaves in 16-byte coalesced
//    stores, and rows past Sq are clipped there.
//  * The launch order runs the q-tile index slowest and backwards: causal
//    tiles near the diagonal's far end, which do the most work, start
//    first, and the last wave holds the lightest.
// Ragged Sq and Sk are masked in the kernel (-inf scores on the last key
// tile and on tiles that cross the causal diagonal), so no divisibility is
// needed.  A key tile that masks all of a row's keys leaves that row's
// max, sum and accumulator exactly as they were (alpha = 1, p = 0), so a
// row's result does not depend on which q tile holds it: with q_off = 0
// the kernel computes what it computed before the offset existed.
// Inputs take arbitrary batch/head/sequence strides (D contiguous; strides
// multiples of 8 elements, 16-byte aligned bases: TMA's rules).
//
// Head dim 80 (hubert-xlarge) runs the D = 128 instantiation on tensor maps
// whose inner extent is the caller's 80 columns: a 160-byte row is no
// multiple of the 128-byte swizzle span, so a row still arrives as two
// 64-column boxes, and TMA fills the second box's columns 80-127 with
// zeros (its transaction count is the whole box, as for rows past S).  Q
// and K are zero there, so S = Q.K^T is exact and takes 5 of the 8 16-deep
// steps; V is zero there, so O's columns 80-127 are zero and P.V still runs
// m64n128 (a 128-column accumulator, 60% of it wasted); the store writes
// columns 0-79 only, 10 16-byte chunks a row.  The scale is the caller's
// (80^-0.5).  The kernel moves the bytes of the 80-column rows: the bound
// counts those.
//
// Head dim 192 (deepseek-v3's MLA prefill: q and k are [nope 128 ; rope
// 64], and V arrives zero-padded from 128 to 192 columns, as the reference
// pads it; the caller keeps O's first 128) runs its own instantiation: a
// row is three 64-column boxes, S = Q.K^T takes 12 16-deep steps and P.V
// is wgmma.m64n192k16, whose accumulator holds 96 fp32 a thread.  Q and
// two stages of K and V take 5 x 24 KB: one block an SM.  That block
// has every register it asks for (__launch_bounds__(256, 1): up to 255 a
// thread), so the producer and consumer keep the same allocation and the
// instance makes no setmaxnreg.
#include <math.h>

#include "common.cuh"

namespace {

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_addr;
using repro::tma_load_4d;
using repro::wg_commit;
using repro::wg_desc;
using repro::wg_desc_mn;
using repro::wg_fence;
using repro::wg_hold;
using repro::wg_wait;

typedef __nv_bfloat16 bf16;
constexpr int FQ = 64, FK = 64, F_STAGES = 2, F_THREADS = 256;
constexpr int BLK = 64 * 128;  // one 64-row box of 64 bf16: 8 KB

template <int D>
struct Layout {
  static constexpr int TILE = 64 * D * 2;  // Q, K or V: D / 64 boxes
  static constexpr int BARS = 8 * (2 * F_STAGES + 1);
  static constexpr int BYTES = TILE * (1 + 2 * F_STAGES) + BARS + 1024;
};

#define FD8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64) (+)= Q (64 x 16, smem, K-major) . K^T (smem, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FD8(0), FD8(8), FD8(16), FD8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (64 x 64) (+)= Q (64 x 16, registers) . K^T (smem, K-major)
__device__ __forceinline__ void wgmma_qk_r(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 0;\n"
      "}\n"
      : FD8(0), FD8(8), FD8(16), FD8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// O (64 x 64) (+)= P (64 x 16, registers) . V (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_pv_z(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n"
      "}\n"
      : FD8(0), FD8(8), FD8(16), FD8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// O (64 x D) += P (64 x 16, registers) . V (16 x D, smem, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n"
      "}\n"
      : FD8(0), FD8(8), FD8(16), FD8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FD8(0), FD8(8), FD8(16), FD8(24), FD8(32), FD8(40), FD8(48),
        FD8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
template <>
__device__ __forceinline__ void wgmma_pv<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : FD8(0), FD8(8), FD8(16), FD8(24), FD8(32), FD8(40), FD8(48),
        FD8(56), FD8(64), FD8(72), FD8(80), FD8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
#undef FD8

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) -> three bf16x2 terms whose sum is (a, b) to fp32's 24 bits; both
// differences are exact in fp32
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bits_of(h);
  mid = bits_of(m);
  lo = bits_of(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// The same exact split with one conversion (the float32 kernel's: the
// conversion unit issues a quarter as fast as the ALU): hi = bf16(a) to
// nearest even as above; r = a - hi has at most 16 significant bits, so its
// upper half (truncation) is mid and r - mid, at most 8 significant bits,
// is lo exactly.  |mid| <= 2^-9 |a| and |lo| < 2^-16 |a|.
__device__ __forceinline__ void split3t(float a, float b, uint32_t& hi,
                                        uint32_t& mid, uint32_t& lo) {
  hi = bits_of(__floats2bfloat162_rn(a, b));
  const float ra = a - __uint_as_float(hi << 16);
  const float rb = b - __uint_as_float(hi & 0xFFFF0000u);
  const uint32_t ua = __float_as_uint(ra), ub = __float_as_uint(rb);
  mid = __byte_perm(ua, ub, 0x7632);
  const float la = ra - __uint_as_float(ua & 0xFFFF0000u);
  const float lb = rb - __uint_as_float(ub & 0xFFFF0000u);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0 (exp2f adds range
// scaling around it for denormal results, which P never needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in the output staging tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// D: the tile layout (64, 128 or 192 columns); DV <= D: the caller's head
// dim.  Two blocks an SM up to D = 128; one at D = 192 (its tiles take 121
// KB of shared memory)
template <int D, int DV>
__global__ void __launch_bounds__(F_THREADS, D > 128 ? 1 : 2)
    flash_wg(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
             int B, int H, int Hkv, int Sq, int Sk, long long osb,
             long long osh, long long oss, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int NB = D / 64;   // 64-column boxes of a row
  constexpr int KD = DV / 16;  // 16-deep steps over the caller's columns
  constexpr int SN = FK / 8;   // 8-key tiles of S
  constexpr int NT = D / 8;    // 8-column tiles of O
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;
  uint8_t* const qgen = smem_raw + (qs - raw);
  const uint32_t kv = qs + L::TILE;  // stage s: K, then V
  const uint32_t full = kv + 2 * F_STAGES * L::TILE;
  const uint32_t empty = full + 8 * F_STAGES;
  const uint32_t qbar = empty + 8 * F_STAGES;

  const int n_q = (Sq + FQ - 1) / FQ;
  const int q_off = Sk - Sq;  // absolute position of query row 0
  const int hb = blockIdx.x % (H * B);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * FQ;
  const int n_kv_all = (Sk + FK - 1) / FK;
  const int n_kv =
      causal ? min(n_kv_all, (q_off + q0 + FQ - 1) / FK + 1) : n_kv_all;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread releases
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // producer warpgroup: one thread issues every copy
    if constexpr (D <= 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128) {
      mbar_expect_tx(qbar, L::TILE);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(qs + c * BLK, &qmap, qbar, 64 * c, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % F_STAGES;
        if (j >= F_STAGES) mbar_wait(empty + 8 * s, (j / F_STAGES - 1) & 1);
        const uint32_t ks = kv + 2 * s * L::TILE;
        mbar_expect_tx(full + 8 * s, 2 * L::TILE);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(ks + c * BLK, &kmap, full + 8 * s, 64 * c, j * FK, hk, b);
          tma_load_4d(ks + L::TILE + c * BLK, &vmap, full + 8 * s, 64 * c,
                      j * FK, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: 64 query rows, warp w rows 16w .. 16w + 15
  if constexpr (D <= 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % F_STAGES;
    mbar_wait(full + 8 * s, (j / F_STAGES) & 1);
    const uint32_t ks = kv + 2 * s * L::TILE, vs = ks + L::TILE;

    // S = Q . K^T: K step kk is 32 bytes into box kk / 4 of Q and K
    float sc[FK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t off = (kk >> 2) * BLK + (kk & 3) * 32;
      wgmma_qk(sc, wg_desc(qs + off), wg_desc(ks + off), kk);
    }
    wg_commit();
    wg_wait<0>();
    wg_hold(sc);

    // sc[4n + e]: row g + 8 (e / 2) of the warp, key k0 + 8 n + 2 t + e % 2
    const int k0 = j * FK;
    const bool edge = k0 + FK > Sk || (causal && k0 + FK - 1 > q_off + q0);
#pragma unroll
    for (int i = 0; i < FK / 2; ++i) sc[i] *= scale_log2;
    if (edge) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > q_off + row0 + 8 * (e >> 1)))
            sc[4 * n + e] = -INFINITY;
        }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < SN; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[4 * n + 2 * r] *= alpha;
        acc[4 * n + 2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < FK / 2; ++i) {
      const float p = ex2(sc[i] - m_use[(i >> 1) & 1]);
      l_run[(i >> 1) & 1] += p;
      sc[i] = p;
    }
    // the A fragments of P, key step kk: key tiles 2kk and 2kk + 1
    uint32_t pa[FK / 16][3][4];  // p_lo, p_mid, p_hi
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
        split3(sc[i], sc[i + 1], pa[kk][2][e], pa[kk][1][e], pa[kk][0][e]);
      }
    // O += P . V, the smallest term first; key step kk is 16 rows (2 KB)
    // into V's boxes, which lie 8 KB apart
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
      for (int term = 0; term < 3; ++term)
        wgmma_pv<D>(acc, pa[kk][term], wg_desc_mn(vs + kk * 2048, BLK));
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
    mbar_arrive(empty + 8 * s);
  }

  // acc[4n + e]: row g + 8 (e / 2), column 8 n + 2 t + e % 2.  The Q tile
  // is free (the last S product has completed): each warp stages its own
  // 16 rows there (the caller's DV columns) and stores them as 16-byte
  // chunks.
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = __frcp_rn(fmaxf(l, 1e-30f));  // one reciprocal, not 64 divisions
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          qgen + swz<D>(warp * 16 + g + 8 * r, n) + 4 * t) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * den[r],
                                acc[4 * n + 2 * r + 1] * den[r]);
  __syncwarp();
  constexpr int CPR = DV / 8;  // 16-byte chunks of an output row
  static_assert(16 * CPR % 32 == 0, "a warp's rows split evenly over lanes");
  bf16* op = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = lane + 32 * i, r = idx / CPR, c = idx % CPR;
    const int qi = q0 + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(op + qi * oss + c * 8) =
          *reinterpret_cast<const uint4*>(qgen + swz<D>(warp * 16 + r, c));
  }
}

// A (D, S, heads, B) bf16 tensor map with arbitrary strides (elements), a
// box of 64 columns x 64 rows of one head
int flash_map(CUtensorMap* map, const void* p, int D, int S, int heads,
              int B, const long long* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {64, 64, 1, 1};
  return repro::tensor_map(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dims,
                           strides, box);
}

// D: the tile layout; DV: the caller's head dim, the tensor maps' extent
template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, const long long* st, int causal,
           float scale, cudaStream_t stream) {
  if (Sk < Sq) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  int e = flash_map(&qmap, q, DV, Sq, H, B, st);
  if (e == 0) e = flash_map(&kmap, k, DV, Sk, Hkv, B, st + 3);
  if (e == 0) e = flash_map(&vmap, v, DV, Sk, Hkv, B, st + 6);
  if (e != 0) return e;
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wg<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_q = (Sq + FQ - 1) / FQ;
  if (n_q * H * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_q * H * B));
  flash_wg<D, DV><<<grid, F_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), B, H, Hkv, Sq, Sk, st[9],
      st[10], st[11], causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32
// The float32 case of the same function: q, k, v and out float32, the
// products on the tensor cores through exact bf16 terms (not TF32, which
// keeps 10 of float32's 24 bits: bert-base runs float32, and the Pallas
// kernel upcasts q, k and v to float32 and accumulates in float32 whatever
// their type).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel, its float32 case).  Plain version: the same
// ref.attention.
//
// Bound on the H100: at bert-base's B = 32, H = 12, S = 384, D = 64 (not
// causal) the products are 4 B H S^2 D = 14.5 GFLOP.  In float32 FMA that
// is 216 us at 67 TFLOP/s; as the six bf16 products below, 87 GFLOP, 88 us
// at 989 TFLOP/s, against 151 MB of q, k, v and out (45 us at 3.35 TB/s):
// operations either way.
//
// Precision: each float32 operand x splits exactly into three bf16 terms,
// x = hi + mid + lo: hi = bf16(x) to nearest even; x - hi is exact in
// float32 with at most 16 significant bits, mid is its upper half and lo
// the rest, exactly (split3t: one conversion, then integer masks), so
// |mid| <= 2^-9 |x| and |lo| < 2^-16 |x|.  A product a b takes the six
// cross terms hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and lo.hi: the three
// dropped ones (mid.lo, lo.mid, lo.lo) lie below 2^-24 of |a b|.  wgmma
// multiplies bf16 exactly and sums in fp32, the smallest terms first; its
// sums are not rounded to nearest, so each kv tile's P.V goes to a zeroed
// tile sum and the tiles add in float32 FMAs (acc = acc alpha + tile):
// summing every tile into one wgmma accumulator gave 7.7e-6 of max|ref| at
// S = 512, D = 128, the tile sums 2.9e-6 (PERF.md §6).  Six terms, not
// three (hi.hi, hi.mid, mid.hi leave 2^-16): the scores' error reaches the
// output through exp, and 1e-5 of max|ref| needs float32's 24 bits.
//
// Design: persistent, one block an SM (216 KB of shared memory at D = 128,
// 208 KB at D = 64), 128 query rows a work item; items in order of (b, h),
// q tile fastest, so the q tiles of a head run side by side and read its K
// and V from device memory once.  Warp-specialised:
//  * One producer thread keeps TMA loads in flight of 64 x 64 float32
//    boxes through 4-D tensor maps over the caller's strides (unswizzled
//    256-byte rows; rows past Sq or Sk arrive as zeros), into a ring of
//    L::SLOTS landing boxes: an item's Q (two warpgroups x D / 64 boxes),
//    then for each kv tile its K boxes and its V boxes.
//  * Three producer warps split each landed box into its three bf16
//    terms and store each as a 64 x 64 box in the 128-byte-swizzled layout
//    that TMA gives the bf16 kernel (16-byte stores; the 8 threads of a row
//    hit its 8 chunks): Q into the warpgroup's Q boxes (once the warpgroup
//    has taken the previous item's), K and V into a ring of L::SLOTS term
//    boxes (24 KB each).  Each write is fenced for the async proxy and
//    signalled on an mbarrier.
//  * Two consumer warpgroups own 64 query rows each, warp w rows 16w ..
//    16w + 15.  At D = 64 a warpgroup moves Q's terms to registers once an
//    item (48 a thread) and S = Q.K^T reads only K's terms from shared
//    memory; at D = 128 (96 registers) both come from shared memory.  S
//    runs on wgmma.m64n64k16, 6 term pairs x D / 16 steps.
//  * The online softmax runs in the Pallas kernel's order on the
//    accumulator layout (a lane holds rows g and g + 8 of its warp at 2
//    columns of each 8-column tile; a row's max is two __shfl_xor_sync
//    over the lane quad): the scaled scores, masked to -1e30 on tiles that
//    cross Sk or the causal diagonal; m_new = max(m, max_j s); p = exp(s -
//    m_new); alpha = exp(m - m_new); l = l alpha + sum p (per lane, summed
//    over the quad at the end); acc = acc alpha + p.v; out = acc / max(l,
//    1e-30).  exp is one ex2.approx of (s - m) log2(e), 2^-22 relative.
//  * P splits into its three terms in registers: the accumulators of two
//    neighbouring 8-key tiles are, lane for lane, the register A fragment
//    of a 16-key step, so P never touches shared memory.  P.V runs on
//    wgmma.m64n64k16 (one box of 64 columns of O at a time) with V's terms
//    as the MN-major B operand (the transpose bit): 6 term pairs x 4 key
//    steps into the tile sum.
//  * O stays in registers (D / 2 floats a thread) and leaves as 8-byte
//    stores that fill whole 32-byte sectors; rows past Sq are not stored.
// Causal rows are aligned bottom-right (query row i at position Sk - Sq +
// i) and key tiles wholly past an item's last row are skipped (the first
// warpgroup's rows past the diagonal are masked); GQA reads K/V head h /
// (H / Hkv).  Strides are the caller's (D contiguous; strides multiples of
// 4 elements and 16-byte aligned bases: TMA's rules).
constexpr int F32_ROWS = 128;        // query rows a block: two warpgroups
constexpr int F32_THREADS = 384;     // 2 consumer warpgroups, the producer
constexpr int F32_CONVERTERS = 96;   // producer warps 1-3
constexpr int F32_SLOT = 3 * BLK;    // one 64 x 64 box in three bf16 terms
constexpr int F32_BOX = 64 * 64 * 4;  // one 64 x 64 float32 box: 16 KB
constexpr float F32_NEG_INF = -1e30f;
constexpr float F32_LOG2E = 1.4426950408889634f;

// Term pair pr of a product, the smallest first: (lo, hi), (hi, lo),
// (mid, mid), (mid, hi), (hi, mid), (hi, hi), with 0 = hi, 1 = mid, 2 = lo;
// term_a is Q's or P's term, term_b K's or V's.  Unrolled loops fold them.
__device__ __forceinline__ constexpr int term_a(int pr) {
  return pr == 0 ? 2 : (pr == 2 || pr == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int term_b(int pr) {
  return pr == 1 ? 2 : (pr == 2 || pr == 4) ? 1 : 0;
}

template <int D>
struct F32Layout {
  static constexpr int NB = D / 64;           // 64-column boxes of a row
  static constexpr int Q = 3 * NB * BLK;      // a warpgroup's Q terms
  // bf16 term boxes and float32 landing boxes: 208 KB in all at D = 64,
  // 216 KB at D = 128
  static constexpr int SLOTS = D == 64 ? 4 : 3;
  // D = 64: a warpgroup's Q terms move to registers (48 a thread) once an
  // item, so S reads only K from shared memory; D = 128 would need 96
  static constexpr bool QREG = D == 64;
  static constexpr int BARS = 8 * (4 * SLOTS + 4);
  static constexpr int BYTES =
      2 * Q + SLOTS * (F32_SLOT + F32_BOX) + BARS + 1024;
};

// Split 8 floats of row r, chunk ch (values 8 ch .. 8 ch + 7) into three
// bf16 terms and store each in its swizzled 128-byte row: term k of the box
// at dst + k * tstride.
__device__ __forceinline__ void f32_store8(uint32_t dst, int tstride,
                                           float4 a, float4 b, int r,
                                           int ch) {
  uint32_t t[3][4];
  split3t(a.x, a.y, t[0][0], t[1][0], t[2][0]);
  split3t(a.z, a.w, t[0][1], t[1][1], t[2][1]);
  split3t(b.x, b.y, t[0][2], t[1][2], t[2][2]);
  split3t(b.z, b.w, t[0][3], t[1][3], t[2][3]);
  const uint32_t off = r * 128 + ((ch ^ (r & 7)) << 4);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + k * tstride + off),
                 "r"(t[k][0]), "r"(t[k][1]), "r"(t[k][2]), "r"(t[k][3])
                 : "memory");
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_f32(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, float* __restrict__ o,
              int B, int H, int Hkv, int Sq, int Sk, long long osb,
              long long osh, long long oss, int causal, float scale) {
  using L = F32Layout<D>;
  constexpr int NB = L::NB;
  constexpr int SN = FK / 8;  // 8-key tiles of S
  extern __shared__ uint8_t f32_smem_raw[];
  const uint32_t qs = (smem_addr(f32_smem_raw) + 1023u) & ~1023u;
  const uint32_t slots = qs + 2 * L::Q;
  const uint32_t land = slots + L::SLOTS * F32_SLOT;
  const uint32_t slot_full = land + L::SLOTS * F32_BOX;
  const uint32_t slot_empty = slot_full + 8 * L::SLOTS;
  const uint32_t land_full = slot_empty + 8 * L::SLOTS;
  const uint32_t land_free = land_full + 8 * L::SLOTS;
  const uint32_t q_full = land_free + 8 * L::SLOTS;  // one a warpgroup
  const uint32_t q_free = q_full + 16;

  // Work item i is q tile n_q - 1 - i % n_q of (h, b) = i / n_q; a block
  // takes items blockIdx.x, + gridDim.x, ..., so the q tiles of a head run
  // side by side and its K and V come from device memory once.
  const int n_q = (Sq + F32_ROWS - 1) / F32_ROWS;
  const int items = n_q * H * B;
  const int q_off = Sk - Sq;
  const int n_kv_all = (Sk + FK - 1) / FK;
  auto n_kv_of = [&](int q0) {
    return causal ? min(n_kv_all, (q_off + q0 + F32_ROWS - 1) / FK + 1)
                  : n_kv_all;
  };
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < L::SLOTS; ++s) {
      mbar_init(slot_full + 8 * s, F32_CONVERTERS);
      mbar_init(slot_empty + 8 * s, 256);  // every consumer thread
      mbar_init(land_full + 8 * s, 1);
      mbar_init(land_free + 8 * s, F32_CONVERTERS);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(q_full + 8 * w, F32_CONVERTERS);
      mbar_init(q_free + 8 * w, 128);  // the warpgroup's threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer's sequence of float32 boxes, an item at a time: Q's 2 NB
  // (warpgroup w's box cb), then for each kv tile NB boxes of K and NB of V.
  if (wg == 2) {  // producer: warp 0 issues TMA, warps 1-3 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (tid == 256) {
      int i = 0;  // landing boxes filled so far
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int hb = it / n_q, h = hb % H, b = hb / H;
        const int q0 = (n_q - 1 - it % n_q) * F32_ROWS;
        const int hk = h / (H / Hkv);
        const int n = 2 * NB + 2 * NB * n_kv_of(q0);
        for (int u = 0; u < n; ++u, ++i) {
          const int s = i % L::SLOTS;
          if (i >= L::SLOTS)
            mbar_wait(land_free + 8 * s, (i / L::SLOTS - 1) & 1);
          mbar_expect_tx(land_full + 8 * s, F32_BOX);
          const uint32_t dst = land + s * F32_BOX, bar = land_full + 8 * s;
          if (u < 2 * NB) {
            tma_load_4d(dst, &qmap, bar, 64 * (u % NB), q0 + 64 * (u / NB),
                        h, b);
          } else {
            const int v = u - 2 * NB, j = v / (2 * NB), w = v % (2 * NB);
            tma_load_4d(dst, w < NB ? &kmap : &vmap, bar, 64 * (w % NB),
                        j * FK, hk, b);
          }
        }
      }
    } else if (tid >= 288) {
      const int c = tid - 288;
      int i = 0, k = 0, local = 0;  // landing boxes, slots, items so far
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++local) {
        const int q0 = (n_q - 1 - it % n_q) * F32_ROWS;
        const int n = 2 * NB + 2 * NB * n_kv_of(q0);
        for (int u = 0; u < n; ++u, ++i) {
          const int s = i % L::SLOTS;
          mbar_wait(land_full + 8 * s, (i / L::SLOTS) & 1);
          uint32_t dst;
          int tstride;
          if (u < 2 * NB) {  // Q: once the warpgroup is done with its last
            const int w = u / NB;
            if (local > 0 && u % NB == 0)
              mbar_wait(q_free + 8 * w, (local - 1) & 1);
            dst = qs + w * L::Q + (u % NB) * BLK;
            tstride = NB * BLK;
          } else {
            const int sl = k % L::SLOTS;
            if (k >= L::SLOTS)
              mbar_wait(slot_empty + 8 * sl, (k / L::SLOTS - 1) & 1);
            dst = slots + sl * F32_SLOT;
            tstride = BLK;
          }
          // chunk idx: row idx / 8, values 8 (idx % 8) .. + 7 of the
          // box's 256-byte row
          const uint32_t src = land + s * F32_BOX;
          for (int idx = c; idx < 64 * 8; idx += F32_CONVERTERS) {
            const int r = idx >> 3, ch = idx & 7;
            float4 a, bb;
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(a.x), "=f"(a.y), "=f"(a.z), "=f"(a.w)
                         : "r"(src + r * 256 + ch * 32));
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(bb.x), "=f"(bb.y), "=f"(bb.z), "=f"(bb.w)
                         : "r"(src + r * 256 + ch * 32 + 16));
            f32_store8(dst, tstride, a, bb, r, ch);
          }
          repro::fence_async_smem();
          if (u < 2 * NB) {
            if (u % NB == NB - 1) mbar_arrive(q_full + 8 * (u / NB));
          } else {
            mbar_arrive(slot_full + 8 * (k % L::SLOTS));
            ++k;
          }
          mbar_arrive(land_free + 8 * s);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .., warp w rows 16w ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int ct = tid & 127, lane = tid & 31, warp = ct >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t qsw = qs + wg * L::Q;  // term k, box cb at + (k NB + cb) BLK
  float acc[NB][32];
  float m_run[2], l_run[2];
  int ring0 = 0;  // the ring index of the item's first K box
  // ring box i: wait until it is written, its address, hand it back
  auto take = [&](int i) {
    mbar_wait(slot_full + 8 * (i % L::SLOTS), (i / L::SLOTS) & 1);
  };
  auto slot_of = [&](int i) { return slots + (i % L::SLOTS) * F32_SLOT; };
  auto give = [&](int i) { mbar_arrive(slot_empty + 8 * (i % L::SLOTS)); };
  // Q's A fragments (QREG), term k, D step kk: rows g and g + 8 of the
  // warp at D pairs (2t, 2t+1) (a[0], a[1]) and (2t+8, 2t+9) (a[2], a[3])
  uint32_t qa[3][L::QREG ? 4 : 1][4];
  // S = Q . K^T of kv tile j into sc: one commit group
  auto s_issue = [&](float (&sc)[FK / 2], int j) {
    const int i0 = ring0 + 2 * NB * j;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) take(i0 + cb);
    wg_fence();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db =
              wg_desc(slot_of(i0 + cb) + term_b(pr) * BLK + kk * 32);
          if constexpr (L::QREG)
            wgmma_qk_r(sc, qa[term_a(pr)][L::QREG ? kk : 0], db,
                       cb > 0 || pr > 0 || kk > 0);
          else
            wgmma_qk(sc,
                     wg_desc(qsw + (term_a(pr) * NB + cb) * BLK + kk * 32),
                     db, cb > 0 || pr > 0 || kk > 0);
        }
    wg_commit();
  };
  // P . V of kv tile j, O's 64-column box cb, into the zeroed tile sum t
  // (the smallest terms first): the tensor cores' fp32 sums then cover one
  // tile, and tiles add in float32 (acc = acc alpha + t, rounded once)
  auto pv_box = [&](const uint32_t (&pa)[FK / 16][3][4], int j, int cb,
                    float (&tile)[32]) {
    const int i = ring0 + 2 * NB * j + NB + cb;
    take(i);
    wg_fence();
#pragma unroll
    for (int pr = 0; pr < 6; ++pr)
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        wgmma_pv_z(tile, pa[kk][term_a(pr)],
                   wg_desc_mn(slot_of(i) + term_b(pr) * BLK + kk * 2048, BLK),
                   pr > 0 || kk > 0);
    wg_commit();
    wg_wait<0>();
    wg_hold(tile);
    give(i);
  };
  int local = 0;  // items so far
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++local) {
    const int hb = it / n_q, h = hb % H, b = hb / H;
    const int q0 = (n_q - 1 - it % n_q) * F32_ROWS;
    const int n_kv = n_kv_of(q0);
    const int qw = q0 + 64 * wg;  // the warpgroup's first row
    const int row0 = qw + warp * 16 + g;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    m_run[0] = m_run[1] = F32_NEG_INF;
    l_run[0] = l_run[1] = 0.f;

    // Softmax of kv tile j's scores in sc (Pallas's order): p into sc,
    // l updated, and alpha, the factor of acc, returned.
    // sc[4n + e]: row g + 8 (e / 2) of the warp, key k0 + 8 n + 2 t + e % 2
    auto softmax = [&](float (&sc)[FK / 2], int j, float (&alpha)[2]) {
      const int k0 = j * FK;
      const bool edge = k0 + FK > Sk || (causal && k0 + FK - 1 > q_off + qw);
#pragma unroll
      for (int i = 0; i < FK / 2; ++i) sc[i] *= scale;
      if (edge) {
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            if (key >= Sk || (causal && key > q_off + row0 + 8 * (e >> 1)))
              sc[4 * n + e] = F32_NEG_INF;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = F32_NEG_INF;
#pragma unroll
        for (int n = 0; n < SN; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        alpha[r] = ex2((m_run[r] - m_new) * F32_LOG2E);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2((sc[4 * n + 2 * r + e] - m_new) * F32_LOG2E);
            sc[4 * n + 2 * r + e] = p;
            sum += p;
          }
        l_run[r] = l_run[r] * alpha[r] + sum;
      }
    };
    // P's A fragments, key step kk (key tiles 2kk and 2kk + 1), in terms
    // hi, mid, lo
    auto split_p = [&](const float (&sc)[FK / 2], uint32_t (&pa)[FK / 16][3][4]) {
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
          split3t(sc[i], sc[i + 1], pa[kk][0][e], pa[kk][1][e], pa[kk][2][e]);
        }
    };

    mbar_wait(q_full + 8 * wg, local & 1);
    if constexpr (L::QREG) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int kk = 0; kk < (L::QREG ? 4 : 1); ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + g + 8 * (e & 1), ch = 2 * kk + (e >> 1);
            qa[k][kk][e] =
                lds32(qsw + k * BLK + r * 128 + ((ch ^ (r & 7)) << 4) + 4 * t);
          }
      mbar_arrive(q_free + 8 * wg);  // the next item's Q may come
    }
    // S of tile 0; then for each tile P.V (a box at a time) and S of the
    // next
    float sc[FK / 2], alpha[2];
    uint32_t pa[FK / 16][3][4];
    s_issue(sc, 0);
    for (int j = 0;; ++j) {
      wg_wait<0>();
      wg_hold(sc);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) give(ring0 + 2 * NB * j + cb);
      if (!L::QREG && j + 1 == n_kv) mbar_arrive(q_free + 8 * wg);
      softmax(sc, j, alpha);
      split_p(sc, pa);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        float tile[32];
        pv_box(pa, j, cb, tile);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[cb][i] = fmaf(acc[cb][i], alpha[(i >> 1) & 1], tile[i]);
      }
      if (j + 1 == n_kv) break;
      s_issue(sc, j + 1);
    }
    ring0 += 2 * NB * n_kv;

    // acc[cb][4n + e]: row g + 8 (e / 2), column 64 cb + 8 n + 2 t + e % 2
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      den[r] = fmaxf(l, 1e-30f);
    }
    float* const ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(ob + row * oss + 64 * cb + 8 * n +
                                     2 * t) =
              make_float2(acc[cb][4 * n + 2 * r] / den[r],
                          acc[cb][4 * n + 2 * r + 1] / den[r]);
    }
  }
}

// A (D, S, heads, B) float32 tensor map with arbitrary strides (elements),
// a box of 64 columns x 64 rows of one head, unswizzled
int flash_map_f32(CUtensorMap* map, const void* p, int D, int S, int heads,
                  int B, const long long* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 4,
                               static_cast<uint64_t>(st[1]) * 4,
                               static_cast<uint64_t>(st[0]) * 4};
  const uint32_t box[4] = {64, 64, 1, 1};
  return repro::tensor_map(map, p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dims,
                           strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, const long long* st,
               int causal, float scale, cudaStream_t stream) {
  if (Sk < Sq) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  int e = flash_map_f32(&qmap, q, D, Sq, H, B, st);
  if (e == 0) e = flash_map_f32(&kmap, k, D, Sk, Hkv, B, st + 3);
  if (e == 0) e = flash_map_f32(&vmap, v, D, Sk, Hkv, B, st + 6);
  if (e != 0) return e;
  constexpr int bytes = F32Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>((Sq + F32_ROWS - 1) / F32_ROWS) * H * B;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < repro::sm_count() ? items : repro::sm_count());
  flash_f32<D><<<grid, F32_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<float*>(o), B, H, Hkv, Sq, Sk, st[9],
      st[10], st[11], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                            scale, st);
  if (D == 80)  // hubert-xlarge: the D = 128 tiles, zeros past column 80
    return launch<128, 80>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                           scale, st);
  if (D == 64)
    return launch<64, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                          scale, st);
  if (D == 192)  // deepseek-v3's MLA: [nope ; rope] keys, V padded to 192
    return launch<192, 192>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                            scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int Hkv, int Sq, int Sk,
                                          int D, const long long* strides,
                                          int causal, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_f32<128>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                           scale, st);
  if (D == 64)
    return launch_f32<64>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                          scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
