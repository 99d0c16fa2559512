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
#undef FD8

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

template <int D>
__global__ void __launch_bounds__(F_THREADS, 2)
    flash_wg(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
             int B, int H, int Hkv, int Sq, int Sk, long long osb,
             long long osh, long long oss, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int NB = D / 64;   // 64-column boxes of a row
  constexpr int KD = D / 16;   // 16-deep steps over D
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
  // 16 rows there and stores them as 16-byte chunks.
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = __frcp_rn(fmaxf(l, 1e-30f));  // one reciprocal, not 64 divisions
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          qgen + swz<D>(warp * 16 + g + 8 * r, n) + 4 * t) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * den[r],
                                acc[4 * n + 2 * r + 1] * den[r]);
  __syncwarp();
  constexpr int CPR = D / 8;
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, const long long* st, int causal,
           float scale, cudaStream_t stream) {
  if (Sk < Sq) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  int e = flash_map(&qmap, q, D, Sq, H, B, st);
  if (e == 0) e = flash_map(&kmap, k, D, Sk, Hkv, B, st + 3);
  if (e == 0) e = flash_map(&vmap, v, D, Sk, Hkv, B, st + 6);
  if (e != 0) return e;
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wg<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_q = (Sq + FQ - 1) / FQ;
  if (n_q * H * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_q * H * B));
  flash_wg<D><<<grid, F_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), B, H, Hkv, Sq, Sk, st[9],
      st[10], st[11], causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32
// The float32 case of the same function: q, k, v and out float32, with the
// products in float32 FFMA (not TF32, which keeps about three decimal
// digits: bert-base runs float32, and the Pallas kernel upcasts q, k and v
// to float32 and accumulates in float32 whatever their type).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel, its float32 case).  Plain version: the same
// ref.attention.
//
// Bound on the H100: at bert-base's B = 32, H = 12, S = 384, D = 64 (not
// causal) the work is 4 B H S^2 D = 14.5 GFLOP of float32 FMA, 216 us at
// 67 TFLOP/s, against 151 MB of q, k, v and out (45 us at 3.35 TB/s):
// operations.  Every score costs 2 D FMAs and one expf; the design keeps
// the FMA units fed from registers and shared memory.
//
// Design: one block of 256 threads per (64-query tile, h, b), as a 16 x 16
// grid of threads.  Q (64 rows) and two stages of K and V tiles (64 rows
// each) sit in shared memory, copied with cp.async as 16-byte chunks (rows
// past Sq or Sk are zero-filled); tile j + 1 is in flight while tile j is
// used.  Thread (ty, tx) owns query rows 4 ty .. 4 ty + 3:
//  * S = Q.K^T: keys tx + 16 c (c < 4), so a quarter warp reads 8
//    consecutive K rows; Q and K rows are padded to D + 4 floats, which
//    puts those 8 rows' 16-byte chunks on distinct banks (Q's reads are
//    broadcasts).  4 x 4 scores a thread, one float4 of Q and of K per
//    four FMAs deep.
//  * The online softmax runs in the Pallas kernel's order: the scaled
//    scores, masked to -1e30 on tiles that cross Sk or the causal
//    diagonal; m_new = max(m, max_j s); p = exp(s - m_new); alpha =
//    exp(m - m_new); l = l alpha + sum p; acc = acc alpha + p.v; out = acc /
//    max(l, 1e-30).  A row's max and sum are reduced over the 16 threads
//    of its half warp with __shfl_xor_sync.
//  * P goes through shared memory (rows padded to 68 floats) and O = P.V
//    gives each thread its rows' columns 64 n + 4 tx .. + 3: one float4 of
//    V per key and 64-column group, the same float4 columns it stores.
// Causal rows are aligned bottom-right (query row i at position Sk - Sq +
// i) and key tiles wholly past a q tile's last row are skipped; GQA reads
// K/V head h / (H / Hkv).  Strides are the caller's (D contiguous; strides
// multiples of 4 elements and 16-byte aligned bases: the copies are
// 16-byte chunks).
constexpr int G_THREADS = 256, G_PP = 68;
constexpr float G_NEG_INF = -1e30f;

struct Strides {
  long long s[12];  // q, k, v, out: (batch, head, sequence) each
};

template <int D>
struct F32Layout {
  static constexpr int QP = D + 4;  // padded Q and K row (floats)
  static constexpr int Q = 64 * QP, K = 64 * QP, V = 64 * D;
  static constexpr int STAGE = K + V;
  static constexpr int BYTES = 4 * (Q + 2 * STAGE + 64 * G_PP);
};

// rows [row0, row0 + 64) of one head's (S, D) matrix into shared memory at
// `pitch` floats a row, zeros past row `rows`
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, int pitch,
                                          const float* src, long long ss,
                                          int row0, int rows, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * CPR / G_THREADS; ++i) {
    const int idx = tid + i * G_THREADS, r = idx / CPR, c = idx % CPR;
    const bool ok = row0 + r < rows;
    repro::cp_async16(repro::smem_addr(dst + r * pitch + 4 * c),
                      src + (ok ? row0 + r : 0) * ss + 4 * c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(G_THREADS, D == 64 ? 2 : 1)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int B,
              int H, int Hkv, int Sq, int Sk, Strides st, int causal,
              float scale) {
  using L = F32Layout<D>;
  constexpr int QP = L::QP, NJ = D / 64;
  extern __shared__ float4 smem_f4[];
  float* const qs = reinterpret_cast<float*>(smem_f4);
  float* const kv0 = qs + L::Q;  // stage s: K at kv0 + s STAGE, V after
  float* const ps = kv0 + 2 * L::STAGE;

  const int n_q = (Sq + 63) / 64;
  const int q_off = Sk - Sq;
  const int hb = blockIdx.x % (H * B);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * 64;
  const int n_kv_all = (Sk + 63) / 64;
  const int n_kv =
      causal ? min(n_kv_all, (q_off + q0 + 63) / 64 + 1) : n_kv_all;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* const qb = q + b * st.s[0] + h * st.s[1];
  const float* const kb = k + b * st.s[3] + hk * st.s[4];
  const float* const vb = v + b * st.s[6] + hk * st.s[7];

  copy_rows<D>(qs, QP, qb, st.s[2], q0, Sq, tid);
  copy_rows<D>(kv0, QP, kb, st.s[5], 0, Sk, tid);
  copy_rows<D>(kv0 + L::K, D, vb, st.s[8], 0, Sk, tid);
  repro::cp_async_commit();

  float acc[4][4 * NJ];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = G_NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      float* const nxt = kv0 + ((j + 1) & 1) * L::STAGE;
      copy_rows<D>(nxt, QP, kb, st.s[5], (j + 1) * 64, Sk, tid);
      copy_rows<D>(nxt + L::K, D, vb, st.s[8], (j + 1) * 64, Sk, tid);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const float* const ks = kv0 + (j & 1) * L::STAGE;
    const float* const vs = ks + L::K;

    // S = Q . K^T: s[i][c] is row 4 ty + i, key k0 + tx + 16 c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * QP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ka[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * QP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qa[i].x, ka[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, ka[c].y, s[i][c]);
          s[i][c] = fmaf(qa[i].z, ka[c].z, s[i][c]);
          s[i][c] = fmaf(qa[i].w, ka[c].w, s[i][c]);
        }
    }

    const int k0 = j * 64;
    const bool edge = k0 + 64 > Sk || (causal && k0 + 63 > q_off + q0);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = G_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] *= scale;
        const int key = k0 + tx + 16 * c;
        if (edge && (key >= Sk || (causal && key > q_off + row)))
          s[i][c] = G_NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
        ps[(4 * ty + i) * G_PP + tx + 16 * c] = s[i][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NJ; ++e) acc[i][e] *= alpha[i];
    }
    __syncthreads();

    // O += P . V: acc[i][4 n + e] is row 4 ty + i, column 64 n + 4 tx + e
#pragma unroll 2
    for (int kk = 0; kk < 64; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * G_PP +
                                                 kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float4 vv[NJ];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
          vv[n] = *reinterpret_cast<const float4*>(vs + (kk + t) * D +
                                                   64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? pa[i].x
                          : t == 1 ? pa[i].y
                          : t == 2 ? pa[i].z
                                   : pa[i].w;
#pragma unroll
          for (int n = 0; n < NJ; ++n) {
            acc[i][4 * n] = fmaf(p, vv[n].x, acc[i][4 * n]);
            acc[i][4 * n + 1] = fmaf(p, vv[n].y, acc[i][4 * n + 1]);
            acc[i][4 * n + 2] = fmaf(p, vv[n].z, acc[i][4 * n + 2]);
            acc[i][4 * n + 3] = fmaf(p, vv[n].w, acc[i][4 * n + 3]);
          }
        }
      }
    }
    __syncthreads();  // the stage and P are rewritten next
  }

  float* const ob = o + b * st.s[9] + h * st.s[10];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NJ; ++n)
      *reinterpret_cast<float4*>(ob + row * st.s[11] + 64 * n + 4 * tx) =
          make_float4(acc[i][4 * n] / den, acc[i][4 * n + 1] / den,
                      acc[i][4 * n + 2] / den, acc[i][4 * n + 3] / den);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, const long long* st,
               int causal, float scale, cudaStream_t stream) {
  if (Sk < Sq) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = F32Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_q = (Sq + 63) / 64;
  if (n_q * H * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Strides s;
  for (int i = 0; i < 12; ++i) s.s[i] = st[i];
  flash_f32<D><<<dim3(static_cast<unsigned>(n_q * H * B)), G_THREADS, bytes,
                 stream>>>(static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           static_cast<float*>(o), B, H, Hkv, Sq, Sk, s,
                           causal, scale);
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
    return launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal, scale,
                       st);
  if (D == 64)
    return launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal, scale,
                      st);
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
