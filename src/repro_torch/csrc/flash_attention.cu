// Blocked online-softmax (flash) attention for prefill, bf16 in and out:
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, hk, j] * scale) @ v[b, hk]
// over j <= i when causal, with hk = h / (H / Hkv) (GQA).  Running max,
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
//    heads, B) with the caller's strides, so the model's transposed views
//    need no copy; a box is 64 columns (128 bytes, the 128-byte swizzle's
//    limit) by 64 rows, so a D = 128 row arrives as two boxes.  Rows past
//    S arrive as zeros.  setmaxnreg hands the producer's registers to the
//    consumer (40 and 216 a thread; two blocks an SM).
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
//    stores, and rows past S are clipped there.
//  * The launch order runs the q-tile index slowest and backwards: causal
//    tiles near the diagonal's far end, which do the most work, start
//    first, and the last wave holds the lightest.
// Ragged S is masked in the kernel (-inf scores on the last key tile and
// on tiles that cross the causal diagonal), so no divisibility is needed.
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
             int B, int H, int Hkv, int S, long long osb, long long osh,
             long long oss, int causal, float scale_log2) {
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

  const int n_q = (S + FQ - 1) / FQ;
  const int hb = blockIdx.x % (H * B);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / (H * B));
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * FQ;
  const int n_kv_all = (S + FK - 1) / FK;
  const int n_kv = causal ? min(n_kv_all, (q0 + FQ - 1) / FK + 1) : n_kv_all;
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
    const bool edge = k0 + FK > S || (causal && k0 + FK - 1 > q0);
#pragma unroll
    for (int i = 0; i < FK / 2; ++i) sc[i] *= scale_log2;
    if (edge) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          if (key >= S || (causal && key > row0 + 8 * (e >> 1)))
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
    if (qi < S)
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
           int Hkv, int S, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int e = flash_map(&qmap, q, D, S, H, B, st);
  if (e == 0) e = flash_map(&kmap, k, D, S, Hkv, B, st + 3);
  if (e == 0) e = flash_map(&vmap, v, D, S, Hkv, B, st + 6);
  if (e != 0) return e;
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wg<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_q = (S + FQ - 1) / FQ;
  if (n_q * H * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_q * H * B));
  flash_wg<D><<<grid, F_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), B, H, Hkv, S, st[9], st[10],
      st[11], causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int S, int D,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, o, B, H, Hkv, S, strides, causal, scale, st);
  if (D == 64) return launch<64>(q, k, v, o, B, H, Hkv, S, strides, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
