// Packed low-bit weight x activation matmul:
//   out[m, n] = (sum_k bf16(x[m, k]) * code[k, n]) * scale[n]
// with fp32 accumulation and the per-channel scale applied once, after the
// last K step (the op order of the Pallas kernel).  Weights are K-major
// uint8: int4 holds K-rows 2r (low nibble) and 2r+1 (high nibble) of column
// n in byte (r, n); int2 holds K-rows 4r..4r+3 as bit-pairs, LSB first;
// codes are sign-extended.  The output has x's dtype.
//
// Replaces: src/repro/kernels/quant_matmul.py::quant_matmul (_qmm_kernel,
// _unpack_w4_block/_unpack_w2_block).
// Plain version: repro_torch/kernels/ref.py::quant_matmul_w4 / _w2.
//
// Bound on the H100, by regime:
//  * Decode (M <= 16, every decode projection) is bound by the bytes of the
//    packed codes: at M = 8, K = 2048, N = 8192, int4 moves 8.4 MB of codes
//    against 0.27 GFLOP, 2.5 us at 3.35 TB/s.  A kernel that spends scalar
//    instructions on every (code, token) pair is bound by issue instead, so
//    qmm_gemv reads each code byte once and hands the products to the
//    tensor cores:
//    - out^T = W^T x^T on mma.sync m16n8k16: the channels are the 16 rows
//      of A, the <= 16 tokens one or two n = 8 tiles of B.  A is built from
//      the codes in registers by the exact conversion of 2. below, so a
//      code costs no int-to-float conversion, shared load or scalar FMA;
//    - each lane loads 16 bytes (ld.global.nc.v4) of one packed row: the 8
//      lane groups g cover 128 channels of a row and the 4 lanes t of a
//      group rows t and t + 4, so a warp's load is whole 128-byte lines and
//      a K step (8 packed rows x 128 channels, 1 KB) is two loads a lane.
//      Byte j of group g is channel 16 g + j; fragment row g of mma tile i
//      is channel 16 g + 2 i and row g + 8 channel 16 g + 2 i + 1, so one
//      load feeds 8 tiles, and the epilogue undoes the permutation;
//    - a warp keeps 4 K steps (4 KB) in flight in registers and issues the
//      next step's loads before a step's unpack and mma;
//    - split K: a block (8 warps) owns 128 channels and one slice of K.  The
//      host's plan (cuda.py's gemv_plan) cuts K into as many slices as one
//      block on each SM leaves room for: 128 blocks at every olmo-1b shape
//      (N = 2048 alone gives 16).  Slices write fp32 partial sums to a
//      workspace, and the last block of a tile to arrive, found by a
//      counter, adds them in slice order and scales: no floating-point
//      atomics, so a call repeats bit for bit;
//    - x is staged once per block, its K slice as bf16 (the values the
//      Pallas kernel feeds its MXU) by 16-byte cp.async issued after the
//      codes' loads, in rows padded so that the lanes' B fragment loads of
//      a step fall in distinct banks; the scales are read then too.
//    What is left (PERF.md §6): with one block an SM, all of an olmo-1b
//    weight is requested at once, so a launch takes the codes' latency and
//    transfer plus what must follow the last byte: the math of the last
//    steps, the warps' sum, and with split K the partial sums' round trip
//    through L2 and the counter.
//  * Prefill (M = tokens, here 4096) is bound by operations: the gate
//    projection (K = 2048, N = 8192) is 2 * 4096 * 2048 * 8192 = 137 GFLOP,
//    0.139 ms at 989 TFLOP/s, against 4.2 MB of x and codes.  Two routes,
//    chosen by shape in the wrapper (never one after the other fails):
//    - qmm_wg, where K % 8 == 0 and N % 16 == 0 (TMA's 16-byte row
//      strides; every olmo-1b projection): the product runs transposed,
//      out^T = W^T x^T, on wgmma.m64n256k16 with the codes as the A operand
//      in registers and x as the K-major B operand in shared memory.  A
//      block computes 128 channels x 256 tokens: a producer warpgroup
//      keeps TMA loads of x (256 x 64 bf16) and of the packed codes (64 K x
//      128 channels), both 128-byte swizzled, in flight in a 4-stage ring
//      of mbarriers; two consumer warpgroups of 64 channels each convert
//      their codes to A fragments and run 4 wgmmas a stage, fp32
//      accumulators in registers (128 a thread).
//    - qmm_tc, for the other shapes: mma.sync m16n8k16 on 128 x 128 tiles,
//      8 warps of 64 (M) x 32 (N) with 64 fp32 accumulators a thread, fed
//      by a 4-stage cp.async ring (16-byte copies; 4-byte copies where K % 8
//      or N % 16 breaks alignment, plain byte loads where N % 4 does), x
//      stored with an XOR swizzle (chunk ^ row % 8) and read by ldmatrix.x4.
//    Against the four limits of the earlier 64 x 64 WMMA kernel:
//    1. loads overlap the math: TMA (qmm_wg) or cp.async (qmm_tc) fills
//       stages ahead of the one the tensor cores read; ragged M, N and K
//       are zero-filled by the copy (TMA's out-of-bounds fill, cp.async's
//       src-size 0);
//    2. the codes stay packed in shared memory (4 KB a stage at int4, 2 KB
//       at int2) and go straight into fragments in registers.  In the
//       m16n8k16 layout (and wgmma's A, which has it) a lane holds the K
//       pairs (2t, 2t+1) and (2t+8, 2t+9) of a row: at int4 exactly bytes t
//       and t + 4 of a 16-deep K step, at int2 the bit-pairs at offset
//       4 (t & 1) of bytes t / 2 and t / 2 + 2, so x needs no K
//       permutation.  A code c becomes bf16 exactly: 0x4300 | (c ^ 8) is
//       136 + sext(c) (int4; 0x4300 | (c ^ 2) is 130 + sext(c) at int2),
//       minus 136 (130) in one bf16x2 FMA.  The fragment rows (columns)
//       are permuted over the output channels so that one 16-bit (32-bit)
//       load gives a lane its bytes;
//    3. the tiles are 128 x 256 (wgmma) or 128 x 128 (mma.sync) instead of
//       64 x 64, so x is re-read by N / 128 blocks instead of N / 64;
//    4. the epilogue scales and stores straight from the accumulators,
//       masked at the ragged edge; nothing passes through shared memory.
//    x reaches the tensor cores as bf16; the wrapper rounds a float32 x to
//    bf16 once (round to nearest even, the rounding of the Pallas kernel's
//    astype) and the kernels then write float32.
#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_bf16;
using repro::smem_addr;
using repro::tma_load_2d;
using repro::wg_commit;
using repro::wg_desc;
using repro::wg_fence;
using repro::wg_hold;
using repro::wg_wait;

constexpr int TM = 128, TN = 128, TK = 64;   // block tile and K step
constexpr int T_THREADS = 256, T_STAGES = 4;
constexpr int XS_BYTES = TM * TK * 2;        // one stage of x: 16 KB

template <int BITS>
struct Stage {  // one ring stage: the x tile, then the packed codes tile
  static constexpr int BYTES = XS_BYTES + TK / (8 / BITS) * TN;
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// COLS columns' codes, one byte each (byte j is column j), to one bf16x2
// register per column: lo holds the even K row's code and hi the odd one's,
// each masked to BITS bits.  Byte j of lo goes to bits 0-7 and byte j of hi
// to bits 16-23; selector nibble 8 copies the sign of lo's byte 0, which is
// 0.  XOR with 0x4300 | bias sets the exponent of 128 and biases the code,
// and one FMA subtracts 128 + bias: exact for every code.
template <int BITS, int COLS>
__device__ __forceinline__ void codes_to_bf16x2(uint32_t lo, uint32_t hi,
                                                uint32_t (&b)[COLS]) {
  constexpr uint32_t BIAS = 1u << (BITS - 1);
  constexpr uint32_t MAGIC = (0x4300u | BIAS) * 0x10001u;
  constexpr uint32_t NEG = (0xC300u | BIAS) * 0x10001u;  // -(128 + BIAS)
  constexpr uint32_t ONE = 0x3F803F80u;                   // 1.0, 1.0
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const uint32_t v = prmt(lo, hi, 0x8080u | ((4u + j) << 8) | j) ^ MAGIC;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(b[j])
        : "r"(v), "r"(ONE), "r"(NEG));
  }
}

// Copy K step k0 of the x tile and the codes tile into one ring stage.
// x: row r's 16-byte chunk c goes to chunk c ^ (r % 8) of its 128-byte row.
// Codes: packed row r's chunk c goes to chunk c ^ 2 (r % 4).
template <int BITS>
__device__ __forceinline__ void load_stage(
    uint8_t* stage, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ wp, int M, int N, int K, int m0, int n0,
    int k0, int tid, bool x16, int wvec) {
  constexpr int PACK = 8 / BITS;
  constexpr int WROWS = TK / PACK;
  const uint32_t xs = smem_addr(stage), ws = xs + XS_BYTES;
#pragma unroll
  for (int i = 0; i < TM * 8 / T_THREADS; ++i) {
    const int idx = tid + i * T_THREADS, r = idx >> 3, c = idx & 7;
    const int m = m0 + r, k = k0 + c * 8;
    const uint32_t dst = xs + r * 128 + ((c ^ (r & 7)) << 4);
    const __nv_bfloat16* src = x + static_cast<size_t>(m) * K + k;
    if (x16) {
      const bool ok = m < M && k < K;
      cp_async16(dst, ok ? src : x, ok);
    } else {  // K % 8 != 0: bf16 pairs (K is even)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = m < M && k + 2 * e < K;
        cp_async4(dst + 4 * e, ok ? src + 2 * e : x, ok);
      }
    }
  }
  const int kp = K / PACK;
  for (int idx = tid; idx < WROWS * 8; idx += T_THREADS) {
    const int r = idx >> 3, c = idx & 7;
    const int row = k0 / PACK + r, n = n0 + c * 16;
    const uint32_t dst = ws + r * 128 + ((c ^ ((r & 3) << 1)) << 4);
    const uint8_t* src = wp + static_cast<size_t>(row) * N + n;
    if (wvec == 16) {
      const bool ok = row < kp && n < N;
      cp_async16(dst, ok ? src : wp, ok);
    } else if (wvec == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row < kp && n + 4 * e < N;
        cp_async4(dst + 4 * e, ok ? src + 4 * e : wp, ok);
      }
    } else {  // N % 4 != 0: plain byte loads, stored before the next barrier
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (row < kp)
        for (int e = 0; e < 16; ++e)
          if (n + e < N) v[e >> 2] |= static_cast<uint32_t>(src[e]) << (8 * (e & 3));
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    }
  }
}

template <typename OT>
__device__ __forceinline__ void store8(OT* p, const float (&v)[8], int left,
                                       bool vec);
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[8],
                                                      int left, bool vec) {
  if (vec && left >= 8) {
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      u[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < left) p[e] = __float2bfloat16_rn(v[e]);
  }
}
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8],
                                              int left, bool vec) {
  if (vec && left >= 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < left) p[e] = v[e];
  }
}

template <typename OT>
__device__ __forceinline__ void store2(OT* p, float a, float b);
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int BITS, typename OT>
__global__ void __launch_bounds__(T_THREADS, 2)
    qmm_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
           const float* __restrict__ scale, OT* __restrict__ out, int M, int N,
           int K, int x16, int wvec) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int STAGE = Stage<BITS>::BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kt_n = (K + TK - 1) / TK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < kt_n)
      load_stage<BITS>(smem + s * STAGE, x, wp, M, N, K, m0, n0, s * TK, tid,
                       x16, wvec);
    cp_async_commit();
  }

  // ldmatrix: lane l addresses row l % 16 of the fragment, K chunk l / 16
  const uint32_t a_row = (wm * 64 + (lane & 15)) * 128;
  const int a_chunk = lane >> 4, a_swz = lane & 7;
  // codes: the lane's 4 columns 4g..4g+3 of the warp's 32, one 32-bit word
  const int b_chunk = wn * 2 + (g >> 2), b_off = (g & 3) * 4;

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free
    const int nk = kt + T_STAGES - 1;
    if (nk < kt_n)
      load_stage<BITS>(smem + (nk % T_STAGES) * STAGE, x, wp, M, N, K, m0, n0,
                       nk * TK, tid, x16, wvec);
    cp_async_commit();

    const uint32_t xs = smem_addr(smem + (kt % T_STAGES) * STAGE);
    const uint32_t ws = xs + XS_BYTES;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], xs + a_row + i * 16 * 128 +
                              (((kk * 2 + a_chunk) ^ a_swz) << 4));
      // packed rows of the K pairs (2t, 2t+1) and (2t+8, 2t+9)
      int r0, r1, shift;
      if (BITS == 4) {
        r0 = kk * 8 + t;
        r1 = r0 + 4;
        shift = 0;
      } else {
        r0 = kk * 4 + (t >> 1);
        r1 = r0 + 2;
        shift = 4 * (t & 1);
      }
      const uint32_t w0 =
          lds32(ws + r0 * 128 + ((b_chunk ^ ((r0 & 3) << 1)) << 4) + b_off) >> shift;
      const uint32_t w1 =
          lds32(ws + r1 * 128 + ((b_chunk ^ ((r1 & 3) << 1)) << 4) + b_off) >> shift;
      constexpr uint32_t MASK = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
      uint32_t b0[4], b1[4];
      codes_to_bf16x2<BITS, 4>(w0 & MASK, (w0 >> BITS) & MASK, b0);
      codes_to_bf16x2<BITS, 4>(w1 & MASK, (w1 >> BITS) & MASK, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b0[j], b1[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows g and g + 8 of M-fragment i, fragment columns
  // 2t and 2t + 1 of N-fragment j = output columns 8t + j and 8t + 4 + j
  const int col = n0 + wn * 32 + 8 * t;
  const int left = N - col;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = e < left ? scale[col + e] : 0.f;
  const bool vec = (N % 8) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + h * 8 + g;
      if (m >= M || left <= 0) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h] * sc[j];
        v[4 + j] = acc[i][j][2 * h + 1] * sc[4 + j];
      }
      store8<OT>(out + static_cast<size_t>(m) * N + col, v, left, vec);
    }
}

template <int BITS, typename OT>
int launch_tc(const void* x, const void* wp, const void* scale, void* out,
              int M, int N, int K, cudaStream_t st) {
  constexpr int SMEM = T_STAGES * Stage<BITS>::BYTES;  // 80 KB / 72 KB
  const cudaError_t e = cudaFuncSetAttribute(
      qmm_tc<BITS, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wp);
  const int x16 = (K % 8 == 0) && (xa % 16 == 0);
  const int wvec = (N % 16 == 0 && wa % 16 == 0) ? 16 : (N % 4 == 0 ? 4 : 1);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  qmm_tc<BITS, OT><<<grid, T_THREADS, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scale), static_cast<OT*>(out), M, N, K, x16,
      wvec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// qmm_wg: the Hopper route (see the top of the file).
constexpr int WG_CH = 128;       // output channels a block: 2 x 64
constexpr int WG_TOK = 256;      // tokens a block: wgmma's N
constexpr int WG_K = 64;         // K step: one 128-byte row of bf16 x
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;  // 2 consumer warpgroups, then the producer
constexpr int WG_XBYTES = WG_TOK * WG_K * 2;  // 32 KB

template <int BITS>
struct WgShape {
  static constexpr int WROWS = WG_K / (8 / BITS);     // packed rows a stage
  static constexpr int WBYTES = WROWS * WG_CH;         // 4 KB / 2 KB
  static constexpr int SMEM =
      WG_STAGES * (WG_XBYTES + WBYTES) + 2 * WG_STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

#define WG_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, fp32) += a (64 x 16 bf16, registers) * B (16 x 256, smem)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88),
        WG_D8(96), WG_D8(104), WG_D8(112), WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef WG_D8

template <int BITS, typename OT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    qmm_wg(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap,
           const float* __restrict__ scale, OT* __restrict__ out, int M, int N,
           int K) {
  using S = WgShape<BITS>;
  extern __shared__ uint8_t wg_smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t base = (smem_addr(wg_smem_raw) + 1023u) & ~1023u;
  const uint32_t xs = base;                             // WG_STAGES x 32 KB
  const uint32_t ws = xs + WG_STAGES * WG_XBYTES;       // WG_STAGES x WBYTES
  const uint32_t full = ws + WG_STAGES * S::WBYTES;     // mbarriers, 8 B each
  const uint32_t empty = full + 8 * WG_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * WG_CH, m0 = blockIdx.y * WG_TOK;
  const int kt_n = (K + WG_K - 1) / WG_K;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(empty + 8 * s, (kt / WG_STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, WG_XBYTES + S::WBYTES);
        tma_load_2d(xs + s * WG_XBYTES, &xmap, full + 8 * s, kt * WG_K, m0);
        tma_load_2d(ws + s * S::WBYTES, &wmap, full + 8 * s, n0,
                    kt * S::WROWS);
      }
    }
  } else {  // consumer warpgroup wg: channels n0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    // A row 16 warp + g + 8 h is channel 64 wg + 16 warp + 2 g + h: the two
    // channels of a lane are neighbouring bytes of a packed row, in the
    // 16-byte chunk 4 wg + warp of the 128-byte row (swizzled by row % 8)
    const int chunk = 4 * wg + warp, boff = 2 * g;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % WG_STAGES;
      mbar_wait(full + 8 * s, (kt / WG_STAGES) & 1);
      const uint32_t wsa = ws + s * S::WBYTES;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < WG_K / 16; ++kk) {
        int r0, r1, shift;
        if (BITS == 4) {
          r0 = kk * 8 + t;
          r1 = r0 + 4;
          shift = 0;
        } else {
          r0 = kk * 4 + (t >> 1);
          r1 = r0 + 2;
          shift = 4 * (t & 1);
        }
        const uint32_t u0 =
            lds16(wsa + r0 * 128 + ((chunk ^ (r0 & 7)) << 4) + boff) >> shift;
        const uint32_t u1 =
            lds16(wsa + r1 * 128 + ((chunk ^ (r1 & 7)) << 4) + boff) >> shift;
        constexpr uint32_t MASK = BITS == 4 ? 0x0F0Fu : 0x0303u;
        uint32_t b0[2], b1[2];
        codes_to_bf16x2<BITS, 2>(u0 & MASK, (u0 >> BITS) & MASK, b0);
        codes_to_bf16x2<BITS, 2>(u1 & MASK, (u1 >> BITS) & MASK, b1);
        a[kk][0] = b0[0];  // row g, K pair (2t, 2t+1)
        a[kk][1] = b0[1];  // row g + 8
        a[kk][2] = b1[0];  // row g, K pair (2t+8, 2t+9)
        a[kk][3] = b1[1];
      }
      wg_fence();
      const uint64_t desc = wg_desc(xs + s * WG_XBYTES);
#pragma unroll
      for (int kk = 0; kk < WG_K / 16; ++kk)
        wgmma_m64n256k16(d, a[kk], desc + 2 * kk);  // + 32 bytes of K
      wg_commit();
      wg_wait<0>();
      mbar_arrive(empty + 8 * s);
    }
    wg_hold(d);

    // d[4 i + 2 h + v]: channel 64 wg + 16 warp + 2 g + h, token 8 i + 2 t + v
    const int ch = n0 + 64 * wg + 16 * warp + 2 * g;
    if (ch < N) {  // N % 16 == 0: ch + 1 < N too
      const float s0 = scale[ch], s1 = scale[ch + 1];
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int m = m0 + 8 * i + 2 * t + v;
          if (m < M) store2<OT>(out + static_cast<size_t>(m) * N + ch,
                                d[4 * i + v] * s0, d[4 * i + 2 + v] * s1);
        }
    }
  }
}

template <int BITS, typename OT>
int launch_wg(const void* x, const void* wp, const void* scale, void* out,
              int M, int N, int K, cudaStream_t st) {
  using S = WgShape<BITS>;
  CUtensorMap xmap, wmap;
  const int kp = K / (8 / BITS);
  const uint64_t xdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xstride[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t xbox[2] = {WG_K, WG_TOK};
  const uint64_t wdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(kp)};
  const uint64_t wstride[1] = {static_cast<uint64_t>(N)};
  const uint32_t wbox[2] = {WG_CH, S::WROWS};
  int e = repro::tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            xdims, xstride, xbox);
  if (e == 0)
    e = repro::tensor_map(&wmap, wp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wdims,
                          wstride, wbox);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      qmm_wg<BITS, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((N + WG_CH - 1) / WG_CH, (M + WG_TOK - 1) / WG_TOK);
  qmm_wg<BITS, OT><<<grid, WG_THREADS, S::SMEM, st>>>(
      xmap, wmap, static_cast<const float*>(scale), static_cast<OT*>(out), M,
      N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// qmm_gemv: the decode route, M <= 16 (see the top of the file).
constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_CH = 128;      // channels a block: 8 lane groups x 16 bytes
constexpr int GV_ROWS = 8;      // packed rows a K step: lane t reads t, t + 4
constexpr int GV_DEPTH = 4;     // K steps a warp keeps in flight
constexpr int GV_SLICE_K = 1024;  // K a block stages (cuda.py's plan obeys)

template <int BITS>
struct Gv {
  static constexpr int PACK = 8 / BITS;
  static constexpr int KC = GV_ROWS * PACK;  // K a step: 16 (int4), 32 (int2)
  // padding of a staged x row, in 32-bit words: with it, the lanes' B
  // fragment loads of a step fall in distinct banks
  static constexpr int PAD = BITS == 4 ? 4 : 8;
};

// The 16 code bytes of packed row `row` at channels n .. n + 15; zero past
// kp rows or N channels.  One 16-byte load where N % 16 == 0 and wp is
// aligned (V16); else 4-byte loads (wvec 4, N % 4 == 0) or bytes.
template <bool V16>
__device__ __forceinline__ uint4 gv_load(const uint8_t* __restrict__ wp,
                                         int row, int kp, int n, int N,
                                         int wvec) {
  if (row >= kp || n >= N) return make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* p = wp + static_cast<size_t>(row) * N + n;
  if (V16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (wvec == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + 4 * e < N) w[e] = __ldg(reinterpret_cast<const uint32_t*>(p + 4 * e));
  } else {
    for (int e = 0; e < 16; ++e)
      if (n + e < N) w[e >> 2] |= static_cast<uint32_t>(__ldg(p + e)) << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One K step of a warp: the codes of packed rows t (v0) and t + 4 (v1) at
// the lane's 16 channels, times x's B fragments.  Byte j of a lane's 16 is
// channel 16 g + j: tile i takes bytes 2i (row g) and 2i + 1 (row g + 8),
// so word q of v0 / v1 feeds tiles 2q and 2q + 1.  xg points at the
// staged x of token g (token 8 + g is 8 rsw words on), at the step's
// first word for lane t:
//  int4: row t holds the K pair (2t, 2t+1) and row t + 4 the pair
//        (2t+8, 2t+9) of the mma's 16: one mma step, x words t and t + 4;
//  int2: row t + 4s holds K 4r .. 4r + 3 (r = the row), the pairs (4r, 4r+1)
//        and (4r+2, 4r+3) of mma step s: the mma's K order is permuted, and
//        a lane reads x words 2 (t + 4s) and the next in one 8-byte load.
template <int BITS, int NT>
__device__ __forceinline__ void gv_step(float (&acc)[8][NT][4], const uint4& v0,
                                        const uint4& v1,
                                        const uint32_t* __restrict__ xg,
                                        int rsw) {
  constexpr uint32_t MASK = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  constexpr int MS = BITS == 4 ? 1 : 2;  // mma steps a K step
  uint32_t b[NT][2 * MS];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint32_t* p = xg + nt * 8 * rsw;
    if constexpr (BITS == 4) {
      b[nt][0] = p[0];
      b[nt][1] = p[4];
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint2 u = *reinterpret_cast<const uint2*>(p + 8 * s);
        b[nt][2 * s] = u.x;
        b[nt][2 * s + 1] = u.y;
      }
    }
  }
  const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
  const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      uint32_t lo[4], hi[4];  // a[0], a[1] and a[2], a[3] of tiles 2q, 2q + 1
      if (BITS == 4) {
        codes_to_bf16x2<4, 4>(w0[q] & MASK, (w0[q] >> 4) & MASK, lo);
        codes_to_bf16x2<4, 4>(w1[q] & MASK, (w1[q] >> 4) & MASK, hi);
      } else {
        const uint32_t w = s == 0 ? w0[q] : w1[q];
        codes_to_bf16x2<2, 4>(w & MASK, (w >> 2) & MASK, lo);
        codes_to_bf16x2<2, 4>((w >> 4) & MASK, (w >> 6) & MASK, hi);
      }
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(acc[2 * q][nt], a0, b[nt][2 * s], b[nt][2 * s + 1]);
        mma_bf16(acc[2 * q + 1][nt], a1, b[nt][2 * s], b[nt][2 * s + 1]);
      }
    }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Four fp32 partial sums at p (`left` of them inside N), read from L2.
__device__ __forceinline__ float4 gv_ld4(const float* p, int left, bool vec) {
  if (vec && left >= 4) return __ldcg(reinterpret_cast<const float4*>(p));
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int e = 0; e < 4 && e < left; ++e) v[e] = __ldcg(p + e);
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void gv_st4(float* p, float4 s, int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = s;
    return;
  }
  const float v[4] = {s.x, s.y, s.z, s.w};
  for (int e = 0; e < 4 && e < left; ++e) p[e] = v[e];
}

// Four outputs times their scales; one 8- or 16-byte store where all four
// lie inside N and N % 4 == 0 (vec), so that the store is aligned.
template <typename XT>
__device__ __forceinline__ void gv_out(XT* p, const float (&scale)[4],
                                       float4 s, int left, bool vec) {
  const float v[4] = {s.x * scale[0], s.y * scale[1], s.z * scale[2],
                      s.w * scale[3]};
  if (vec && left >= 4) {
    if constexpr (sizeof(XT) == 2) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(p) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                     *reinterpret_cast<const uint32_t*>(&b));
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < left) p[e] = repro::from_f32<XT>(v[e]);
}

// Block (tile, slice) computes channels 128 tile .. + 127 over the K steps
// [slice * per_slice, + per_slice) of 8 packed rows each.  Warp w takes
// steps w, w + 8, ...; GV_DEPTH of them in flight in registers.  The warps'
// sums add in warp order through shared memory.  With one slice the block
// scales and stores; otherwise it writes its sum to ws[slice], and the last
// block of the tile to arrive (counters[tile]) adds ws[0], ws[1], ... in
// slice order, scales, stores and sets the counter back to 0.
template <int BITS, int NT, typename XT, bool V16>
__global__ void __launch_bounds__(GV_THREADS, 3 - NT)
    qmm_gemv(const XT* __restrict__ x, const uint8_t* __restrict__ wp,
             const float* __restrict__ scale, XT* __restrict__ out,
             float* __restrict__ ws, unsigned int* __restrict__ counters,
             int M, int N, int K, int per_slice, int wvec, int x16) {
  using G = Gv<BITS>;
  extern __shared__ __align__(16) uint8_t gv_smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(gv_smem);  // x, bf16 pairs
  float* red = reinterpret_cast<float*>(gv_smem);        // after the K loop
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, slice = blockIdx.y, slices = gridDim.y;
  const int kp = K / G::PACK;
  const int s0 = slice * per_slice;
  const int s1 = min(s0 + per_slice, (kp + GV_ROWS - 1) / GV_ROWS);
  const int n_lane = tile * GV_CH + 16 * g;
  const int mine =
      s1 - s0 > warp ? (s1 - s0 - warp + GV_WARPS - 1) / GV_WARPS : 0;

  // the codes of the warp's first K steps go out first
  uint4 buf[GV_DEPTH][2];
#pragma unroll
  for (int d = 0; d < GV_DEPTH; ++d) {
    const int row = d < mine ? (s0 + warp + d * GV_WARPS) * GV_ROWS + t : kp;
    buf[d][0] = gv_load<V16>(wp, row, kp, n_lane, N, wvec);
    buf[d][1] = gv_load<V16>(wp, row + 4, kp, n_lane, N, wvec);
  }

  // the scales of the four channels this thread stores (every item it
  // takes below has channels 16 g + 4 c .., c = warp % 4), so that the
  // epilogue waits on nothing but the sums
  const int n4 = tile * GV_CH + 16 * g + 4 * (warp & 3);
  float sc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = n4 + e < N ? __ldg(scale + n4 + e) : 0.f;

  // then the slice's x, token m's row at xs + m * rsw words: bf16 x by
  // 16-byte cp.async where K % 8 == 0 and x is aligned (x16), zero past M
  // and K; otherwise pairs rounded to bf16 (to nearest even) in registers
  const int kx = max(s1 - s0, 0) * G::KC, k0 = s0 * G::KC;
  const int rsw = per_slice * G::KC / 2 + G::PAD;
  if (x16) {
    const int chunks = kx / 8;
    for (int idx = tid; idx < NT * 8 * chunks; idx += GV_THREADS) {
      const int m = idx / chunks, c = idx - m * chunks;
      const int k = k0 + 8 * c;
      const bool ok = m < M && k < K;
      cp_async16(smem_addr(xs + m * rsw + 4 * c),
                 ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    const int pairs = kx / 2;
    for (int idx = tid; idx < NT * 8 * pairs; idx += GV_THREADS) {
      const int m = idx / pairs, p = idx - m * pairs;
      const int k = k0 + 2 * p;
      float a = 0.f, b = 0.f;
      if (m < M && k < K) {  // K is even
        const XT* src = x + static_cast<size_t>(m) * K + k;
        a = repro::to_f32(src[0]);
        b = repro::to_f32(src[1]);
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      xs[m * rsw + p] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  __syncthreads();

  float acc[8][NT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  const uint32_t* xg = xs + g * rsw + (BITS == 4 ? t : 2 * t);
  for (int c = 0; c < mine; c += GV_DEPTH) {
#pragma unroll
    for (int d = 0; d < GV_DEPTH; ++d) {
      const int i = c + d;
      if (i < mine) {
        const uint4 v0 = buf[d][0], v1 = buf[d][1];
        const int j = warp + i * GV_WARPS;  // the slice's K step
        if (i + GV_DEPTH < mine) {  // refill before this step's math
          const int row = (s0 + j + GV_DEPTH * GV_WARPS) * GV_ROWS + t;
          buf[d][0] = gv_load<V16>(wp, row, kp, n_lane, N, wvec);
          buf[d][1] = gv_load<V16>(wp, row + 4, kp, n_lane, N, wvec);
        }
        gv_step<BITS, NT>(acc, v0, v1, xg + j * (G::KC / 2), rsw);
      }
    }
  }
  __syncthreads();  // xs is free

  // lane (g, t) holds channels 16 g .. + 15 at tokens 8 nt + 2 t + e: tile
  // i's row g is channel 16 g + 2 i, its row g + 8 channel 16 g + 2 i + 1.
  // Item (nt, e, c, lane) -- channels 16 g + 4 c .. + 3 of token
  // 8 nt + 2 t + e -- goes to float4 slot ((nt * 2 + e) * 4 + c) * 32 + lane
  // of the warp's rows: the lanes of a store, and the threads of a load
  // below, touch consecutive slots, so no bank is hit twice
  constexpr int ITEMS = NT * 8 * (GV_CH / 4);  // float4s a warp
  float4* red4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red4[warp * ITEMS + ((nt * 2 + e) * 4 + c) * 32 + lane] =
            make_float4(acc[2 * c][nt][e], acc[2 * c][nt][2 + e],
                        acc[2 * c + 1][nt][e], acc[2 * c + 1][nt][2 + e]);
  __syncthreads();

  // thread tid adds item tid (and tid + 256), over the warps in order
  const bool vec = N % 4 == 0;
  for (int idx = tid; idx < ITEMS; idx += GV_THREADS) {
    const int m = (idx >> 8) * 8 + 2 * (lane & 3) + ((idx >> 7) & 1);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < GV_WARPS; ++w) s = add4(s, red4[w * ITEMS + idx]);
    if (m >= M || n4 >= N) continue;
    if (slices == 1)
      gv_out(out + static_cast<size_t>(m) * N + n4, sc, s, N - n4, vec);
    else
      gv_st4(ws + (static_cast<size_t>(slice) * M + m) * N + n4, s, N - n4,
             vec);
  }
  if (slices == 1) return;

  // the block's writes, ordered by the barrier, are released by thread 0's
  // add; the last block's add acquires every other block's
  __syncthreads();
  if (tid == 0)
    last = repro::arrive(counters + tile) == static_cast<unsigned int>(slices - 1);
  __syncthreads();
  if (!last) return;
  for (int idx = tid; idx < ITEMS; idx += GV_THREADS) {
    const int m = (idx >> 8) * 8 + 2 * (lane & 3) + ((idx >> 7) & 1);
    const int n = n4;
    if (m >= M || n >= N) continue;
    // sixteen slices' loads in flight at a time, added in slice order
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s16 = 0; s16 < slices; s16 += 16) {
      float4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (s16 + u < slices)
          v[u] = gv_ld4(ws + (static_cast<size_t>(s16 + u) * M + m) * N + n,
                        N - n, vec);
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (s16 + u < slices) s = add4(s, v[u]);
    }
    gv_out(out + static_cast<size_t>(m) * N + n, sc, s, N - n, vec);
  }
  if (tid == 0) counters[tile] = 0u;
}

template <int BITS, int NT, typename XT>
int launch_gemv(const void* x, const void* wp, const void* scale, void* out,
                void* ws, void* counters, int M, int N, int K, int slices,
                int per_slice, cudaStream_t st) {
  // the warps' sums; the slice's x (8 NT rows of per_slice * KC / 2 + PAD
  // words, per_slice * KC <= GV_SLICE_K) fits in the same bytes
  constexpr int SMEM = GV_WARPS * NT * 8 * GV_CH * 4;  // 32 KB a token tile
  static_assert(8 * NT * (GV_SLICE_K / 2 + 8) * 4 <= SMEM, "x fits");
  if (SMEM > 48 * 1024) {
    for (auto f : {qmm_gemv<BITS, NT, XT, true>, qmm_gemv<BITS, NT, XT, false>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          f, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wp);
  const int wvec = (N % 16 == 0 && wa % 16 == 0) ? 16 : (N % 4 == 0 ? 4 : 1);
  const int x16 = sizeof(XT) == 2 && K % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((N + GV_CH - 1) / GV_CH, slices);
  auto kernel = wvec == 16 ? qmm_gemv<BITS, NT, XT, true>
                           : qmm_gemv<BITS, NT, XT, false>;
  kernel<<<grid, GV_THREADS, SMEM, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scale), static_cast<XT*>(out),
      static_cast<float*>(ws), static_cast<unsigned int*>(counters), M, N, K,
      per_slice, wvec, x16);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename XT>
int launch_gemv_m(const void* x, const void* wp, const void* scale, void* out,
                  void* ws, void* counters, int M, int N, int K, int slices,
                  int per_slice, cudaStream_t st) {
  if (M <= 8)
    return launch_gemv<BITS, 1, XT>(x, wp, scale, out, ws, counters, M, N, K,
                                    slices, per_slice, st);
  return launch_gemv<BITS, 2, XT>(x, wp, scale, out, ws, counters, M, N, K,
                                  slices, per_slice, st);
}

}  // namespace

// wp: (K / (8 / bits), N) uint8; scale: (N,) float32; out: (M, N) in
// out_dtype.  K must be a multiple of the pack factor.  x: (M, K) row-major
// in x_dtype.  The caller picks the kernel by shape (cuda.py's
// quant_matmul_route); each launch checks what its kernel needs:
//   kGemv    M <= 16, x in the output's dtype; the K plan (cuda.py's
//            gemv_plan): `slices` slices of `per_slice` K steps of 8 packed
//            rows, covering K, each K <= 1024; with slices > 1 an fp32
//            workspace ws (slices, M, N) and ceil(N / 128) counters, zero
//            on entry and left zero;
//   kMmaSync bf16 x, 4-byte aligned;
//   kWgmma   bf16 x, K % 8 == 0 and N % 16 == 0 (TMA's 16-byte row
//            strides), 16-byte aligned x and wp.
// The tiled routes ignore ws, counters, slices and per_slice.
enum Route { kGemv = 0, kMmaSync = 1, kWgmma = 2 };

extern "C" int quant_matmul_launch(const void* x, const void* wp,
                                   const void* scale, void* out, int M, int N,
                                   int K, int bits, int x_dtype, int out_dtype,
                                   int route, void* ws, void* counters,
                                   int slices, int per_slice, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = out_dtype == repro::kBFloat16;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wp);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((bits != 4 && bits != 2) || (!bf && out_dtype != repro::kFloat32))
    return bad;
  if (route == kGemv) {
    const int steps = (K / (8 / bits) + GV_ROWS - 1) / GV_ROWS;
    const int kslice = per_slice * (bits == 4 ? Gv<4>::KC : Gv<2>::KC);
    if (M > 16 || x_dtype != out_dtype || slices < 1 || per_slice < 1 ||
        kslice > GV_SLICE_K ||
        static_cast<long long>(slices) * per_slice < steps ||
        (slices > 1 && (ws == nullptr || counters == nullptr)))
      return bad;
    if (bits == 4)
      return bf ? launch_gemv_m<4, __nv_bfloat16>(x, wp, scale, out, ws,
                                                   counters, M, N, K, slices,
                                                   per_slice, st)
                : launch_gemv_m<4, float>(x, wp, scale, out, ws, counters, M,
                                          N, K, slices, per_slice, st);
    return bf ? launch_gemv_m<2, __nv_bfloat16>(x, wp, scale, out, ws,
                                                 counters, M, N, K, slices,
                                                 per_slice, st)
              : launch_gemv_m<2, float>(x, wp, scale, out, ws, counters, M, N,
                                        K, slices, per_slice, st);
  }
  if (x_dtype != repro::kBFloat16 || xa % 4 != 0) return bad;
  if (route == kWgmma) {
    if (K <= 0 || K % 8 != 0 || N % 16 != 0 || xa % 16 != 0 || wa % 16 != 0)
      return bad;
    if (bits == 4)
      return bf ? launch_wg<4, __nv_bfloat16>(x, wp, scale, out, M, N, K, st)
                : launch_wg<4, float>(x, wp, scale, out, M, N, K, st);
    return bf ? launch_wg<2, __nv_bfloat16>(x, wp, scale, out, M, N, K, st)
              : launch_wg<2, float>(x, wp, scale, out, M, N, K, st);
  }
  if (route != kMmaSync) return bad;
  if (bits == 4)
    return bf ? launch_tc<4, __nv_bfloat16>(x, wp, scale, out, M, N, K, st)
              : launch_tc<4, float>(x, wp, scale, out, M, N, K, st);
  return bf ? launch_tc<2, __nv_bfloat16>(x, wp, scale, out, M, N, K, st)
            : launch_tc<2, float>(x, wp, scale, out, M, N, K, st);
}
