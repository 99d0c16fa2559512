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
//  * Decode (M <= 16) is bound by the bytes of the packed codes: at M = 8,
//    K = 2048, N = 8192, int4 moves 8.4 MB of codes against 0.27 GFLOP.
//    qmm_gemv streams them once: a block owns 32 output columns; each warp
//    reads 4 row groups x 32 contiguous bytes (8 lanes x 4 bytes, so
//    neighbouring N are neighbouring bytes and reads coalesce along N),
//    unpacks in registers and keeps M x 4 fp32 accumulators per thread.
//    The 32 row groups of a block split K; x is staged in shared memory as
//    bf16 (the values the Pallas kernel feeds its MXU), and the partial sums
//    reduce through warp shuffles and shared memory in a fixed order.
//  * Prefill (M = tokens, here 4096) is bound by operations:
//    2 * 4096 * 2048 * 8192 = 137 GFLOP for the gate projection.
//    qmm_tiled runs bf16 tensor cores (WMMA m16n16k16, fp32 accumulate)
//    on 64 x 64 output tiles; each K step unpacks a 64 x 64 tile of codes
//    to bf16 in shared memory.  No TMA, wgmma or pipelining yet.
// Ragged M, N and K are masked in the kernels (zero-filled tiles), so the
// wrapper pads K only to the pack multiple.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int GV_THREADS = 256;  // 8 warps x 4 row groups of 8 lanes
constexpr int GV_COLS = 32;      // output columns per block: 8 lanes x 4 bytes
constexpr int GV_GROUPS = 32;    // row groups per block
constexpr int GV_KC = 1024;      // K elements of x staged per pass

template <int BITS, int MT, typename XT>
__global__ void __launch_bounds__(GV_THREADS)
    qmm_gemv(const XT* __restrict__ x, const uint8_t* __restrict__ wp,
             const float* __restrict__ scale, XT* __restrict__ out, int M,
             int N, int K) {
  constexpr int PACK = 8 / BITS;
  constexpr int RPT = GV_KC / PACK / GV_GROUPS;  // packed rows/thread/pass
  // x chunk as bf16 (MT x GV_KC); reused for the cross-warp reduction
  // (8 x MT x GV_COLS floats, half the size) after the K loop.
  __shared__ __align__(16) unsigned char smem[MT * GV_KC * 2];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp * 4 + (lane >> 3);
  const int n0 = blockIdx.x * GV_COLS + (lane & 7) * 4;
  const int kp = K / PACK;
  const bool vec = (N % 4 == 0) && (n0 + 3 < N);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int kc = 0; kc < K; kc += GV_KC) {
    // issue this pass's weight loads first; they overlap the x staging
    uint32_t wv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = kc / PACK + grp + GV_GROUPS * i;
      uint32_t w = 0u;
      if (r < kp) {
        const uint8_t* p = wp + static_cast<size_t>(r) * N + n0;
        if (vec) {
          w = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          for (int c = 0; c < 4; ++c)
            if (n0 + c < N) w |= static_cast<uint32_t>(__ldg(p + c)) << (8 * c);
        }
      }
      wv[i] = w;
    }
    for (int idx = tid; idx < MT * GV_KC; idx += GV_THREADS) {
      const int m = idx / GV_KC, k = kc + idx % GV_KC;
      const float v = (m < M && k < K)
                          ? repro::to_f32(x[static_cast<size_t>(m) * K + k])
                          : 0.f;
      xs[idx] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int kl = (grp + GV_GROUPS * i) * PACK;
#pragma unroll
      for (int j = 0; j < PACK; ++j) {
        float code[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          code[c] = static_cast<float>(repro::sext<BITS>(wv[i] >> (8 * c + BITS * j)));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = __bfloat162float(xs[m * GV_KC + kl + j]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, code[c], acc[m][c]);
        }
      }
    }
    __syncthreads();
  }

  // the four row groups of a warp hold the same columns: lanes l ^ 8, l ^ 16
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  float* red = reinterpret_cast<float*>(smem);  // [8 warps][MT][GV_COLS]
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * MT + m) * GV_COLS + lane * 4 + c] = acc[m][c];
  }
  __syncthreads();
  for (int idx = tid; idx < MT * GV_COLS; idx += GV_THREADS) {
    const int m = idx / GV_COLS, col = idx % GV_COLS;
    const int n = blockIdx.x * GV_COLS + col;
    if (m < M && n < N) {
      float s = 0.f;
      for (int w = 0; w < GV_THREADS / 32; ++w) s += red[(w * MT + m) * GV_COLS + col];
      out[static_cast<size_t>(m) * N + n] = repro::from_f32<XT>(s * scale[n]);
    }
  }
}

constexpr int TM = 64, TN = 64, TK = 64, T_THREADS = 128;
constexpr int ALD = TK + 8;  // bf16 leading dims: multiples of 8 (WMMA rule)
constexpr int BLD = TN + 8;
constexpr int CLD = TN + 4;  // float leading dim: multiple of 4

template <int BITS, typename XT>
__global__ void __launch_bounds__(T_THREADS)
    qmm_tiled(const XT* __restrict__ x, const uint8_t* __restrict__ wp,
              const float* __restrict__ scale, XT* __restrict__ out, int M,
              int N, int K) {
  constexpr int PACK = 8 / BITS;
  __shared__ __align__(128) __nv_bfloat16 As[TM * ALD];
  __shared__ __align__(128) __nv_bfloat16 Bs[TK * BLD];
  __shared__ __align__(128) float Cs[TM * CLD];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kp = K / PACK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int idx = tid; idx < TM * TK; idx += T_THREADS) {
      const int r = idx / TK, c = idx % TK, m = m0 + r, k = k0 + c;
      const float v = (m < M && k < K)
                          ? repro::to_f32(x[static_cast<size_t>(m) * K + k])
                          : 0.f;
      As[r * ALD + c] = __float2bfloat16_rn(v);
    }
    for (int idx = tid; idx < (TK / PACK) * TN; idx += T_THREADS) {
      const int pr = idx / TN, c = idx % TN;
      const int r = k0 / PACK + pr, n = n0 + c;
      const uint32_t byte = (r < kp && n < N) ? wp[static_cast<size_t>(r) * N + n] : 0u;
#pragma unroll
      for (int j = 0; j < PACK; ++j)
        Bs[(pr * PACK + j) * BLD + c] =
            __float2bfloat16_rn(static_cast<float>(repro::sext<BITS>(byte >> (BITS * j))));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * ALD + kk, ALD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * BLD + wn * 32 + j * 16, BLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * CLD + wn * 32 + j * 16,
                              acc[i][j], CLD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < TM * TN; idx += T_THREADS) {
    const int r = idx / TN, c = idx % TN, m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      out[static_cast<size_t>(m) * N + n] = repro::from_f32<XT>(Cs[r * CLD + c] * scale[n]);
  }
}

template <int BITS, typename XT>
void launch(const void* x, const void* wp, const void* scale, void* out, int M,
            int N, int K, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  const float* s = static_cast<const float*>(scale);
  XT* o = static_cast<XT*>(out);
  if (M <= 16) {
    const dim3 grid((N + GV_COLS - 1) / GV_COLS);
    if (M <= 1)
      qmm_gemv<BITS, 1, XT><<<grid, GV_THREADS, 0, st>>>(xp, w, s, o, M, N, K);
    else if (M <= 2)
      qmm_gemv<BITS, 2, XT><<<grid, GV_THREADS, 0, st>>>(xp, w, s, o, M, N, K);
    else if (M <= 4)
      qmm_gemv<BITS, 4, XT><<<grid, GV_THREADS, 0, st>>>(xp, w, s, o, M, N, K);
    else if (M <= 8)
      qmm_gemv<BITS, 8, XT><<<grid, GV_THREADS, 0, st>>>(xp, w, s, o, M, N, K);
    else
      qmm_gemv<BITS, 16, XT><<<grid, GV_THREADS, 0, st>>>(xp, w, s, o, M, N, K);
  } else {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    qmm_tiled<BITS, XT><<<grid, T_THREADS, 0, st>>>(xp, w, s, o, M, N, K);
  }
}

}  // namespace

// x: (M, K) row-major in `dtype`; wp: (K / (8 / bits), N) uint8; scale: (N,)
// float32; out: (M, N) in `dtype`.  K must be a multiple of the pack factor.
extern "C" int quant_matmul_launch(const void* x, const void* wp,
                                   const void* scale, void* out, int M, int N,
                                   int K, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4 && dtype == repro::kBFloat16)
    launch<4, __nv_bfloat16>(x, wp, scale, out, M, N, K, st);
  else if (bits == 2 && dtype == repro::kBFloat16)
    launch<2, __nv_bfloat16>(x, wp, scale, out, M, N, K, st);
  else if (bits == 4 && dtype == repro::kFloat32)
    launch<4, float>(x, wp, scale, out, M, N, K, st);
  else if (bits == 2 && dtype == repro::kFloat32)
    launch<2, float>(x, wp, scale, out, M, N, K, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
