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
// (20 us at 3.35 TB/s): bytes, narrowly.  Design: one block per
// (64-query tile, h, b), four warps of 16 query rows each.  K/V tiles of 64
// rows stream through shared memory, only up to the causal diagonal; the
// score and P.V products run on bf16 tensor cores (WMMA m16n16k16, fp32
// accumulate).  P enters the second product as three bf16 terms, p_hi =
// bf16(p), p_mid = bf16(p - p_hi) and p_lo = bf16(p - p_hi - p_mid), so
// P.V keeps all 24 bits of the fp32 P rather than bf16's 8: the serving
// path's plain version (chunked_attention) keeps P in fp32, and every bit
// dropped here moves more bf16 outputs off the plain version's rounding,
// which the next projection's activation fake-quant turns into whole code
// steps.  p_mid and p_lo of a warp's 16 rows live in that warp's own
// (already consumed) score rows.
// The fp32 output accumulator lives in shared memory so that it can be
// rescaled row by row.  Ragged S is masked in the
// kernel (zero-filled tiles, -1e30 scores), so no divisibility is needed.
// Inputs take arbitrary batch/head/sequence strides (D contiguous), so the
// model passes (B, S, H, D) activations as (B, H, S, D) views without a copy.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int FQ = 64, FK = 64, F_THREADS = 128;
constexpr float NEG_INF = -1e30f;
typedef __nv_bfloat16 bf16;

template <int D>
struct Layout {
  static constexpr int QLD = D + 8;   // bf16 rows of Q, K, V tiles
  static constexpr int SLD = FK + 4;  // f32 scores
  static constexpr int PLD = FK + 8;  // bf16 probabilities
  static constexpr int OLD = D + 4;   // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + FQ * QLD * sizeof(bf16);
  static constexpr size_t v_off = k_off + FK * QLD * sizeof(bf16);
  static constexpr size_t s_off = v_off + FK * QLD * sizeof(bf16);
  static constexpr size_t p_off = s_off + FQ * SLD * sizeof(float);
  static constexpr size_t o_off = p_off + FQ * PLD * sizeof(bf16);
  static constexpr size_t bytes = o_off + FQ * OLD * sizeof(float);
};

// rows [r0, r0 + 64) of a (S, D) slab with row stride `ss`; zero past S
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int S) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += F_THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::QLD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
    flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Hkv,
              int S, long long qsb, long long qsh, long long qss, long long ksb,
              long long ksh, long long kss, long long vsb, long long vsh,
              long long vss, long long osb, long long osh, long long oss,
              int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = qt * FQ;
  // p_mid and p_lo of this warp's rows (16 x FK each, 32-byte aligned),
  // over its own 16 score rows
  bf16* Pm = reinterpret_cast<bf16*>(smem + L::s_off + (warp * 16) * L::SLD * sizeof(float));
  bf16* Pl = Pm + 16 * FK;
  static_assert(2 * 16 * FK * sizeof(bf16) <= 16 * L::SLD * sizeof(float),
                "p_mid and p_lo must fit in a warp's score rows");
  const bf16* kp = k + b * ksb + hk * ksh;
  const bf16* vp = v + b * vsb + hk * vsh;

  load_tile<D>(Qs, q + b * qsb + h * qsh, qss, q0, S);
  for (int idx = threadIdx.x; idx < FQ * L::OLD; idx += F_THREADS) Os[idx] = 0.f;

  // each lane pair owns one query row; each lane half of its columns
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qi = q0 + row;
  float m_run = NEG_INF, l_run = 0.f;
  const int n_kv = (S + FK - 1) / FK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;  // FQ == FK

  for (int j = 0; j < kv_end; ++j) {
    const int k0 = j * FK;
    __syncthreads();  // all warps are done reading the previous K/V tile
    load_tile<D>(Ks, kp, kss, k0, S);
    load_tile<D>(Vs, vp, vss, k0, S);
    __syncthreads();

    {  // scores of this warp's 16 rows: Q (16 x D) . K^T (D x 64)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[FK / 16];
#pragma unroll
      for (int n = 0; n < FK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + (warp * 16) * L::QLD + kk, L::QLD);
#pragma unroll
        for (int n = 0; n < FK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + (n * 16) * L::QLD + kk, L::QLD);
          wmma::mma_sync(sf[n], a, kb, sf[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < FK / 16; ++n)
        wmma::store_matrix_sync(Ss + (warp * 16) * L::SLD + n * 16, sf[n], L::SLD,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this lane's 32 columns of its row
    const float* srow = Ss + row * L::SLD + half * 32;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kj = k0 + half * 32 + c;
      const bool live = kj < S && (!causal || kj <= qi);
      sv[c] = live ? srow[c] * scale : NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    __syncwarp();  // the warp's score rows are in registers: reuse them
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
    bf16* prow = Ps + row * L::PLD + half * 32;
    bf16* pmrow = Pm + (lane >> 1) * FK + half * 32;
    bf16* plrow = Pl + (lane >> 1) * FK + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      psum += p;
      // both differences are exact in fp32
      const bf16 hi = __float2bfloat16_rn(p);
      const float rest = p - __bfloat162float(hi);
      const bf16 mid = __float2bfloat16_rn(rest);
      prow[c] = hi;
      pmrow[c] = mid;
      plrow[c] = __float2bfloat16_rn(rest - __bfloat162float(mid));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    float* orow = Os + row * L::OLD + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O (16 x D) += (P_hi + P_mid + P_lo) (16 x 64) . V (64 x D), the
    // smallest term first
#pragma unroll
    for (int dn = 0; dn < D; dn += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + (warp * 16) * L::OLD + dn, L::OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa, pm, pl;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + (warp * 16) * L::PLD + kk, L::PLD);
        wmma::load_matrix_sync(pm, Pm + kk, FK);
        wmma::load_matrix_sync(pl, Pl + kk, FK);
        wmma::load_matrix_sync(vb, Vs + kk * L::QLD + dn, L::QLD);
        wmma::mma_sync(of, pl, vb, of);
        wmma::mma_sync(of, pm, vb, of);
        wmma::mma_sync(of, pa, vb, of);
      }
      wmma::store_matrix_sync(Os + (warp * 16) * L::OLD + dn, of, L::OLD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qi < S) {
    const float den = fmaxf(l_run, 1e-30f);
    const float* orow = Os + row * L::OLD + half * (D / 2);
    bf16* op = o + b * osb + h * osh + qi * oss + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16_rn(orow[c + e] / den);
      *reinterpret_cast<uint4*>(op + c) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FQ - 1) / FQ, H, B);
  flash_fwd<D><<<grid, F_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Hkv, S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, H, S, D) bf16 views; k, v: (B, Hkv, S, D) bf16 views.  D is
// contiguous; `strides` holds 12 element strides: (batch, head, seq) for
// q, k, v, o in turn, each a multiple of 8, with 16-byte aligned bases.
// D is 64 or 128.
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
