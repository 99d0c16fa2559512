// Decode attention (one query token per request) over an int8 or packed-int4
// quantized KV cache, dequantizing in registers:
//   k[s, d] = code * k_scale[b, hk, d]   (per channel)
//   v[s, d] = code * v_scale[row(s), hk] (per token)
//   out[b, h] = softmax_{s <= positions[b]}(q . k[s] * D^-0.5) @ v
// GQA maps query head h to KV head h / (H / Hkv).  Output (B, H, D) f32.
// int4 codes are packed D-major: byte j of a row holds channels 2j (low
// nibble) and 2j+1 (high nibble), unlike the K-major weights.
//
// Two cache layouts share one kernel body; a row policy maps logical row s
// of slot b to a row of the code buffers (rows, Hkv, D or D/2) and the V
// scales (rows, Hkv):
//   contiguous  (B, S, ...) buffers: row b * S + s; the loop stops at
//               min(position, S - 1).
//   paged       (P, page, ...) pools through a (B, n) block table: row
//               tbl[b, s / page] * page + s % page, the table entry clamped
//               to [0, P - 1]; the loop stops at min(position, n * page - 1).
// Everything else (token assignment, unroll, merge) is the same code, so
// on the same data the paged kernel equals the contiguous kernel on the
// gathered cache bit for bit.  No row past a slot's position is read, so a
// free page's contents (even NaN) cannot reach the output.
//
// Replaces: src/repro/kernels/flash_attention.py::kv_decode_attention
// (_kv_decode_kernel) and ::paged_kv_decode_attention
// (_paged_kv_decode_kernel).
// Plain versions: repro_torch/kernels/ref.py::kv_cache_attention and
// ::paged_kv_cache_attention.
//
// Bound on the H100: bytes.  At B = 8, H = Hkv = 16, D = 128, S = 1024 the
// int8 cache is 2 x 16.8 MB per layer against ~67 MFLOP.  Design: one
// block per (b, h); the loop stops at the slot's last row, so bytes past a
// request's position are never read (an inactive slot is pinned at
// max_seq and reads the whole row, like the reference).  Each of the 8
// warps owns every 8th token and keeps its own fp32 running max, sum and
// accumulator (lane = D/32 channels, so one row read is one coalesced
// 32-lane access); 4 tokens per iteration are loaded before use to keep
// loads in flight.  The warps' states merge at the end in shared memory.
// Masked tokens are skipped rather than weighted by exp(-1e30 - m) = 0,
// which is the same sum; the -1e30 initial max and max(l, 1e-30) guard are
// the oracle's.  The paged kernel first stages the slot's table entries in
// shared memory, so a row's address waits on a shared-memory load rather
// than on a second global one.
#include "common.cuh"

namespace {

constexpr int KV_WARPS = 8;
constexpr int KV_UNROLL = 4;
constexpr float NEG_INF = -1e30f;
constexpr int PAGED_MAX_ENTRIES = 8192;  // 32 KB staged + 4 KB static < 48 KB

template <int NB>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p);
template <>
__device__ __forceinline__ uint32_t load_bytes<1>(const uint8_t* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ uint32_t load_bytes<2>(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint16_t*>(p));
}
template <>
__device__ __forceinline__ uint32_t load_bytes<4>(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// code of the lane's j-th channel from its loaded bytes
template <int BITS>
__device__ __forceinline__ float code_of(uint32_t w, int j) {
  if (BITS == 8) return static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xffu));
  return static_cast<float>(repro::sext<4>(w >> (4 * j)));
}

// (B, S, ...) buffers
struct ContiguousRows {
  int S;
  static size_t smem_bytes(int) { return 0; }
  __device__ __forceinline__ int last(int pos) const { return min(pos, S - 1); }
  __device__ __forceinline__ void stage(int, int, int*) {}
  __device__ __forceinline__ size_t row(int b, int s) const {
    return static_cast<size_t>(b) * S + s;
  }
};

// (P, page, ...) pools through a (B, n) block table.  The slot's entries up
// to its last page are clamped into shared memory first, so a row's
// address waits on a shared-memory load, not on a second global one.
// A power-of-two page (page_shift >= 0) splits a row index with a shift
// and a mask instead of an integer division.
struct PagedRows {
  const int* tbl;
  int n, page, P, page_shift;
  const int* pages = nullptr;  // the staged entries
  static size_t smem_bytes(int n) { return sizeof(int) * n; }
  __device__ __forceinline__ int last(int pos) const { return min(pos, n * page - 1); }
  __device__ __forceinline__ void stage(int b, int last, int* smem) {
    for (int j = threadIdx.x; j <= last / page; j += blockDim.x)
      smem[j] = min(max(__ldg(tbl + static_cast<size_t>(b) * n + j), 0), P - 1);
    pages = smem;
  }
  __device__ __forceinline__ size_t row(int, int s) const {
    const int j = page_shift >= 0 ? s >> page_shift : s / page;
    return static_cast<size_t>(pages[j]) * page + (s - j * page);
  }
};

template <int BITS, int D, typename QT, typename Rows>
__global__ void __launch_bounds__(KV_WARPS * 32)
    kv_decode_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kq,
                     const float* __restrict__ k_scale,
                     const uint8_t* __restrict__ vq,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ positions, float* __restrict__ out,
                     int H, int Hkv, float scale, Rows rows) {
  constexpr int CPL = D / 32;                     // channels per lane
  constexpr int DP = BITS == 8 ? D : D / 2;       // code bytes per row
  constexpr int BPL = BITS == 8 ? CPL : CPL / 2;  // code bytes per lane
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * CPL;

  float qv[CPL], ks[CPL], acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    qv[j] = repro::to_f32(q[(static_cast<size_t>(b) * H + h) * D + d0 + j]);
    ks[j] = k_scale[(static_cast<size_t>(b) * Hkv + hk) * D + d0 + j];
    acc[j] = 0.f;
  }
  const int last = rows.last(positions[b]);
  extern __shared__ int staged[];
  rows.stage(b, last, staged);
  __syncthreads();
  const size_t row_bytes = static_cast<size_t>(Hkv) * DP;
  const size_t head0 = static_cast<size_t>(hk) * DP + lane * BPL;
  const uint8_t* kbase = kq + head0;
  const uint8_t* vbase = vq + head0;
  const float* vsbase = v_scale + hk;

  float m = NEG_INF, l = 0.f;
  for (int s0 = warp; s0 <= last; s0 += KV_WARPS * KV_UNROLL) {
    uint32_t kw[KV_UNROLL], vw[KV_UNROLL];
    float vs[KV_UNROLL];
#pragma unroll
    for (int u = 0; u < KV_UNROLL; ++u) {
      const int s = s0 + u * KV_WARPS;
      kw[u] = vw[u] = 0u;
      vs[u] = 0.f;
      if (s <= last) {
        const size_t r = rows.row(b, s);
        kw[u] = load_bytes<BPL>(kbase + r * row_bytes);
        vw[u] = load_bytes<BPL>(vbase + r * row_bytes);
        vs[u] = __ldg(vsbase + r * Hkv);
      }
    }
    float logit[KV_UNROLL];
#pragma unroll
    for (int u = 0; u < KV_UNROLL; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) dot += qv[j] * (code_of<BITS>(kw[u], j) * ks[j]);
      logit[u] = repro::warp_sum(dot) * scale;
    }
#pragma unroll
    for (int u = 0; u < KV_UNROLL; ++u) {
      if (s0 + u * KV_WARPS > last) break;
      const float m_new = fmaxf(m, logit[u]);
      const float p = expf(logit[u] - m_new);
      const float alpha = expf(m - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        acc[j] = acc[j] * alpha + p * (code_of<BITS>(vw[u], j) * vs[u]);
      m = m_new;
    }
  }

  __shared__ float sm[KV_WARPS], sl[KV_WARPS];
  __shared__ float sacc[KV_WARPS][D];
#pragma unroll
  for (int j = 0; j < CPL; ++j) sacc[warp][d0 + j] = acc[j];
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  float mx = NEG_INF;
#pragma unroll
  for (int w = 0; w < KV_WARPS; ++w) mx = fmaxf(mx, sm[w]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < KV_WARPS; ++w) {
      const float e = expf(sm[w] - mx);
      o += sacc[w][d] * e;
      den += sl[w] * e;
    }
    out[(static_cast<size_t>(b) * H + h) * D + d] = o / fmaxf(den, 1e-30f);
  }
}

template <int BITS, int D, typename Rows>
void launch(const void* q, int q_dtype, const void* kq, const void* k_scale,
            const void* vq, const void* v_scale, const void* positions,
            void* out, int B, int H, int Hkv, float scale, Rows rows,
            int n_entries, cudaStream_t st) {
  const dim3 grid(H, B);
  const uint8_t* k = static_cast<const uint8_t*>(kq);
  const uint8_t* v = static_cast<const uint8_t*>(vq);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pos = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  const size_t smem = Rows::smem_bytes(n_entries);
  if (q_dtype == repro::kBFloat16)
    kv_decode_kernel<BITS, D, __nv_bfloat16, Rows><<<grid, KV_WARPS * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), k, ks, v, vs, pos, o, H, Hkv, scale, rows);
  else
    kv_decode_kernel<BITS, D, float, Rows><<<grid, KV_WARPS * 32, smem, st>>>(
        static_cast<const float*>(q), k, ks, v, vs, pos, o, H, Hkv, scale, rows);
}

template <typename Rows>
int dispatch(const void* q, int q_dtype, const void* kq, const void* k_scale,
             const void* vq, const void* v_scale, const void* positions,
             void* out, int B, int H, int Hkv, int D, int bits, float scale,
             Rows rows, int n_entries, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype != repro::kBFloat16 && q_dtype != repro::kFloat32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8 && D == 128)
    launch<8, 128>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, Hkv, scale, rows,
                    n_entries, st);
  else if (bits == 4 && D == 128)
    launch<4, 128>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, Hkv, scale, rows,
                    n_entries, st);
  else if (bits == 8 && D == 64)
    launch<8, 64>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, Hkv, scale, rows,
                    n_entries, st);
  else if (bits == 4 && D == 64)
    launch<4, 64>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, Hkv, scale, rows,
                    n_entries, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, D) f32 or bf16; kq/vq: (B, S, Hkv, D) int8 or (B, S, Hkv, D/2)
// uint8; k_scale: (B, Hkv, D) f32; v_scale: (B, S, Hkv) f32; positions:
// (B,) int32, each >= 0; out: (B, H, D) f32.  D is 64 or 128.
extern "C" int kv_decode_attention_launch(
    const void* q, int q_dtype, const void* kq, const void* k_scale,
    const void* vq, const void* v_scale, const void* positions, void* out,
    int B, int H, int S, int Hkv, int D, int bits, float scale, void* stream) {
  return dispatch(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, Hkv, D, bits,
                  scale, ContiguousRows{S}, 0, stream);
}

// As above over pools: kq/vq (P, page, Hkv, D or D/2); v_scale (P, page,
// Hkv) f32; tbl (B, n) int32, any entry (clamped to [0, P - 1]);
// n <= PAGED_MAX_ENTRIES (the staged row and the merge buffers fit the
// 48 KB a block gets without an opt-in).
extern "C" int paged_kv_decode_attention_launch(
    const void* q, int q_dtype, const void* kq, const void* k_scale,
    const void* vq, const void* v_scale, const void* tbl, const void* positions,
    void* out, int B, int H, int P, int page, int n, int Hkv, int D, int bits,
    float scale, void* stream) {
  if (n < 1 || n > PAGED_MAX_ENTRIES || page < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int shift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  return dispatch(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, Hkv, D, bits,
                  scale, PagedRows{static_cast<const int*>(tbl), n, page, P, shift}, n, stream);
}
