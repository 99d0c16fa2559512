// Decode attention (one query token per request) over an int8 or packed-int4
// quantized KV cache, dequantizing in registers:
//   k[s, d] = code * k_scale[b, hk, d]   (per channel)
//   v[s, d] = code * v_scale[b, s, hk]   (per token)
//   out[b, h] = softmax_{s <= positions[b]}(q . k[s] * D^-0.5) @ v
// GQA maps query head h to KV head h / (H / Hkv).  Output (B, H, D) f32.
// int4 codes are packed D-major: byte j of a row holds channels 2j (low
// nibble) and 2j+1 (high nibble), unlike the K-major weights.
//
// Replaces: src/repro/kernels/flash_attention.py::kv_decode_attention
// (_kv_decode_kernel).
// Plain version: repro_torch/kernels/ref.py::kv_cache_attention.
//
// Bound on the H100: bytes.  At B = 8, H = Hkv = 16, D = 128, S = 1024 the
// int8 cache is 2 x 16.8 MB per layer against ~67 MFLOP.  Design: one
// block per (b, h); the loop stops at min(positions[b], S - 1), so bytes
// past a request's position are never read (an inactive slot is pinned at
// max_seq and reads the whole row, like the reference).  Each of the 8
// warps owns every 8th token and keeps its own fp32 running max, sum and
// accumulator (lane = D/32 channels, so one row read is one coalesced
// 32-lane access); 4 tokens per iteration are loaded before use to keep
// loads in flight.  The warps' states merge at the end in shared memory.
// Masked tokens are skipped rather than weighted by exp(-1e30 - m) = 0,
// which is the same sum; the -1e30 initial max and max(l, 1e-30) guard are
// the oracle's.
#include "common.cuh"

namespace {

constexpr int KV_WARPS = 8;
constexpr int KV_UNROLL = 4;
constexpr float NEG_INF = -1e30f;

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

template <int BITS, int D, typename QT>
__global__ void __launch_bounds__(KV_WARPS * 32)
    kv_decode_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kq,
                     const float* __restrict__ k_scale,
                     const uint8_t* __restrict__ vq,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ positions, float* __restrict__ out,
                     int H, int S, int Hkv, float scale) {
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
  const int last = min(positions[b], S - 1);
  const size_t row = static_cast<size_t>(Hkv) * DP;  // bytes between tokens
  const size_t head0 = (static_cast<size_t>(b) * S * Hkv + hk) * DP + lane * BPL;
  const uint8_t* kbase = kq + head0;
  const uint8_t* vbase = vq + head0;
  const float* vsbase = v_scale + static_cast<size_t>(b) * S * Hkv + hk;

  float m = NEG_INF, l = 0.f;
  for (int s0 = warp; s0 <= last; s0 += KV_WARPS * KV_UNROLL) {
    uint32_t kw[KV_UNROLL], vw[KV_UNROLL];
    float vs[KV_UNROLL];
#pragma unroll
    for (int u = 0; u < KV_UNROLL; ++u) {
      const int s = s0 + u * KV_WARPS;
      const bool ok = s <= last;
      kw[u] = ok ? load_bytes<BPL>(kbase + s * row) : 0u;
      vw[u] = ok ? load_bytes<BPL>(vbase + s * row) : 0u;
      vs[u] = ok ? __ldg(vsbase + static_cast<size_t>(s) * Hkv) : 0.f;
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

template <int BITS, int D>
void launch(const void* q, int q_dtype, const void* kq, const void* k_scale,
            const void* vq, const void* v_scale, const void* positions,
            void* out, int B, int H, int S, int Hkv, float scale,
            cudaStream_t st) {
  const dim3 grid(H, B);
  const uint8_t* k = static_cast<const uint8_t*>(kq);
  const uint8_t* v = static_cast<const uint8_t*>(vq);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pos = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  if (q_dtype == repro::kBFloat16)
    kv_decode_kernel<BITS, D, __nv_bfloat16><<<grid, KV_WARPS * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), k, ks, v, vs, pos, o, H, S, Hkv, scale);
  else
    kv_decode_kernel<BITS, D, float><<<grid, KV_WARPS * 32, 0, st>>>(
        static_cast<const float*>(q), k, ks, v, vs, pos, o, H, S, Hkv, scale);
}

}  // namespace

// q: (B, H, D) f32 or bf16; kq/vq: (B, S, Hkv, D) int8 or (B, S, Hkv, D/2)
// uint8; k_scale: (B, Hkv, D) f32; v_scale: (B, S, Hkv) f32; positions:
// (B,) int32, each >= 0; out: (B, H, D) f32.  D is 64 or 128.
extern "C" int kv_decode_attention_launch(
    const void* q, int q_dtype, const void* kq, const void* k_scale,
    const void* vq, const void* v_scale, const void* positions, void* out,
    int B, int H, int S, int Hkv, int D, int bits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype != repro::kBFloat16 && q_dtype != repro::kFloat32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8 && D == 128)
    launch<8, 128>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, S, Hkv, scale, st);
  else if (bits == 4 && D == 128)
    launch<4, 128>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, S, Hkv, scale, st);
  else if (bits == 8 && D == 64)
    launch<8, 64>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, S, Hkv, scale, st);
  else if (bits == 4 && D == 64)
    launch<4, 64>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, B, H, S, Hkv, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
