// LSQ fake-quantization forward of one input at 1 to 3 steps:
// out[k] = clip(rint(x / s_k), qmin, qmax) * s_k, s_k = max(|step_k|, 1e-9),
// computed in float32 and stored in x's dtype.  A NaN element stays NaN, as
// torch.clamp and jnp.clip keep it; +-inf clamps to qmax s / qmin s.
//
// Replaces: src/repro/kernels/lsq_fakequant.py::lsq_fakequant (_lsq_kernel).
// Plain version: repro_torch/kernels/ref.py::lsq_fakequant_grouped.
//
// Bound on the H100: bytes.  One read of x and one write of each output
// (2 + 2 NS bytes per bf16 element) against ~6 flops per element and step,
// far below the card's ~295 flops/byte balance point; at a decode step's
// 8 rows, the launch.  Design:
//  - one launch for the projections that share an input (q/k/v, gate/up):
//    x is read once, each output written once, and a layer makes 4
//    launches instead of 7;
//  - one 16-byte vector (8 bf16 or 4 float32) a thread, loaded before the
//    steps are read and stored once an output; blocks of 128 threads cover
//    n (no grid-stride loop: 8,192 blocks at 4096 x 2048 bf16, 16 at a
//    decode step's 8 x 2048).  On the H100, two or four vectors a thread
//    read no faster at the prefill shapes and slower at the decode ones,
//    and the kernel runs close to a device-to-device copy of the same
//    bytes, which chip_smoke.py times beside it.  The ragged tail
//    (n % vector width elements) goes to the last block's first threads;
//  - the steps are read from device memory (no host sync) and the
//    bit-width arrives as an integer, so one build serves every layer.
// Exactness against the plain version rests on three choices: __fdiv_rn
// (IEEE division, one per element and step; never a multiply by 1/s, which
// differs in the last ulp and flips rounding ties; no fast math anywhere in
// the build), rintf (round half to even, as torch.round), and bounds built
// from the integer bit-width with ldexpf.  The clamp compares instead of
// fminf/fmaxf, which would turn NaN into a bound.
#include "common.cuh"

namespace {

constexpr int LSQ_THREADS = 128;  // one 16-byte vector each
constexpr int LSQ_MAX_STEPS = 3;

struct Steps {
  const float* ptr[LSQ_MAX_STEPS];  // a device step, or nullptr: use val
  float val[LSQ_MAX_STEPS];
};

template <typename T>
struct Outs {
  T* p[LSQ_MAX_STEPS];
};

__device__ __forceinline__ float fq(float x, float s, float qmin, float qmax) {
  float q = rintf(__fdiv_rn(x, s));
  q = q < qmin ? qmin : (q > qmax ? qmax : q);  // NaN fails both: kept
  return q * s;
}

// one 16-byte vector at one step
__device__ __forceinline__ uint4 fq_vec(uint4 v, float s, float qmin,
                                        float qmax, float) {
  uint4 r;
  r.x = __float_as_uint(fq(__uint_as_float(v.x), s, qmin, qmax));
  r.y = __float_as_uint(fq(__uint_as_float(v.y), s, qmin, qmax));
  r.z = __float_as_uint(fq(__uint_as_float(v.z), s, qmin, qmax));
  r.w = __float_as_uint(fq(__uint_as_float(v.w), s, qmin, qmax));
  return r;
}

__device__ __forceinline__ uint32_t fq_bf16x2(uint32_t w, float s, float qmin,
                                              float qmax) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(fq(f.x, s, qmin, qmax), fq(f.y, s, qmin, qmax));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 fq_vec(uint4 v, float s, float qmin,
                                        float qmax, __nv_bfloat16) {
  uint4 r;
  r.x = fq_bf16x2(v.x, s, qmin, qmax);
  r.y = fq_bf16x2(v.y, s, qmin, qmax);
  r.z = fq_bf16x2(v.z, s, qmin, qmax);
  r.w = fq_bf16x2(v.w, s, qmin, qmax);
  return r;
}

template <typename T, int NS>
__global__ void __launch_bounds__(LSQ_THREADS)
    lsq_kernel(const T* __restrict__ x, Outs<T> out, long long n, Steps steps,
               float qmin, float qmax) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nv = n / VEC;
  const long long i = static_cast<long long>(blockIdx.x) * LSQ_THREADS + threadIdx.x;
  // the load first, then the steps, then one store an output
  uint4 v;
  if (i < nv) v = __ldg(reinterpret_cast<const uint4*>(x) + i);
  float s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k)
    s[k] = fmaxf(fabsf(steps.ptr[k] != nullptr ? __ldg(steps.ptr[k]) : steps.val[k]),
                 1e-9f);
  if (i < nv) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
      reinterpret_cast<uint4*>(out.p[k])[i] = fq_vec(v, s[k], qmin, qmax, T());
  }
  // the ragged tail, fewer than VEC elements
  const long long tail = nv * VEC;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - tail) {
    const float xt = repro::to_f32(x[tail + threadIdx.x]);
#pragma unroll
    for (int k = 0; k < NS; ++k)
      out.p[k][tail + threadIdx.x] = repro::from_f32<T>(fq(xt, s[k], qmin, qmax));
  }
}

template <typename T>
int launch(const void* x, void* const* outs, long long n, Steps steps,
           int n_steps, float qmin, float qmax, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  long long blocks = (n / VEC + LSQ_THREADS - 1) / LSQ_THREADS;
  if (blocks < 1) blocks = 1;  // the tail alone, or nothing
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Outs<T> o;
  for (int k = 0; k < LSQ_MAX_STEPS; ++k)
    o.p[k] = static_cast<T*>(outs[k < n_steps ? k : 0]);
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (n_steps) {
    case 1: lsq_kernel<T, 1><<<grid, LSQ_THREADS, 0, st>>>(xt, o, n, steps, qmin, qmax); break;
    case 2: lsq_kernel<T, 2><<<grid, LSQ_THREADS, 0, st>>>(xt, o, n, steps, qmin, qmax); break;
    case 3: lsq_kernel<T, 3><<<grid, LSQ_THREADS, 0, st>>>(xt, o, n, steps, qmin, qmax); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out0..out2: 16-byte aligned, n elements of dtype; step k is
// *step_ptr_k (a float32 on the device) or, where that is null, step_val_k.
// Steps and outputs past n_steps are ignored.
extern "C" int lsq_fakequant_launch(const void* x, void* out0, void* out1,
                                    void* out2, long long n,
                                    const void* step_ptr0, const void* step_ptr1,
                                    const void* step_ptr2, float step_val0,
                                    float step_val1, float step_val2,
                                    int n_steps, int bits, int dtype,
                                    void* stream) {
  if (n_steps < 1 || n_steps > LSQ_MAX_STEPS || n < 0 || bits < 1 || bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float half = ldexpf(1.0f, bits - 1);
  const float qmin = -half, qmax = half - 1.0f;
  const Steps steps = {{static_cast<const float*>(step_ptr0),
                        static_cast<const float*>(step_ptr1),
                        static_cast<const float*>(step_ptr2)},
                       {step_val0, step_val1, step_val2}};
  void* const outs[LSQ_MAX_STEPS] = {out0, out1, out2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, outs, n, steps, n_steps, qmin, qmax, st);
  if (dtype == repro::kFloat32)
    return launch<float>(x, outs, n, steps, n_steps, qmin, qmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
