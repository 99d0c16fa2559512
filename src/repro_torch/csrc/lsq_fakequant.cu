// LSQ fake-quantization forward: out = clip(rint(x / s), qmin, qmax) * s,
// s = max(|step|, 1e-9), computed in float32 and stored in x's dtype.
//
// Replaces: src/repro/kernels/lsq_fakequant.py::lsq_fakequant (_lsq_kernel).
// Plain version: repro_torch/kernels/ref.py::lsq_fakequant.
//
// Bound on the H100: bytes.  One read and one write of x (2 + 2 bytes per
// element in bf16) against ~6 flops per element, far below the card's
// ~295 flops/byte balance point.  Design: a flat grid-stride pass; the step
// is read from device memory (no host sync) and the bit-width arrives as an
// integer, so one build serves every layer and policy.  Exactness against
// the plain version rests on three choices: __fdiv_rn (IEEE division; no
// fast math anywhere in the build), rintf (round half to even, as
// torch.round), and bounds built from the integer bit-width with ldexpf.
#include "common.cuh"

namespace {

template <typename T>
__global__ void lsq_kernel(const T* __restrict__ x, T* __restrict__ out,
                           long long n, const float* __restrict__ step_ptr,
                           float step_val, float qmin, float qmax) {
  const float step = step_ptr != nullptr ? *step_ptr : step_val;
  const float s = fmaxf(fabsf(step), 1e-9f);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float q = rintf(__fdiv_rn(repro::to_f32(x[i]), s));
    q = fminf(fmaxf(q, qmin), qmax);
    out[i] = repro::from_f32<T>(q * s);
  }
}

}  // namespace

extern "C" int lsq_fakequant_launch(const void* x, void* out, long long n,
                                    const void* step_ptr, float step_val,
                                    int bits, int dtype, void* stream) {
  const float half = ldexpf(1.0f, bits - 1);
  const float qmin = -half, qmax = half - 1.0f;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(step_ptr);
  if (dtype == repro::kBFloat16) {
    lsq_kernel<__nv_bfloat16><<<static_cast<int>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        n, sp, step_val, qmin, qmax);
  } else if (dtype == repro::kFloat32) {
    lsq_kernel<float><<<static_cast<int>(blocks), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, sp,
        step_val, qmin, qmax);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
