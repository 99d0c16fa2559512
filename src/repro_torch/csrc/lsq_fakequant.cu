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
// The backward (lsq_bwd_kernel, below the forward) has no TPU kernel: it
// replaces the reference's custom VJP, src/repro/core/quant.py::_lsq_bwd,
// which XLA fuses; its plain version is ref.py::lsq_fakequant_bwd.
//
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

// ------------------------------------------------------------- backward
// For x and 1 to 3 (g_k, step_k) pairs at one bit-width (the projections
// that share an input):
//   gx   = sum_k where(in_range_k, g_k, 0)   (the first term as it is, the
//          others added in float32 in k order, stored once in x's dtype)
//   gs_k = gscale * sum(g_k * ds_k),  ds = rint(xs) - xs in range and
//          clamp(xs, qmin, qmax) outside (NaN kept), xs = x / s_k.
// Bound on the H100: bytes.  x and each g_k are read once and gx written
// once (2 + 2 NS + 2 bytes per bf16 element) against ~10 flops per element
// and step.  Design:
//  - a fixed grid (LSQ_BWD_BLOCKS_PER_SM blocks an SM at most, fewer for a
//    short x) of threads that walk 16-byte vectors of x and of each g_k,
//    the same vector index in all of them, and store one vector of gx;
//  - xs is __fdiv_rn(x, s), as in the forward, so in_range and ds see the
//    codes the forward produced;
//  - the products g * ds are exact in double (a float times a float), and
//    every sum of them is taken in double: in a thread in vector order,
//    then over the block (warp shuffles, then the warps in order), then
//    over the blocks by the last block to arrive (an acquire-release
//    counter, as in entropy_hist.cu), which adds the blocks' partial sums
//    in block order and writes gs_k = (float)(sum * gscale).  The result
//    is the same on every run and within double rounding of any other
//    order of the same sum; no float atomics, no host sync, one launch;
//  - the counter is the caller's zero int32 (the stream's counter buffer),
//    left at zero again by the last block.
constexpr int LSQ_BWD_THREADS = 256;
constexpr int LSQ_BWD_WARPS = LSQ_BWD_THREADS / 32;

template <typename T>
struct Grads {
  const T* p[LSQ_MAX_STEPS];
};

// one element at NS steps: returns gx in float32, adds g * ds to acc
template <int NS>
__device__ __forceinline__ float bwd_elem(float xv, const float (&g)[NS],
                                          const float (&s)[NS], float qmin,
                                          float qmax, double (&acc)[NS]) {
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const float xs = __fdiv_rn(xv, s[k]);
    const bool in = xs >= qmin && xs <= qmax;
    const float term = in ? g[k] : 0.0f;
    out = k == 0 ? term : __fadd_rn(out, term);
    const float ds = in ? __fsub_rn(rintf(xs), xs)
                        : (xs < qmin ? qmin : (xs > qmax ? qmax : xs));
    acc[k] += static_cast<double>(g[k]) * static_cast<double>(ds);
  }
  return out;
}

template <int NS>
__device__ __forceinline__ uint4 bwd_vec(uint4 xv, const uint4 (&gv)[NS],
                                         const float (&s)[NS], float qmin,
                                         float qmax, double (&acc)[NS],
                                         float) {
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv);
  uint4 r;
  uint32_t* rw = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float g[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k)
      g[k] = __uint_as_float(reinterpret_cast<const uint32_t*>(&gv[k])[e]);
    rw[e] = __float_as_uint(
        bwd_elem<NS>(__uint_as_float(xw[e]), g, s, qmin, qmax, acc));
  }
  return r;
}

template <int NS>
__device__ __forceinline__ uint4 bwd_vec(uint4 xv, const uint4 (&gv)[NS],
                                         const float (&s)[NS], float qmin,
                                         float qmax, double (&acc)[NS],
                                         __nv_bfloat16) {
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv);
  uint4 r;
  uint32_t* rw = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
    float g0[NS], g1[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          &reinterpret_cast<const uint32_t*>(&gv[k])[e]));
      g0[k] = gf.x;
      g1[k] = gf.y;
    }
    const float o0 = bwd_elem<NS>(xf.x, g0, s, qmin, qmax, acc);
    const float o1 = bwd_elem<NS>(xf.y, g1, s, qmin, qmax, acc);
    __nv_bfloat162 h = __floats2bfloat162_rn(o0, o1);
    rw[e] = *reinterpret_cast<uint32_t*>(&h);
  }
  return r;
}

// Sums v over the block; the total lands in thread 0's v.
template <int NS>
__device__ __forceinline__ void block_sum(double (&v)[NS],
                                          double (&shm)[LSQ_BWD_WARPS][NS]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (lane == 0) shm[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      double t = shm[0][k];
      for (int w = 1; w < LSQ_BWD_WARPS; ++w) t += shm[w][k];
      v[k] = t;
    }
  }
  __syncthreads();
}

template <typename T, int NS>
__global__ void __launch_bounds__(LSQ_BWD_THREADS)
    lsq_bwd_kernel(const T* __restrict__ x, Grads<T> g, T* __restrict__ gx,
                   long long n, Steps steps, float qmin, float qmax,
                   float gscale, double* __restrict__ partials,
                   unsigned int* counter, float* __restrict__ gs) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ double shm[LSQ_BWD_WARPS][NS];
  __shared__ int last;
  const long long nv = n / VEC;
  float s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k)
    s[k] = fmaxf(fabsf(steps.ptr[k] != nullptr ? __ldg(steps.ptr[k]) : steps.val[k]),
                 1e-9f);
  double acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * LSQ_BWD_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * LSQ_BWD_THREADS + threadIdx.x;
       i < nv; i += stride) {
    const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x) + i);
    uint4 gv[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) gv[k] = __ldg(reinterpret_cast<const uint4*>(g.p[k]) + i);
    reinterpret_cast<uint4*>(gx)[i] = bwd_vec<NS>(xv, gv, s, qmin, qmax, acc, T());
  }
  // the ragged tail, fewer than VEC elements
  const long long tail = nv * VEC;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - tail) {
    const long long e = tail + threadIdx.x;
    float gt[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) gt[k] = repro::to_f32(g.p[k][e]);
    gx[e] = repro::from_f32<T>(bwd_elem<NS>(repro::to_f32(x[e]), gt, s, qmin, qmax, acc));
  }
  block_sum<NS>(acc, shm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) partials[k * gridDim.x + blockIdx.x] = acc[k];
    last = repro::arrive(counter) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the partial sums in block order, then over the block
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double t = 0.0;
    for (unsigned int b = threadIdx.x; b < gridDim.x; b += LSQ_BWD_THREADS)
      t += __ldcg(partials + k * gridDim.x + b);
    acc[k] = t;
  }
  block_sum<NS>(acc, shm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
      gs[k] = static_cast<float>(acc[k] * static_cast<double>(gscale));
    *counter = 0u;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* const* grads, void* gx, long long n,
               Steps steps, int n_steps, float qmin, float qmax, float gscale,
               double* partials, int blocks, unsigned int* counter, float* gs,
               cudaStream_t st) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Grads<T> g;
  for (int k = 0; k < LSQ_MAX_STEPS; ++k)
    g.p[k] = static_cast<const T*>(grads[k < n_steps ? k : 0]);
  const T* xt = static_cast<const T*>(x);
  T* gxt = static_cast<T*>(gx);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (n_steps) {
    case 1: lsq_bwd_kernel<T, 1><<<grid, LSQ_BWD_THREADS, 0, st>>>(
                xt, g, gxt, n, steps, qmin, qmax, gscale, partials, counter, gs); break;
    case 2: lsq_bwd_kernel<T, 2><<<grid, LSQ_BWD_THREADS, 0, st>>>(
                xt, g, gxt, n, steps, qmin, qmax, gscale, partials, counter, gs); break;
    case 3: lsq_bwd_kernel<T, 3><<<grid, LSQ_BWD_THREADS, 0, st>>>(
                xt, g, gxt, n, steps, qmin, qmax, gscale, partials, counter, gs); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g0..g2 and gx: 16-byte aligned, n elements of dtype; steps as in
// lsq_fakequant_launch; gscale the LSQ step gradient's scale; partials:
// n_steps * blocks doubles of scratch; counter: one zero uint32 (left at
// zero); gs: n_steps floats, written by the last block.  The caller picks
// blocks (a function of n alone, for a reproducible sum).
extern "C" int lsq_fakequant_bwd_launch(
    const void* x, const void* g0, const void* g1, const void* g2, void* gx,
    long long n, const void* step_ptr0, const void* step_ptr1,
    const void* step_ptr2, float step_val0, float step_val1, float step_val2,
    int n_steps, int bits, int dtype, float gscale, void* partials, int blocks,
    void* counter, void* gs, void* stream) {
  if (n_steps < 1 || n_steps > LSQ_MAX_STEPS || n < 0 || bits < 1 || bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float half = ldexpf(1.0f, bits - 1);
  const Steps steps = {{static_cast<const float*>(step_ptr0),
                        static_cast<const float*>(step_ptr1),
                        static_cast<const float*>(step_ptr2)},
                       {step_val0, step_val1, step_val2}};
  const void* const grads[LSQ_MAX_STEPS] = {g0, g1, g2};
  double* part = static_cast<double*>(partials);
  unsigned int* cnt = static_cast<unsigned int*>(counter);
  float* out = static_cast<float*>(gs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, grads, gx, n, steps, n_steps, -half,
                                     half - 1.0f, gscale, part, blocks, cnt, out, st);
  if (dtype == repro::kFloat32)
    return launch_bwd<float>(x, grads, gx, n, steps, n_steps, -half, half - 1.0f,
                             gscale, part, blocks, cnt, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
