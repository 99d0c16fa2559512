// Histogram of int32 codes: counts[c] for 0 <= c < n_bins, as float32.
// Codes outside [0, n_bins) fall in no bin (negatives, and the sentinel
// n_bins that the TPU wrapper pads with).
//
// Replaces: src/repro/kernels/entropy_hist.py::histogram (_hist_kernel).
// Plain version: repro_torch/kernels/ref.py::histogram.
//
// Bound on the H100: bytes.  Each code is read once (4 bytes) and costs a
// compare and an add; at the largest olmo-1b tensor (2048 x 8192 codes,
// 67 MB) the read alone takes 0.02 ms at 3.35 TB/s.  Design: the TPU kernel
// carries one (1, n_bins) sum across a sequential grid; here blocks run in
// parallel, so each block keeps n_bins uint32 counters in shared memory and
// adds them to global uint32 counters once per bin at the end.  Codes are
// read as int4 vectors by a grid-stride loop whose trip count is uniform
// across each warp; __match_any_sync groups the lanes that hold one code, so
// a warp makes one shared-memory atomicAdd per distinct code instead of one
// per lane.  The ragged tail (n % 4 codes) is masked here: nothing is padded.
// Integer atomics are order-free, so the counts are exact and the same on
// every run; they become float32 only at the end, which is exact for up to
// 2^24 codes per bin.  The largest olmo-1b tensor, 2048 x 8192, holds
// exactly 2^24 codes.
#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 256;
constexpr int HIST_MAX_BINS = 4096;  // 16 KB of shared counters

__device__ __forceinline__ void count(unsigned int* sh, int c, int n_bins, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, c);
  if (static_cast<unsigned>(c) < static_cast<unsigned>(n_bins) && lane == __ffs(peers) - 1)
    atomicAdd(sh + c, static_cast<unsigned>(__popc(peers)));
}

__global__ void __launch_bounds__(HIST_THREADS)
    hist_kernel(const int* __restrict__ codes, long long n, int n_bins,
                unsigned int* __restrict__ counts) {
  extern __shared__ unsigned int sh[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n4 = n / 4;
  const int4* v = reinterpret_cast<const int4*>(codes);
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warp_stride = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // base is the same for every lane of a warp, so all 32 lanes reach each
  // __match_any_sync; lanes past the end carry -1, which counts nowhere
  for (long long base = warp * 32; base < n4; base += warp_stride * 32) {
    const long long i = base + lane;
    const int4 c = i < n4 ? __ldg(v + i) : make_int4(-1, -1, -1, -1);
    count(sh, c.x, n_bins, lane);
    count(sh, c.y, n_bins, lane);
    count(sh, c.z, n_bins, lane);
    count(sh, c.w, n_bins, lane);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {
    const int c = __ldg(codes + n4 * 4 + threadIdx.x);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n_bins)) atomicAdd(sh + c, 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x)
    if (sh[i] != 0u) atomicAdd(counts + i, sh[i]);
}

__global__ void counts_to_f32(const unsigned int* __restrict__ counts,
                              float* __restrict__ out, int n_bins) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_bins; i += gridDim.x * blockDim.x)
    out[i] = static_cast<float>(counts[i]);
}

}  // namespace

// codes: (n,) int32, 16-byte aligned; counts: (n_bins,) uint32 scratch;
// out: (n_bins,) float32.  1 <= n_bins <= 4096.
extern "C" int histogram_launch(const void* codes, long long n, int n_bins,
                                void* counts, void* out, void* stream) {
  if (n_bins < 1 || n_bins > HIST_MAX_BINS || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* cnt = static_cast<unsigned int*>(counts);
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(unsigned int) * n_bins, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n / 4 + HIST_THREADS - 1) / HIST_THREADS;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  hist_kernel<<<static_cast<int>(blocks), HIST_THREADS, sizeof(unsigned int) * n_bins, st>>>(
      static_cast<const int*>(codes), n, n_bins, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_to_f32<<<(n_bins + 255) / 256, 256, 0, st>>>(cnt, static_cast<float*>(out), n_bins);
  return static_cast<int>(cudaGetLastError());
}
