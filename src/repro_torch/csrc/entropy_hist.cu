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
// parallel and one launch does the whole call:
//  - n_bins <= 16 (EAGL's 4 and 16 bins): each thread counts its codes in
//    registers (NB = 4 or 16 bins, a template parameter).  It reads
//    HIST_UNROLL 16-byte vectors before it counts them, by compare-and-add
//    into NB / 4 words of four 8-bit counters (a compare a word, not a bin,
//    which at 16 bins was faster on the H100 than a compare a bin), which
//    it adds into NB 32-bit counters after each 16 codes; the warp sums
//    each bin with __reduce_add_sync, and the block adds each bin once
//    into the global counters;
//  - up to 4096 bins: n_bins shared counters a block; __match_any_sync
//    groups the lanes that hold one code, so a warp makes one shared
//    atomicAdd per distinct code; the block adds each nonzero bin once.
// The global counters are the caller's zeroed buffer (n_bins counts and a
// block counter, which every launch leaves at zero): the last block to
// arrive, found by an acquire-release add on the block counter, converts
// the counts to float32, zeroing each as it reads it, and resets the block
// counter.  No memset, no second kernel.  The ragged tail (n % 4 codes) is
// counted by block 0; nothing is padded.  Integer atomics are order-free,
// so the counts are exact and the same on every run; they become float32
// only at the end, which is exact for up to 2^24 codes per bin.  The
// largest olmo-1b tensor, 2048 x 8192, holds exactly 2^24 codes.
#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 256;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_UNROLL = 4;          // 16-byte vectors in flight a thread
constexpr int HIST_REG_BINS = 16;       // register counters up to this
constexpr int HIST_MAX_BINS = 4096;     // 16 KB of shared counters

// The last block of the launch: converts the counts to float32, zeroing
// them, and resets the block counter (counts[n_bins]).  Every block calls
// it after its adds to the counts; the adds are ordered by the barrier and
// released by thread 0's acquire-release add, which in the last block also
// acquires every other block's.
__device__ __forceinline__ void finish(unsigned int* counts, int n_bins,
                                       float* __restrict__ out) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = repro::arrive(counts + n_bins) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x)
    out[i] = static_cast<float>(atomicExch(counts + i, 0u));
  if (threadIdx.x == 0) counts[n_bins] = 0u;
}

// Adds code c to NB / 4 words of four 8-bit counters (bin c in byte c % 4
// of word c / 4): one compare and add a word.  A code outside [0, NB)
// matches no word.
template <int NB>
__device__ __forceinline__ void tally(unsigned int (&w)[NB / 4], int c) {
  const unsigned int one = 1u << ((c & 3) << 3);
  const int word = c >> 2;
#pragma unroll
  for (int j = 0; j < NB / 4; ++j) w[j] += word == j ? one : 0u;
}

// Register counters: NB bins, codes c with c < n_bins <= NB counted.
template <int NB>
__global__ void __launch_bounds__(HIST_THREADS)
    hist_reg_kernel(const int* __restrict__ codes, long long n, int n_bins,
                    unsigned int* counts, float* __restrict__ out) {
  __shared__ unsigned int warp_counts[HIST_WARPS][NB];
  unsigned int cnt[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) cnt[b] = 0u;
  const long long n4 = n / 4;
  const int4* v = reinterpret_cast<const int4*>(codes);
  const long long stride = static_cast<long long>(gridDim.x) * HIST_THREADS * HIST_UNROLL;
  for (long long base = static_cast<long long>(blockIdx.x) * HIST_THREADS * HIST_UNROLL
                        + threadIdx.x;
       base < n4; base += stride) {
    int4 c[HIST_UNROLL];
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      const long long i = base + u * HIST_THREADS;
      c[u] = i < n4 ? __ldg(v + i) : make_int4(-1, -1, -1, -1);
    }
    // 4 HIST_UNROLL codes into 8-bit counters (at most 16 a bin: no
    // overflow), then into the 32-bit ones
    unsigned int w[NB / 4];
#pragma unroll
    for (int j = 0; j < NB / 4; ++j) w[j] = 0u;
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      tally<NB>(w, c[u].x);
      tally<NB>(w, c[u].y);
      tally<NB>(w, c[u].z);
      tally<NB>(w, c[u].w);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) cnt[b] += (w[b >> 2] >> ((b & 3) << 3)) & 0xffu;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {
    const int c = __ldg(codes + n4 * 4 + threadIdx.x);
#pragma unroll
    for (int b = 0; b < NB; ++b) cnt[b] += c == b;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const unsigned int w = __reduce_add_sync(0xffffffffu, cnt[b]);
    if (lane == 0) warp_counts[warp][b] = w;
  }
  __syncthreads();
  if (threadIdx.x < n_bins) {
    unsigned int s = 0u;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) s += warp_counts[w][threadIdx.x];
    if (s != 0u) atomicAdd(counts + threadIdx.x, s);
  }
  finish(counts, n_bins, out);
}

__device__ __forceinline__ void count(unsigned int* sh, int c, int n_bins, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, c);
  if (static_cast<unsigned>(c) < static_cast<unsigned>(n_bins) && lane == __ffs(peers) - 1)
    atomicAdd(sh + c, static_cast<unsigned>(__popc(peers)));
}

// Shared counters: any n_bins up to HIST_MAX_BINS.
__global__ void __launch_bounds__(HIST_THREADS)
    hist_shared_kernel(const int* __restrict__ codes, long long n, int n_bins,
                       unsigned int* counts, float* __restrict__ out) {
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
  finish(counts, n_bins, out);
}

// One wave: as many blocks as fit on the card at once, fewer where the
// codes run out first.
template <typename Kernel>
int launch(Kernel kernel, int vectors_a_thread, size_t smem, const int* codes,
           long long n, int n_bins, unsigned int* counts, float* out,
           cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, HIST_THREADS,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(HIST_THREADS) * vectors_a_thread;
  long long blocks = (n / 4 + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : blocks;
  blocks = blocks > static_cast<long long>(sms) * per_sm ? sms * per_sm : blocks;
  kernel<<<static_cast<int>(blocks), HIST_THREADS, smem, st>>>(codes, n, n_bins, counts,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes: (n,) int32, 16-byte aligned; counts: n_bins + 1 uint32 counters,
// zero, which the launch leaves zero; out: (n_bins,) float32.
// 1 <= n_bins <= 4096.
extern "C" int histogram_launch(const void* codes, long long n, int n_bins,
                                void* counts, void* out, void* stream) {
  if (n_bins < 1 || n_bins > HIST_MAX_BINS || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(codes);
  unsigned int* cnt = static_cast<unsigned int*>(counts);
  float* o = static_cast<float*>(out);
  if (n_bins <= 4)
    return launch(hist_reg_kernel<4>, HIST_UNROLL, 0, c, n, n_bins, cnt, o, st);
  if (n_bins <= HIST_REG_BINS)
    return launch(hist_reg_kernel<HIST_REG_BINS>, HIST_UNROLL, 0, c, n, n_bins,
                  cnt, o, st);
  return launch(hist_shared_kernel, 1, sizeof(unsigned int) * n_bins, c, n, n_bins,
                cnt, o, st);
}
