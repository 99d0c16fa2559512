// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes by
// repro_torch/kernels/cuda.py): device pointers and the CUDA stream arrive
// as void*, sizes as int, and each launcher returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.  Below the scalar
// helpers come the Hopper primitives the tensor-core kernels share
// (cp.async, ldmatrix, mma.sync, mbarriers, TMA, wgmma descriptors) and the
// host-side tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <tuple>

namespace repro {

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sign-extend the low `bits` bits of v.
template <int BITS>
__device__ __forceinline__ int sext(uint32_t v) {
  int c = static_cast<int>(v & ((1u << BITS) - 1u));
  return c >= (1 << (BITS - 1)) ? c - (1 << BITS) : c;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------ asynchronous copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; with valid == false the src-size is 0: the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- last-block counters
// Add one to a counter in device memory, acquire-release at GPU scope, and
// return the value before the add.  The split kernels find their last
// block so: each block's writes, ordered by a barrier, are released by its
// thread 0's add, and the add that reads count - 1 acquires all of them.
__device__ __forceinline__ unsigned int arrive(unsigned int* counter) {
  unsigned int prev;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(prev)
               : "l"(counter)
               : "memory");
  return prev;
}

// ---------------------------------------------- mma.sync and its operands
// Four 8 x 8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Lane (g = lane / 4, t = lane % 4): a holds rows g, g + 8 at K pairs
// (2t, 2t+1) and (2t+8, 2t+9); b holds K pairs (2t, 2t+1), (2t+8, 2t+9) of
// column g; d holds rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns
// 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------- mbarriers, TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------- wgmma
// Shared-memory descriptor of a K-major bf16 tile with 128-byte rows and the
// 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}
// The same for an MN-major tile (the transposed B of a K x N product with N
// contiguous), as TMA's 128-byte swizzle stores it: 64-element N blocks of
// 128-byte rows, one row per K index; the N blocks `lbo` bytes apart, the
// 8-row K groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |     // LBO: N blocks
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO: K groups
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After wg_wait: keep the compiler from reading accumulators before it.
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's shared operands, TMA) before it signals a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------- host: the device
// Streaming multiprocessors of the current device (the persistent kernels'
// grid), read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// ------------------------------------------------- host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kMaxTmaRank = 5;

// A tiled TMA descriptor of rank <= 5, with the 128-byte swizzle unless
// told otherwise, made by libcuda's cuTensorMapEncodeTiled, looked up
// through the runtime so a library needs no -lcuda.  dims and box run
// innermost first; strides holds the byte strides of dims 1 .. rank - 1
// (each a multiple of 16).  Out-of-bounds boxes are zero-filled.
// Descriptors are cached by pointer, type, shape, strides, box and swizzle.
inline int tensor_map(CUtensorMap* map, const void* ptr,
                      CUtensorMapDataType type, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  typedef std::array<uint64_t, 3 * kMaxTmaRank> Shape;
  static EncodeTiled encode = nullptr;
  static std::map<std::tuple<const void*, int, int, int, Shape>, CUtensorMap>
      cache;
  if (rank < 1 || rank > kMaxTmaRank)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape shape{};
  for (int i = 0; i < rank; ++i) {
    shape[i] = dims[i];
    shape[kMaxTmaRank + i] = i + 1 < rank ? strides[i] : 0;
    shape[2 * kMaxTmaRank + i] = box[i];
  }
  const auto key = std::make_tuple(ptr, static_cast<int>(type), rank,
                                   static_cast<int>(swizzle), shape);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t d[kMaxTmaRank], st[kMaxTmaRank];
  cuuint32_t bx[kMaxTmaRank], elem_strides[kMaxTmaRank];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    elem_strides[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(ptr), d, st,
                            bx, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

}  // namespace repro
