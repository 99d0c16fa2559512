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
//   contiguous  (B, S, ...) buffers: row b * S + s; a slot's last row is
//               min(position, S - 1).
//   paged       (P, page, ...) pools through a (B, n) block table: row
//               tbl[b, s / page] * page + s % page, the table entry clamped
//               to [0, P - 1]; the last row is min(position, n * page - 1).
// Everything else (the split, the ring, the arithmetic, the merge) is the
// same code, so on the same data and plan the paged kernel equals the
// contiguous kernel on the gathered cache bit for bit.  No row past a slot's
// position is read (its copy is zero-filled), so a free page's contents
// (even NaN) cannot reach the output.
//
// Replaces: src/repro/kernels/flash_attention.py::kv_decode_attention
// (_kv_decode_kernel) and ::paged_kv_decode_attention
// (_paged_kv_decode_kernel).
// Plain versions: repro_torch/kernels/ref.py::kv_cache_attention and
// ::paged_kv_cache_attention.
//
// Bound on the H100: bytes, and latency in practice.  A cache row of one KV
// head is read once and costs about 2 operations a code byte, far below the
// ~295 operations a byte at which the tensor cores would matter, so the
// design asks nothing of them (q . K is a matrix-vector product at
// olmo-1b's group of 1).  At the serve shapes (B = 8, Hkv = 16, D = 128,
// about 2,600 live rows a launch) the int8 cache is 10.8 MB, 3.2 us at
// 3.35 TB/s.  A block that walks a slot's rows alone waits on one load
// chain per round; the design (flash-decoding):
//  * split over the rows: grid (Hkv, B, splits); block (hk, b, c) takes the
//    chunk [c C, c C + C) of slot b's rows, up to its last row.  The host's
//    plan (cuda.py's decode_plan, from shapes alone, never the positions)
//    fixes splits and C (8 x 128 rows at the serve shapes).  The split is
//    the slowest grid dimension, so each slot's first chunks, live in every
//    slot, are dispatched before the later, mostly empty ones.  A block
//    whose chunk starts past the slot's last row exits at once; the merge
//    counts the n_act = last / C + 1 live splits, a number every block of
//    the slot reads alike;
//  * one block serves up to 4 query heads of its KV head's GQA group: its
//    4 warps hold the query rows (warps split a query row's rows between
//    them when the group is smaller than 4), so K and V bytes come from
//    HBM once per KV head.  A larger group is split evenly over blocks of
//    at most 4 (`gblocks`, cuda.py's decode_group_blocks: granite-20b's 48
//    query heads on one KV head take 12 blocks a chunk), which read the
//    KV head's rows each (from L2 after the first): a block that ran such
//    a group in rounds on chunks cut by them left its last block a merge
//    of 48 x 64 partial rows, 8 loads in flight a thread (PERF.md §6);
//  * a ring of up to KV_STAGES = 4 stages of KV_TILE = 64 rows (K codes, V
//    codes and V scales: 16,640 bytes a stage at int8, D = 128; 8,448 at
//    int4) in shared memory, filled by 16-byte cp.async (4-byte for the
//    scales) three stages ahead of the one being read, never more stages
//    than the chunk has tiles.  A stage's K and its V are two commit groups,
//    K's first, so a tile's scores and softmax run while its V arrives.  At
//    the serve plan a block's whole chunk (two tiles) is in flight at once,
//    33 KB at int8 and 17 KB at int4, and about three live blocks share an
//    SM: some 100 KB (int8) or 50 KB (int4) in flight an SM, against the
//    ~25 KB that HBM's latency asks;
//  * a row is cut across D / 16 lanes of 16 channels (8 lanes at D = 128:
//    16 code bytes a lane at int8, 8 at int4), so a row's dot product
//    reduces over 3 shuffles; the paged policy resolves the chunk's table
//    entries once, into shared memory, while the slot's position is still
//    in flight;
//  * per code: k_scale and D^-0.5 are folded into q once a block; a row's
//    v_scale into its softmax weight; a code becomes a float without I2F,
//    its byte (or nibble, after the split) placed by prmt into the low
//    mantissa of 2^23 and the bias subtracted (exact, full rate);
//  * online softmax a tile: the tile's logits go through shared memory,
//    each lane holds two rows of the tile for its max, weights and sum, so
//    every warp of a query row holds the same (m, l) and rescales its
//    accumulator only when the max moved; masked rows are exp(-1e30 - m) =
//    0, the -1e30 initial max and the max(l, 1e-30) guard are the oracle's;
//  * merge without another launch: with more than one live split each
//    block writes its (acc[D], m, l) to an fp32 workspace; the last block
//    of (b, hk) to arrive, found by an acquire-release counter that it
//    leaves at 0, adds the splits in split order, KV_MERGE partials in
//    flight at a time.  No floating-point atomics, so two calls on the same
//    inputs give the same bits.
// What is left (PERF.md): a launch is a chain of dependent steps - the
// position, the chunk's arrival, the math of every live block of an SM at
// once, the partial sums, the counter, the merge - and no byte count sets
// its time at these shapes.
#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_addr;

constexpr int KV_WARPS = 4;
constexpr int KV_THREADS = 32 * KV_WARPS;
constexpr int KV_TILE = 64;    // rows a ring stage and a softmax step
constexpr int KV_VPL = KV_TILE / 32;  // a tile's rows a lane holds in the softmax
constexpr int KV_STAGES = 4;   // ring stages; KV_STAGES - 1 ahead
constexpr int KV_MIN_BLOCKS = 4;    // resident blocks an SM: <= 128 registers
constexpr int KV_MAX_SPLITS = 256;  // the plan's limit
constexpr int KV_MERGE = 8;         // splits the merge loads at once
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int BITS, int D>
struct Geo {
  static constexpr int DP = BITS == 8 ? D : D / 2;      // code bytes a row
  static constexpr int CH = 16;                         // channels a lane
  static constexpr int LPR = D / CH;                    // lanes a row
  static constexpr int RPW = 32 / LPR;                  // rows a warp pass
  static constexpr int PASSES = KV_TILE / RPW;          // warp passes a tile
  static constexpr int STAGE = KV_TILE * (2 * DP + 4);  // K, V, V scales
  static constexpr int CPR = DP / 16;                   // 16-byte copies a row
  static constexpr int COPIES = KV_TILE * CPR / KV_THREADS;  // a thread's, an operand
  static_assert(KV_TILE * CPR % KV_THREADS == 0 && KV_TILE <= KV_THREADS, "copies");
};

// The channel of a lane's i-th value, in the order word_to_f32 yields them.
template <int BITS>
__device__ __forceinline__ int chan(int part, int i) {
  if constexpr (BITS == 8) return 16 * part + i;
  return 16 * part + 8 * (i >> 3) + 2 * (i & 3) + ((i >> 2) & 1);
}

// One word of codes -> exact floats without I2F: the biased byte (int8) or
// nibble (int4) goes into the low mantissa of 2^23 by prmt, and one FADD
// takes 2^23 and the bias away.  int8 yields the word's 4 codes; int4 the
// low nibbles of its 4 bytes, then the high ones.
template <int BITS>
__device__ __forceinline__ void word_to_f32(uint32_t w, float (&f)[BITS == 8 ? 4 : 8]) {
  if constexpr (BITS == 8) {
    const uint32_t u = w ^ 0x80808080u;  // code + 128
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388736.f;
  } else {
    const uint32_t u = w ^ 0x88888888u;  // code + 8 in every nibble
    const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + k)) - 8388616.f;
      f[4 + k] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + k)) - 8388616.f;
    }
  }
}

// A lane's code words of a row in shared memory: 16 bytes (int8) or 8
// (int4), 16 channels either way.
template <int BITS>
__device__ __forceinline__ void lane_words(const uint8_t* p, uint32_t (&w)[BITS == 8 ? 4 : 2]) {
  if constexpr (BITS == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  }
}

// The dot product of a lane's 16 codes with qk (4 chains), and
// acc += w * codes, word by word.
template <int BITS>
__device__ __forceinline__ float dot_codes(const uint8_t* p, const float (&qk)[16]) {
  constexpr int NW = BITS == 8 ? 4 : 8, WORDS = 16 / NW;
  uint32_t w[WORDS];
  lane_words<BITS>(p, w);
  float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    float f[NW];
    word_to_f32<BITS>(w[j], f);
#pragma unroll
    for (int k = 0; k < NW; ++k) d4[k & 3] = fmaf(qk[NW * j + k], f[k], d4[k & 3]);
  }
  return (d4[0] + d4[1]) + (d4[2] + d4[3]);
}
template <int BITS>
__device__ __forceinline__ void axpy_codes(float wt, const uint8_t* p, float (&acc)[16]) {
  constexpr int NW = BITS == 8 ? 4 : 8, WORDS = 16 / NW;
  uint32_t w[WORDS];
  lane_words<BITS>(p, w);
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    float f[NW];
    word_to_f32<BITS>(w[j], f);
#pragma unroll
    for (int k = 0; k < NW; ++k) acc[NW * j + k] = fmaf(wt, f[k], acc[NW * j + k]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// (B, S, ...) buffers
struct ContiguousRows {
  int S;
  int entries(int) const { return 0; }
  __device__ __forceinline__ int last(int pos) const { return min(pos, S - 1); }
  __device__ __forceinline__ int stage(int, int, int, int*) const { return 0; }
  __device__ __forceinline__ size_t row(int b, int s, const int*, int) const {
    return static_cast<size_t>(b) * S + s;
  }
};

// (P, page, ...) pools through a (B, n) block table.  A power-of-two page
// (shift >= 0) splits a row index with a shift instead of a division.
struct PagedRows {
  const int* tbl;
  int n, page, P, shift;
  // table entries a chunk of `chunk` rows can span
  int entries(int chunk) const { return (chunk - 1) / page + 2; }
  __device__ __forceinline__ int page_of(int s) const {
    return shift >= 0 ? s >> shift : s / page;
  }
  __device__ __forceinline__ int last(int pos) const { return min(pos, n * page - 1); }
  // The clamped table entries of the chunk's pages go to `ent`; returns the
  // chunk's first page.  Entries are the table's, not cache rows, so they
  // load beside the slot's position, before it is known.
  __device__ __forceinline__ int stage(int b, int c0, int chunk, int* ent) const {
    const int j0 = page_of(c0), j1 = min(page_of(c0 + chunk - 1), n - 1);
    for (int j = j0 + static_cast<int>(threadIdx.x); j <= j1; j += KV_THREADS)
      ent[j - j0] = min(max(__ldg(tbl + static_cast<size_t>(b) * n + j), 0), P - 1);
    return j0;
  }
  __device__ __forceinline__ size_t row(int, int s, const int* ent, int j0) const {
    const int j = page_of(s);
    return static_cast<size_t>(ent[j - j0]) * page + (s - j * page);
  }
};

// Block (hk * gblocks + gb, b, split): rows [split * chunk, + chunk) of
// slot b, KV head hk, for query heads gb * G .. gb * G + G - 1 of the
// group (G = H / Hkv / gblocks <= KV_WARPS).  The split is the slowest grid
// dimension, so every slot's first chunks are dispatched before the later,
// mostly empty ones.  Shared memory: the ring (slots stages), the warps'
// sums (KV_WARPS x D), the (m, l) of each query row, the tile's
// logits (KV_WARPS x KV_TILE), the paged table entries.
template <int BITS, int D, typename QT, typename Rows>
__global__ void __launch_bounds__(KV_THREADS, KV_MIN_BLOCKS)
    kv_decode_split(const QT* __restrict__ q, const uint8_t* __restrict__ kq,
                    const float* __restrict__ k_scale,
                    const uint8_t* __restrict__ vq,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ positions, float* __restrict__ out,
                    float* __restrict__ ws, unsigned int* __restrict__ counters,
                    int H, int Hkv, int gblocks, int chunk, int slots, float scale,
                    Rows rows) {
  using G = Geo<BITS, D>;
  constexpr int DP = G::DP, LPR = G::LPR, RPW = G::RPW, CH = G::CH, CPR = G::CPR;
  constexpr int BPL = DP / LPR;  // code bytes a lane reads of a row
  const int hk = blockIdx.x / gblocks, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z, group = H / Hkv / gblocks;  // this block's
  const int head0 = hk * (H / Hkv) + (blockIdx.x % gblocks) * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) uint8_t kv_smem[];
  uint8_t* ring = kv_smem;
  float* red = reinterpret_cast<float*>(kv_smem + slots * G::STAGE);
  float* ml = red + KV_WARPS * D;
  float* logit = ml + 2 * KV_WARPS;
  int* ent = reinterpret_cast<int*>(logit + KV_WARPS * KV_TILE);
  __shared__ int last_block;

  // warps of a query row, query rows a block, this warp's place
  const int wpg = KV_WARPS % group == 0 ? KV_WARPS / group : 1;
  const int gslots = KV_WARPS / wpg;
  const int gs = warp % gslots, wj = warp / gslots;
  const int lrow = lane / LPR, part = lane % LPR;

  // The loads that need no position go out with the position's: the
  // chunk's table entries, and q and k_scale (their
  // product is taken after the ring's first copies are issued).
  const int c0 = split * chunk;
  const int j0 = rows.stage(b, c0, chunk, ent);
  const int pos = __ldg(positions + b);
  float qk[CH], kscale[CH];
  auto load_q = [&](int g) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      qk[i] = kscale[i] = 0.f;
      if (g < group) {
        const int d = chan<BITS>(part, i);
        qk[i] = repro::to_f32(q[(static_cast<size_t>(b) * H + head0 + g) * D + d]);
        kscale[i] = __ldg(k_scale + (static_cast<size_t>(b) * Hkv + hk) * D + d);
      }
    }
  };
  load_q(gs);
  const int last = max(rows.last(pos), 0);
  const int n_act = last / chunk + 1;  // live splits of the slot
  if (split >= n_act) return;
  const int n_valid = min(chunk, last + 1 - c0);
  const int tiles = (n_valid + KV_TILE - 1) / KV_TILE;
  const size_t row_bytes = static_cast<size_t>(Hkv) * DP;
  const size_t head = static_cast<size_t>(hk) * DP;
  __syncthreads();  // ent

  // Tile t's K codes (v = 0), or its V codes and scales (v = 1), into its
  // ring slot as one commit group: 16-byte copies, 4-byte for the scales; a
  // row past n_valid is zero-filled and not read.
  auto issue = [&](int t, int v) {
    uint8_t* st = ring + (t % slots) * G::STAGE;
    const int r0 = t * KV_TILE;
    const uint8_t* codes = v ? vq : kq;
#pragma unroll 1
    for (int it = 0; it < G::COPIES; ++it) {
      const int j = tid + it * KV_THREADS;
      const int r = j / CPR, c = j % CPR;
      const bool ok = r0 + r < n_valid;
      const uint8_t* src = codes;
      if (ok) src += rows.row(b, c0 + r0 + r, ent, j0) * row_bytes + head + c * 16;
      cp_async16(smem_addr(st + v * KV_TILE * DP + r * DP + c * 16), src, ok);
    }
    if (v && tid < KV_TILE) {
      const bool ok = r0 + tid < n_valid;
      const float* src = v_scale;
      if (ok) src += rows.row(b, c0 + r0 + tid, ent, j0) * Hkv + hk;
      cp_async4(smem_addr(st + 2 * KV_TILE * DP + 4 * tid), src, ok);
    }
    cp_async_commit();
  };
  // two commit groups a tile, K's first, present or not
  auto issue_tile = [&](int t) {
    if (t < tiles) {
      issue(t, 0);
      issue(t, 1);
    } else {
      cp_async_commit();
      cp_async_commit();
    }
  };

  {  // warp gs holds query row gs of the block's group (<= KV_WARPS rows)
    const bool busy = gs < group;
#pragma unroll 1
    for (int s = 0; s < KV_STAGES - 1; ++s) issue_tile(s);
    // q with k_scale and D^-0.5 folded in, in the order of the lane's codes
    float acc[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      qk[i] = qk[i] * kscale[i] * scale;
      acc[i] = 0.f;
    }
    float m = NEG_INF, l = 0.f;
    for (int t = 0; t < tiles; ++t) {
      issue_tile(t + KV_STAGES - 1);
      cp_async_wait<2 * KV_STAGES - 1>();
      __syncthreads();  // tile t's K has landed, from every thread's copies
      const uint8_t* st = ring + (t % slots) * G::STAGE;
      const int r0 = t * KV_TILE;
      // this warp's row passes of the tile: wj, wj + wpg, ...
      const int npass = (G::PASSES - wj + wpg - 1) / wpg;
      if (busy) {
#pragma unroll 4
        for (int k = 0; k < npass; ++k) {
          const int r = (wj + k * wpg) * RPW + lrow;
          float dot = dot_codes<BITS>(st + r * DP + part * BPL, qk);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
          if (part == 0) logit[gs * KV_TILE + r] = r0 + r < n_valid ? dot : NEG_INF;
        }
      }
      __syncthreads();  // the tile's logits
      float p[KV_VPL];  // the weights of this lane's rows of the tile
      if (busy) {
        // lane i holds rows i, i + 32, ... of the tile: the tile's max,
        // weights and sum, while the tile's V is still arriving
        float x[KV_VPL];
        float xm = NEG_INF;
#pragma unroll
        for (int v = 0; v < KV_VPL; ++v) {
          x[v] = logit[gs * KV_TILE + 32 * v + lane];
          xm = fmaxf(xm, x[v]);
        }
        const float m_new = fmaxf(m, warp_max(xm));
        float ps = 0.f;
#pragma unroll
        for (int v = 0; v < KV_VPL; ++v) {
          p[v] = expf(x[v] - m_new);
          ps += p[v];
        }
        const float alpha = expf(m - m_new);
        l = l * alpha + repro::warp_sum(ps);
        m = m_new;
        if (alpha != 1.f) {
#pragma unroll
          for (int i = 0; i < CH; ++i) acc[i] *= alpha;
        }
      }
      cp_async_wait<2 * KV_STAGES - 2>();
      __syncthreads();  // tile t's V has landed
      if (busy) {
        const float* vs = reinterpret_cast<const float*>(st + 2 * KV_TILE * DP);
#pragma unroll 4
        for (int k = 0; k < npass; ++k) {
          const int r = (wj + k * wpg) * RPW + lrow;
          float pr = p[0];
#pragma unroll
          for (int v = 1; v < KV_VPL; ++v)
            if ((wj + k * wpg) * RPW >= 32 * v) pr = p[v];  // the pass's rows share v
          const float w = __shfl_sync(FULL, pr, r & 31) * vs[r];
          axpy_codes<BITS>(w, st + KV_TILE * DP + r * DP + part * BPL, acc);
        }
      }
      __syncthreads();  // the slot and the logits are free
    }

    // the warp's rows, over its row lanes; then its query row's warps, in
    // warp order, through shared memory
    if (busy) {
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
      if (lrow == 0) {
#pragma unroll
        for (int i = 0; i < CH; ++i) red[(gs * wpg + wj) * D + chan<BITS>(part, i)] = acc[i];
      }
      if (wj == 0 && lane == 0) {
        ml[2 * gs] = m;
        ml[2 * gs + 1] = l;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < gslots * D; idx += KV_THREADS) {
      const int s = idx / D, d = idx - s * D;
      const int gg = s;
      if (gg >= group) continue;
      float a = red[s * wpg * D + d];
      for (int j = 1; j < wpg; ++j) a += red[(s * wpg + j) * D + d];
      const size_t hh = static_cast<size_t>(b) * H + head0 + gg;
      if (n_act == 1) {
        out[hh * D + d] = a / fmaxf(ml[2 * s + 1], 1e-30f);
      } else {
        float* dst = ws + (hh * splits + split) * (D + 4);
        dst[d] = a;
        if (d == 0) {
          dst[D] = ml[2 * s];
          dst[D + 1] = ml[2 * s + 1];
        }
      }
    }
    __syncthreads();  // the partials are written
  }
  if (n_act == 1) return;

  // the block's partials, ordered by the barrier, are released by thread
  // 0's add; the last block's add acquires every other block's
  unsigned int* counter = counters + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  if (tid == 0)
    last_block = repro::arrive(counter) == static_cast<unsigned int>(n_act - 1);
  __syncthreads();
  if (!last_block) return;

  // The last block: each output of each query row adds the splits in
  // split order, KV_MERGE at a time (their loads in flight together),
  // rescaling the running sums to each batch's max.
  for (int idx = tid; idx < group * D; idx += KV_THREADS) {
    const int g = idx / D, d = idx - g * D;
    const size_t hh = static_cast<size_t>(b) * H + head0 + g;
    const float* base = ws + hh * splits * (D + 4);
    float mx = NEG_INF, o = 0.f, den = 0.f;
    for (int s0 = 0; s0 < n_act; s0 += KV_MERGE) {
      float ms[KV_MERGE], ls[KV_MERGE], as[KV_MERGE];
#pragma unroll
      for (int u8 = 0; u8 < KV_MERGE; ++u8) {
        ms[u8] = NEG_INF, ls[u8] = as[u8] = 0.f;
        if (s0 + u8 < n_act) {
          const float* ps = base + (s0 + u8) * (D + 4);
          ms[u8] = __ldcg(ps + D);
          ls[u8] = __ldcg(ps + D + 1);
          as[u8] = __ldcg(ps + d);
        }
      }
      float bm = mx;
#pragma unroll
      for (int u8 = 0; u8 < KV_MERGE; ++u8) bm = fmaxf(bm, ms[u8]);
      if (bm != mx) {
        const float r = expf(mx - bm);
        o *= r;
        den *= r;
        mx = bm;
      }
#pragma unroll
      for (int u8 = 0; u8 < KV_MERGE; ++u8) {
        if (s0 + u8 < n_act) {
          const float e = expf(ms[u8] - mx);
          o = fmaf(as[u8], e, o);
          den = fmaf(ls[u8], e, den);
        }
      }
    }
    out[hh * D + d] = o / fmaxf(den, 1e-30f);
  }
  if (tid == 0) *counter = 0u;
}

template <int BITS, int D, typename QT, typename Rows>
int launch(const void* q, const void* kq, const void* k_scale, const void* vq,
           const void* v_scale, const void* positions, void* out, void* ws,
           void* counters, int B, int H, int Hkv, int gblocks, int chunk,
           int splits, float scale, Rows rows, cudaStream_t st) {
  using G = Geo<BITS, D>;
  const int tiles = (chunk + KV_TILE - 1) / KV_TILE;
  const int slots = tiles < KV_STAGES ? tiles : KV_STAGES;
  const size_t smem = static_cast<size_t>(slots) * G::STAGE +
                      sizeof(float) * (KV_WARPS * D + 2 * KV_WARPS + KV_WARPS * KV_TILE) +
                      sizeof(int) * rows.entries(chunk);
  auto kern = kv_decode_split<BITS, D, QT, Rows>;
  static size_t opted = 48 << 10;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  // split slowest: live chunks go out first
  const dim3 grid(Hkv * gblocks, B, splits);
  kern<<<grid, KV_THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const float*>(k_scale), static_cast<const uint8_t*>(vq),
      static_cast<const float*>(v_scale), static_cast<const int*>(positions),
      static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<unsigned int*>(counters), H, Hkv, gblocks, chunk, slots, scale,
      rows);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int D, typename Rows>
int launch_q(const void* q, int q_dtype, const void* kq, const void* k_scale,
             const void* vq, const void* v_scale, const void* positions,
             void* out, void* ws, void* counters, int B, int H, int Hkv,
             int gblocks, int chunk, int splits, float scale, Rows rows,
             cudaStream_t st) {
  if (q_dtype == repro::kBFloat16)
    return launch<BITS, D, __nv_bfloat16>(q, kq, k_scale, vq, v_scale, positions, out, ws,
                                          counters, B, H, Hkv, gblocks, chunk, splits, scale,
                                          rows, st);
  return launch<BITS, D, float>(q, kq, k_scale, vq, v_scale, positions, out, ws, counters, B,
                                H, Hkv, gblocks, chunk, splits, scale, rows, st);
}

template <typename Rows>
int dispatch(const void* q, int q_dtype, const void* kq, const void* k_scale,
             const void* vq, const void* v_scale, const void* positions,
             void* out, void* ws, void* counters, int B, int H, int Hkv, int D,
             int bits, int n_rows, int gblocks, int chunk, int splits,
             float scale, Rows rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype != repro::kBFloat16 && q_dtype != repro::kFloat32)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan: whole 16-row units, covering the rows with no empty split
  // a block holds at most KV_WARPS query heads of a group, evenly split
  if (gblocks < 1 || Hkv < 1 || H % Hkv != 0 || (H / Hkv) % gblocks != 0 ||
      H / Hkv / gblocks > KV_WARPS || static_cast<long long>(Hkv) * gblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || n_rows < 1 || chunk < 16 || chunk % 16 != 0 ||
      B > 65535 || splits < 1 || splits > KV_MAX_SPLITS ||
      static_cast<long long>(splits) * chunk < n_rows ||
      static_cast<long long>(splits - 1) * chunk >= n_rows ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8 && D == 128)
    return launch_q<8, 128>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, ws, counters,
                            B, H, Hkv, gblocks, chunk, splits, scale, rows, st);
  if (bits == 4 && D == 128)
    return launch_q<4, 128>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, ws, counters,
                            B, H, Hkv, gblocks, chunk, splits, scale, rows, st);
  if (bits == 8 && D == 64)
    return launch_q<8, 64>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, ws, counters,
                            B, H, Hkv, gblocks, chunk, splits, scale, rows, st);
  if (bits == 4 && D == 64)
    return launch_q<4, 64>(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, ws, counters,
                            B, H, Hkv, gblocks, chunk, splits, scale, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, H, D) f32 or bf16; kq/vq: (B, S, Hkv, D) int8 or (B, S, Hkv, D/2)
// uint8, 16-byte aligned; k_scale: (B, Hkv, D) f32; v_scale: (B, S, Hkv)
// f32; positions: (B,) int32, each >= 0; out: (B, H, D) f32.  D is 64 or
// 128, B at most 65535.  The plan (cuda.py's decode_plan): `splits` chunks
// of `chunk` rows (a multiple of 16) cover S, none empty; with splits > 1,
// ws holds B * H * splits * (D + 4) floats and counters B * Hkv * gblocks
// zero int32s (left zero).  gblocks: the blocks each KV head's group of H /
// Hkv query heads is split over, evenly, at most 4 heads a block.
extern "C" int kv_decode_attention_launch(
    const void* q, int q_dtype, const void* kq, const void* k_scale,
    const void* vq, const void* v_scale, const void* positions, void* out,
    void* ws, void* counters, int B, int H, int S, int Hkv, int D, int bits,
    int gblocks, int chunk, int splits, float scale, void* stream) {
  return dispatch(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, ws, counters, B, H,
                  Hkv, D, bits, S, gblocks, chunk, splits, scale, ContiguousRows{S}, stream);
}

// As above over pools: kq/vq (P, page, Hkv, D or D/2); v_scale (P, page,
// Hkv) f32; tbl (B, n) int32, any entry (clamped to [0, P - 1]); the plan
// covers n * page rows.
extern "C" int paged_kv_decode_attention_launch(
    const void* q, int q_dtype, const void* kq, const void* k_scale,
    const void* vq, const void* v_scale, const void* tbl, const void* positions,
    void* out, void* ws, void* counters, int B, int H, int P, int page, int n,
    int Hkv, int D, int bits, int gblocks, int chunk, int splits, float scale,
    void* stream) {
  if (n < 1 || page < 1 || P < 1 || static_cast<long long>(n) * page > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int shift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  return dispatch(q, q_dtype, kq, k_scale, vq, v_scale, positions, out, ws, counters, B, H,
                  Hkv, D, bits, n * page, gblocks, chunk, splits, scale,
                  PagedRows{static_cast<const int*>(tbl), n, page, P, shift}, stream);
}
