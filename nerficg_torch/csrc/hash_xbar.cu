// Full-table ("crossbar") hash encode, exact or stochastic corners, and its
// table gradient.
//
// Forward. Replaces the TPU kernel nerficg_tpu/ops/hash_xbar.py `_fwd_kernel`
// (:303, launched by `_fwd_pallas` :348), which scans every table row through
// the TPU's lane crossbar because the TPU has no fast gather. It computes
// what the jnp oracle `_fwd_jnp` (:708) computes: per (sample, level) the
// trilinear corners, each corner's flat index by `_corner_index` (:144):
// x + y*(res+1) + z*(res+1)^2 on dense levels, the Instant-NGP hash masked to
// rows*128 - 1 on hashed ones; a bf16-rounded read of both features and the
// weighted sum. Output is sample-major (N, L*2).
//
// Stochastic mode (NC in {1, 2, 4}) evaluates `_stoch_corners` with the
// counter-hash words of (seed, level, sample, dim) (hash_common.cuh, the
// words nerficg_torch/ops/counter_rng.py computes); the TPU draws
// pltpu.prng_random_bits per (level, tile) instead, so no port run matches a
// TPU run's corners. With saves, the forward also writes each corner's flat
// index (int32) and weight (f32), each (L, C, N), so a check can hold the
// corners to the plain version's bit for bit. Each feature is the sum over
// the corners in order of the rounded products w_c * v_c (__fmul_rn, then
// __fadd_rn: the plain version rounds each product too), so the forward's
// two paths give the same bits:
//   * level-resident (what the TPU kernel keeps in VMEM: the level's
//     table): grid (T sample tiles, L / kFwdLevels level groups); a block
//     stages its kFwdLevels adjacent levels' tables as one bf16x2 word per
//     entry (64 KiB per 2^14 level), then walks its tile's samples, one
//     4-byte shared load per corner, and writes each sample's levels as one
//     contiguous store;
//   * gather, for tables past a block's shared memory and for calls too
//     small to repay the staging: one thread per (sample, level), two
//     __ldg per corner.
//
// Backward. One entry, `nerficg_hash_xbar_bwd_fused`, computes the table
// gradient (#11, `_bwd_kernel` :394, `_bwd_pallas` :481), the position
// gradient (#12, `_bwd_pos_kernel` :537, `_bwd_pos_pallas` :599), or both
// from one pass over the corners. Both recompute the corners with the
// forward's device code (the same counter words in stochastic mode, which
// the TPU replays from its per-tile stream), so the gradient lands on the
// corners the forward read, bit for bit. The table gradient adds the f32
// product g * w_c at each corner, as `_bwd_jnp` (:721) does. The position
// gradient, with g the sample's two cotangents and v_c the bf16-rounded
// features of corner c, adds per sample and level
//   ((g . v_c) * dfactor_{c,d}) * (prod_{e != d} factor_{c,e}) * (res - 1)
// over the corners in order into a per-level sum, and the levels' sums in
// order into dpos (N, 3), d/d(unit position) as the oracle `_dpos_jnp`
// (:642) differentiates the bf16 trilinear encode. Exact corners: factor f
// or 1 - f, dfactor +-1. Stochastic corners (the forward's draws): the
// interpolated dims likewise, the Bernoulli-sampled dims factor 1 and
// dfactor 0 (`_corner_set` :236, straight-through). A (sample, level) whose
// two cotangents are 0 adds exact zeros to both and is skipped.
//
// Level-resident path (what the TPU kernels keep in VMEM: the level's
// gradient block across all sample tiles, `_bwd_kernel`, and the level's
// table, `_bwd_pos_kernel`). Grid (T sample tiles, L levels), one block of
// kResThreads per SM, T * L about one wave of the SMs. A block stages its
// level's rows_l * 128 entries in dynamic shared memory: the table (#12) as
// one bf16x2 word per entry (both features rounded with bf16_round, as the
// gather path reads them), and an f32 gradient of both planes (#11), zeroed.
// A corner then costs one shared load and two shared f32 atomicAdds where
// the gather path pays two L2 sectors or two global atomics; the shared
// atomics are compare-and-swap loops on sm_90, so runs of lanes on one
// corner (ray-ordered samples at the coarse levels) first sum in the warp.
// At the end the block adds its gradient's non-zero float4s into the table,
// one coalesced vector atomic each (the table zeroed by cudaMemsetAsync
// first): T * L * rows_l * 128 / 2 global atomics where the gather path
// makes 16 per (sample, level). The position gradient keeps the plain
// version's order of operations: each (level, sample) sum goes to an
// (L, N, 3) scratch, and a second kernel adds each sample's L sums in level
// order with _rn intrinsics, so dpos is the plain version's, bit for bit,
// whichever level block finished first. A level of 2^14 entries needs 128
// KiB of gradient and 64 KiB of table; the path is taken when the largest
// level fits the 227 KB a block may use (the wrapper chooses by shapes).
//
// Gather path, for tables past that: one thread per (sample, level) that
// atomically adds into the global table (#11), and one thread per sample
// that walks the levels in order, reads the corners with __ldg and keeps
// the three sums in registers (#12); no atomics there, so dpos is again the
// plain version's bits.
//
// What bounds them on an H100: 2 * C random 4-byte reads (forward) or atomic
// adds (backward) per (sample, level), C = 8 exact or 1/2/4 stochastic,
// against 8 bytes written or read per (sample, level). At the library's 2^14
// entries the whole table is 2 MiB and stays in the 50 MB L2, so on the
// gather path the reads and atomics are L2 operations; the hash spreads
// neighbouring vertices over the table, so a warp's corners touch ~32
// separate sectors at hashed levels, and ray-ordered samples share the
// coarse levels' corners, whose atomics serialize at L2. The resident path
// moves those operations into shared memory, where the latency of the
// compare-and-swap atomics and their bank conflicts sets the pace (on an
// H100 it runs a third faster at 1024 threads per SM than at 512); the
// position gradient's scratch and level sum add 2 * 12 bytes per (sample,
// level). The forward's gather path spends two 32-byte L2 sectors on each
// corner's two 4-byte features (the planes lie rows * 128 floats apart); the
// resident path reads each level's table once per block (128 KiB of f32 at
// 2^14, from L2) and then only the positions, so its pace is the per-corner
// index math and shared loads, and the sample-major output: each block writes
// 8 * kFwdLevels bytes per sample at a stride of L*2 floats, which L2 merges
// across the level groups' blocks. Two levels per block halve those partial
// writes (on an H100 a quarter faster than one level at 262,144 samples);
// past about 24 MiB of output, as the L2 stops holding the rows until they
// are whole, the time per sample grows and varies between calls.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_common.cuh"

namespace {

using nerficg::kLanes;

struct XbarLevel {
  float res_m1;
  int res1;
  bool dense;
  uint32_t mask;
};

__device__ __forceinline__ XbarLevel xbar_level(const float* res_m1_l,
                                                const int* lrows_l,
                                                const int* dense_l, int lvl) {
  XbarLevel lay;
  lay.res_m1 = res_m1_l[lvl];
  lay.res1 = static_cast<int>(__fadd_rn(lay.res_m1, 2.0f));
  lay.dense = dense_l[lvl] != 0;
  lay.mask = static_cast<uint32_t>(lrows_l[lvl]) * kLanes - 1u;
  return lay;
}

// Flat index into one level's (rows * 128) plane of corner base + (cx, cy,
// cz).
__device__ __forceinline__ int xbar_index(const XbarLevel& lay,
                                          const int base[3], int cx, int cy,
                                          int cz) {
  const int x = base[0] + cx, y = base[1] + cy, z = base[2] + cz;
  if (lay.dense) return x + y * lay.res1 + z * lay.res1 * lay.res1;
  return static_cast<int>(nerficg::ngp_hash(x, y, z) & lay.mask);
}

// The corners of one (sample, level): NC == 0 the 8 trilinear corners,
// else NC stochastic ones, into idx and w (8 entries for NC == 0, else NC).
template <int NC>
__device__ __forceinline__ void xbar_corners(const XbarLevel& lay,
                                            const float* __restrict__ pos,
                                            int i, int lvl, uint32_t seed,
                                            int* idx, float* w) {
  int base[3];
  float frac[3];
  nerficg::level_coords(pos, i, lay.res_m1, base, frac);
  if constexpr (NC == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
      idx[c] = xbar_index(lay, base, cx, cy, cz);
      w[c] = nerficg::trilinear_weight(frac, cx, cy, cz);
    }
  } else {
    int off[NC][3];
    nerficg::stoch_corners<NC>(frac, seed, lvl, i, off, w);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      idx[c] = xbar_index(lay, base, off[c][0], off[c][1], off[c][2]);
    }
  }
}

// The two features of a table entry rounded to bf16 (bf16_round's bits),
// packed as one word: feature 0 low, feature 1 high.
__device__ __forceinline__ uint32_t pack_bf16x2(float v0, float v1) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v0))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v1)))
          << 16);
}

// One (sample, level) of the forward, both paths: the corners (saved when
// save_idx is non-null), then per feature the sum over the corners in order
// of the rounded product w_c * v_c (the plain version's products; no
// contraction into FMAs, so the two paths give the same bits). `read(idx)`
// returns the corner's bf16x2 word.
template <int NC, typename Read>
__device__ __forceinline__ float2 xbar_encode(
    const XbarLevel& lay, const float* __restrict__ pos, int i, int lvl,
    int n, uint32_t seed, int* __restrict__ save_idx,
    float* __restrict__ save_w, Read read) {
  constexpr int kMax = NC == 0 ? 8 : NC;
  int idx[kMax];
  float w[kMax];
  xbar_corners<NC>(lay, pos, i, lvl, seed, idx, w);
  if (save_idx != nullptr) {
#pragma unroll
    for (int c = 0; c < kMax; ++c) {
      const size_t at = (static_cast<size_t>(lvl) * kMax + c) * n + i;
      save_idx[at] = idx[c];
      save_w[at] = w[c];
    }
  }
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < kMax; ++c) {
    const uint32_t word = read(idx[c]);
    acc0 = __fadd_rn(acc0, __fmul_rn(w[c], __uint_as_float(word << 16)));
    acc1 = __fadd_rn(acc1,
                     __fmul_rn(w[c], __uint_as_float(word & 0xFFFF0000u)));
  }
  return make_float2(acc0, acc1);
}

// Gather path: one thread per (sample, level), two __ldg per corner.
template <int NC>
__global__ void hash_xbar_fwd_kernel(
    const float* __restrict__ table, const float* __restrict__ pos,
    const float* __restrict__ res_m1_l, const int* __restrict__ lrows_l,
    const int* __restrict__ dense_l, float* __restrict__ out,
    int* __restrict__ save_idx, float* __restrict__ save_w, int n, int levels,
    int rows, uint32_t seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const XbarLevel lay = xbar_level(res_m1_l, lrows_l, dense_l, lvl);
  const float* tab0 = table + static_cast<size_t>(2 * lvl) * rows * kLanes;
  const float* tab1 = tab0 + static_cast<size_t>(rows) * kLanes;
  const float2 v = xbar_encode<NC>(
      lay, pos, i, lvl, n, seed, save_idx, save_w, [&](int idx) {
        return pack_bf16x2(__ldg(tab0 + idx), __ldg(tab1 + idx));
      });
  *reinterpret_cast<float2*>(out + static_cast<size_t>(i) * (2 * levels) +
                             2 * lvl) = v;
}

// Threads of a level-resident forward block and the levels one block owns
// (kernel_timing.py xbar-fwd timed 256-1024 threads and 1-2 levels on an
// H100; PERF.md section 6).
constexpr int kFwdThreads = 1024;
constexpr int kFwdLevels = 2;
// Blocks an SM should hold, which sets the registers a thread may keep: as
// many as its shared memory holds (three 64 KiB levels), at most 1536
// threads (1024 threads: one block, 64 registers).
constexpr int kFwdMinBlocks = 3 / kFwdLevels < 1536 / kFwdThreads
                                  ? 3 / kFwdLevels
                                  : 1536 / kFwdThreads;
static_assert(kFwdMinBlocks >= 1, "a block must fit an SM");

// Level-resident forward: a block per (sample tile, group of kFwdLevels
// levels) stages its levels' tables as bf16x2 words (level g at word
// g * level_rows * 128), then walks its tile's chunks of kFwdThreads
// samples: each corner is one 4-byte shared load, and a sample's kFwdLevels
// levels are written as one contiguous store (16 bytes: two levels' blocks
// complete a 32-byte sector of the row).
template <int NC>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    hash_xbar_fwd_resident_kernel(
        const float* __restrict__ table, const float* __restrict__ pos,
        const float* __restrict__ res_m1_l, const int* __restrict__ lrows_l,
        const int* __restrict__ dense_l, float* __restrict__ out,
        int* __restrict__ save_idx, float* __restrict__ save_w, int n,
        int levels, int rows, int level_rows, int chunks_per_tile,
        uint32_t seed) {
  extern __shared__ __align__(16) uint32_t stab[];
  const int lvl0 = blockIdx.y * kFwdLevels;
  const size_t plane = static_cast<size_t>(rows) * kLanes;
  const int stride = level_rows * kLanes;
  XbarLevel lay[kFwdLevels];
#pragma unroll
  for (int g = 0; g < kFwdLevels; ++g) {
    const int lvl = lvl0 + g;
    lay[g] = xbar_level(res_m1_l, lrows_l, dense_l, lvl);
    const int entries = lrows_l[lvl] * kLanes;
    const float* t0 = table + 2 * lvl * plane;
    for (int e = 4 * threadIdx.x; e < entries; e += 4 * kFwdThreads) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(t0 + e));
      const float4 b = __ldg(reinterpret_cast<const float4*>(t0 + plane + e));
      *reinterpret_cast<uint4*>(stab + g * stride + e) =
          make_uint4(pack_bf16x2(a.x, b.x), pack_bf16x2(a.y, b.y),
                     pack_bf16x2(a.z, b.z), pack_bf16x2(a.w, b.w));
    }
  }
  __syncthreads();

  const int chunks = (n + kFwdThreads - 1) / kFwdThreads;
  const int c0 = blockIdx.x * chunks_per_tile;
  const int c1 = min(chunks, c0 + chunks_per_tile);
  for (int ch = c0; ch < c1; ++ch) {
    const int i = ch * kFwdThreads + threadIdx.x;
    if (i >= n) break;
    float v[2 * kFwdLevels];
#pragma unroll
    for (int g = 0; g < kFwdLevels; ++g) {
      const uint32_t* level = stab + g * stride;
      const float2 f = xbar_encode<NC>(lay[g], pos, i, lvl0 + g, n, seed,
                                       save_idx, save_w,
                                       [&](int idx) { return level[idx]; });
      v[2 * g] = f.x;
      v[2 * g + 1] = f.y;
    }
    float* o = out + static_cast<size_t>(i) * (2 * levels) + 2 * lvl0;
    if constexpr (kFwdLevels == 2) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int g = 0; g < kFwdLevels; ++g) {
        *reinterpret_cast<float2*>(o + 2 * g) =
            make_float2(v[2 * g], v[2 * g + 1]);
      }
    }
  }
}

template <int NC>
__global__ void hash_xbar_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ pos,
    const float* __restrict__ res_m1_l, const int* __restrict__ lrows_l,
    const int* __restrict__ dense_l, float* __restrict__ dtab, int n,
    int levels, int rows, uint32_t seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const float* gi = g + static_cast<size_t>(i) * (2 * levels) + 2 * lvl;
  const float g0 = gi[0];
  const float g1 = gi[1];
  if (g0 == 0.0f && g1 == 0.0f) return;
  const XbarLevel lay = xbar_level(res_m1_l, lrows_l, dense_l, lvl);
  constexpr int kMax = NC == 0 ? 8 : NC;
  int idx[kMax];
  float w[kMax];
  xbar_corners<NC>(lay, pos, i, lvl, seed, idx, w);
  float* d0 = dtab + static_cast<size_t>(2 * lvl) * rows * kLanes;
  float* d1 = d0 + static_cast<size_t>(rows) * kLanes;
#pragma unroll
  for (int c = 0; c < kMax; ++c) {
    atomicAdd(d0 + idx[c], __fmul_rn(g0, w[c]));
    atomicAdd(d1 + idx[c], __fmul_rn(g1, w[c]));
  }
}

template <int NC>
__global__ void hash_xbar_bwd_pos_kernel(
    const float* __restrict__ table, const float* __restrict__ pos,
    const float* __restrict__ g, const float* __restrict__ res_m1_l,
    const int* __restrict__ lrows_l, const int* __restrict__ dense_l,
    float* __restrict__ dpos, int n, int levels, int rows, uint32_t seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int kMax = NC == 0 ? 8 : NC;
  float d[3] = {0.0f, 0.0f, 0.0f};
  for (int lvl = 0; lvl < levels; ++lvl) {
    const float* gi = g + static_cast<size_t>(i) * (2 * levels) + 2 * lvl;
    const float g0 = gi[0];
    const float g1 = gi[1];
    if (g0 == 0.0f && g1 == 0.0f) continue;
    const XbarLevel lay = xbar_level(res_m1_l, lrows_l, dense_l, lvl);
    int base[3];
    float frac[3];
    nerficg::level_coords(pos, i, lay.res_m1, base, frac);
    int off[kMax][3];
    float unused_w[kMax];
    bool exact[3] = {true, true, true};
    if constexpr (NC == 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        off[c][0] = (c >> 2) & 1;
        off[c][1] = (c >> 1) & 1;
        off[c][2] = c & 1;
      }
    } else {
      nerficg::stoch_corners<NC>(frac, seed, lvl, i, off, unused_w, exact);
    }
    const float* tab0 = table + static_cast<size_t>(2 * lvl) * rows * kLanes;
    const float* tab1 = tab0 + static_cast<size_t>(rows) * kLanes;
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < kMax; ++c) {
      const int idx = xbar_index(lay, base, off[c][0], off[c][1], off[c][2]);
      const float v0 = nerficg::bf16_round(__ldg(tab0 + idx));
      const float v1 = nerficg::bf16_round(__ldg(tab1 + idx));
      const float gp = __fadd_rn(__fmul_rn(g0, v0), __fmul_rn(g1, v1));
      float f[3], df[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        f[e] = exact[e] ? (off[c][e] ? frac[e] : __fsub_rn(1.0f, frac[e]))
                        : 1.0f;
        df[e] = exact[e] ? (off[c][e] ? 1.0f : -1.0f) : 0.0f;
      }
      const float other[3] = {__fmul_rn(f[1], f[2]), __fmul_rn(f[0], f[2]),
                              __fmul_rn(f[0], f[1])};
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        acc[e] = __fadd_rn(
            acc[e], __fmul_rn(__fmul_rn(__fmul_rn(gp, df[e]), other[e]),
                              lay.res_m1));
      }
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) d[e] = __fadd_rn(d[e], acc[e]);
  }
  float* o = dpos + static_cast<size_t>(i) * 3;
  o[0] = d[0];
  o[1] = d[1];
  o[2] = d[2];
}

// Threads of a level-resident block (one block per SM: its shared memory).
// The kernel is latency-bound on its shared-memory atomics and reads: on an
// H100, 1024 threads (64 registers, no spills) beat 768 and 512.
constexpr int kResThreads = 1024;

// Shared-memory f32 atomicAdd is a compare-and-swap loop on sm_90, so lanes
// that hit one entry retry in turn. Ray-ordered samples put runs of
// neighbouring lanes on the same corner at the coarse levels. When the
// warp's keys form at most kAggregateRuns runs of equal neighbours, each
// run's values are summed by a segmented shuffle reduction and its first
// lane adds them once; otherwise every lane adds its own. key < 0: nothing
// to add. Called by all 32 lanes.
constexpr int kAggregateRuns = 24;

__device__ __forceinline__ void add_aggregated(float* sg, int entries,
                                               int key, float a, float b) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  if (__popc(heads) <= kAggregateRuns) {
    const unsigned after = heads & ~((2u << lane) - 1u);
    const int end = after != 0u ? __ffs(after) - 1 : 32;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ta = __shfl_down_sync(kFull, a, d);
      const float tb = __shfl_down_sync(kFull, b, d);
      if (lane + d < end) {
        a = __fadd_rn(a, ta);
        b = __fadd_rn(b, tb);
      }
    }
    if (key < 0 || ((heads >> lane) & 1u) == 0u) return;
  } else if (key < 0) {
    return;
  }
  atomicAdd(sg + key, a);
  atomicAdd(sg + entries + key, b);
}

// One (sample tile, level) block of the level-resident backward: stage the
// level (its bf16x2 table when POS, its zeroed f32 gradient when TAB), walk
// the tile's chunks of kResThreads samples, then flush the gradient into
// dtab. With POS, each (level, sample) sum goes to scratch (L, N, 3).
template <int NC, bool TAB, bool POS>
__global__ void __launch_bounds__(kResThreads, 1)
    hash_xbar_bwd_resident_kernel(
        const float* __restrict__ g, const float* __restrict__ pos,
        const float* __restrict__ table, const float* __restrict__ res_m1_l,
        const int* __restrict__ lrows_l, const int* __restrict__ dense_l,
        float* __restrict__ dtab, float* __restrict__ scratch, int n,
        int levels, int rows, int chunks_per_tile, uint32_t seed) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lvl = blockIdx.y;
  const XbarLevel lay = xbar_level(res_m1_l, lrows_l, dense_l, lvl);
  const int entries = lrows_l[lvl] * kLanes;
  const size_t plane = static_cast<size_t>(rows) * kLanes;
  float* sg = reinterpret_cast<float*>(smem);
  uint32_t* stab = smem + (TAB ? 2 * entries : 0);
  for (int e = 4 * threadIdx.x; e < entries; e += 4 * kResThreads) {
    if constexpr (TAB) {
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(sg + e) = zero;
      *reinterpret_cast<float4*>(sg + entries + e) = zero;
    }
    if constexpr (POS) {
      const float* t0 = table + 2 * lvl * plane + e;
      const float4 a = __ldg(reinterpret_cast<const float4*>(t0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(t0 + plane));
      *reinterpret_cast<uint4*>(stab + e) =
          make_uint4(pack_bf16x2(a.x, b.x), pack_bf16x2(a.y, b.y),
                     pack_bf16x2(a.z, b.z), pack_bf16x2(a.w, b.w));
    }
  }
  __syncthreads();

  constexpr int kMax = NC == 0 ? 8 : NC;
  const int chunks = (n + kResThreads - 1) / kResThreads;
  const int c0 = blockIdx.x * chunks_per_tile;
  const int c1 = min(chunks, c0 + chunks_per_tile);
  for (int ch = c0; ch < c1; ++ch) {
    const int i = ch * kResThreads + threadIdx.x;
    float g0 = 0.0f;
    float g1 = 0.0f;
    if (i < n) {
      const float* gi = g + static_cast<size_t>(i) * (2 * levels) + 2 * lvl;
      g0 = gi[0];
      g1 = gi[1];
    }
    // A lane past n or with both cotangents 0 adds nothing; a warp of such
    // lanes skips the level. The others keep every lane converged for the
    // table gradient's warp aggregation.
    const bool active = g0 != 0.0f || g1 != 0.0f;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    if (__any_sync(0xFFFFFFFFu, active)) {
      int base[3];
      float frac[3];
      nerficg::level_coords(pos, min(i, n - 1), lay.res_m1, base, frac);
      int off[kMax][3];
      float w[kMax];
      bool exact[3] = {true, true, true};
      if constexpr (NC == 0) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          off[c][0] = (c >> 2) & 1;
          off[c][1] = (c >> 1) & 1;
          off[c][2] = c & 1;
          w[c] = nerficg::trilinear_weight(frac, off[c][0], off[c][1],
                                           off[c][2]);
        }
      } else {
        nerficg::stoch_corners<NC>(frac, seed, lvl, i, off, w, exact);
      }
#pragma unroll
      for (int c = 0; c < kMax; ++c) {
        const int idx =
            xbar_index(lay, base, off[c][0], off[c][1], off[c][2]);
        if constexpr (TAB) {
          add_aggregated(sg, entries, active ? idx : -1,
                         __fmul_rn(g0, w[c]), __fmul_rn(g1, w[c]));
        }
        if constexpr (POS) {
          if (active) {
            const uint32_t word = stab[idx];
            const float v0 = __uint_as_float(word << 16);
            const float v1 = __uint_as_float(word & 0xFFFF0000u);
            const float gp = __fadd_rn(__fmul_rn(g0, v0), __fmul_rn(g1, v1));
            float f[3], df[3];
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              f[e] = exact[e]
                         ? (off[c][e] ? frac[e] : __fsub_rn(1.0f, frac[e]))
                         : 1.0f;
              df[e] = exact[e] ? (off[c][e] ? 1.0f : -1.0f) : 0.0f;
            }
            const float other[3] = {__fmul_rn(f[1], f[2]),
                                    __fmul_rn(f[0], f[2]),
                                    __fmul_rn(f[0], f[1])};
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              acc[e] = __fadd_rn(
                  acc[e], __fmul_rn(__fmul_rn(__fmul_rn(gp, df[e]), other[e]),
                                    lay.res_m1));
            }
          }
        }
      }
    }
    if constexpr (POS) {
      if (i < n) {
        float* s = scratch + (static_cast<size_t>(lvl) * n + i) * 3;
        s[0] = acc[0];
        s[1] = acc[1];
        s[2] = acc[2];
      }
    }
  }

  if constexpr (TAB) {
    __syncthreads();
    float* d0 = dtab + 2 * lvl * plane;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      for (int e = 4 * threadIdx.x; e < entries; e += 4 * kResThreads) {
        const float4 v =
            *reinterpret_cast<const float4*>(sg + f * entries + e);
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
          atomicAdd(reinterpret_cast<float4*>(d0 + f * plane + e), v);
        }
      }
    }
  }
}

// dpos (N, 3) from the resident kernel's scratch (L, N, 3): each sample's L
// level sums added in level order, so dpos is the plain version's bits
// whichever level block finished first. A second launch: a last-block
// handshake in the resident kernel (a counter per chunk and a threadfence)
// measured slower on an H100.
__global__ void hash_xbar_sum_levels_kernel(const float* __restrict__ scratch,
                                            float* __restrict__ dpos, int n,
                                            int levels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float d[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < levels; ++l) {
    const float* s = scratch + (static_cast<size_t>(l) * n + i) * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e) d[e] = __fadd_rn(d[e], s[e]);
  }
  float* o = dpos + static_cast<size_t>(i) * 3;
  o[0] = d[0];
  o[1] = d[1];
  o[2] = d[2];
}

template <int NC>
cudaError_t launch_fwd(const void* table, const void* pos, const void* res_m1,
                       const void* lrows, const void* dense, void* out,
                       void* save_idx, void* save_w, int levels, int n,
                       int rows, int level_rows, int tiles, uint32_t seed,
                       cudaStream_t stream) {
  const float* t = static_cast<const float*>(table);
  const float* p = static_cast<const float*>(pos);
  const float* r = static_cast<const float*>(res_m1);
  const int* lr = static_cast<const int*>(lrows);
  const int* d = static_cast<const int*>(dense);
  float* o = static_cast<float*>(out);
  int* si = static_cast<int*>(save_idx);
  float* sw = static_cast<float*>(save_w);
  if (tiles == 0) {  // gather path
    const dim3 grid((n + 255) / 256, levels);
    hash_xbar_fwd_kernel<NC><<<grid, 256, 0, stream>>>(
        t, p, r, lr, d, o, si, sw, n, levels, rows, seed);
    return cudaGetLastError();
  }
  const int smem = kFwdLevels * level_rows * kLanes * 4;
  // Per launch, not once: the attribute belongs to the current device.
  const cudaError_t err = cudaFuncSetAttribute(
      hash_xbar_fwd_resident_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (n + kFwdThreads - 1) / kFwdThreads;
  const dim3 grid(tiles, levels / kFwdLevels);
  hash_xbar_fwd_resident_kernel<NC><<<grid, kFwdThreads, smem, stream>>>(
      t, p, r, lr, d, o, si, sw, n, levels, rows, level_rows,
      (chunks + tiles - 1) / tiles, seed);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd(const void* g, const void* pos, const void* res_m1,
                       const void* lrows, const void* dense, void* dtab,
                       int levels, int n, int rows, uint32_t seed,
                       cudaStream_t stream) {
  if (n == 0) return cudaGetLastError();
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_xbar_bwd_kernel<NC><<<grid, block, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(pos),
      static_cast<const float*>(res_m1), static_cast<const int*>(lrows),
      static_cast<const int*>(dense), static_cast<float*>(dtab), n, levels,
      rows, seed);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd_pos(const void* table, const void* pos, const void* g,
                           const void* res_m1, const void* lrows,
                           const void* dense, void* dpos, int levels, int n,
                           int rows, uint32_t seed, cudaStream_t stream) {
  if (n == 0) return cudaGetLastError();
  const int block = 128;
  hash_xbar_bwd_pos_kernel<NC><<<(n + block - 1) / block, block, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(pos),
      static_cast<const float*>(g), static_cast<const float*>(res_m1),
      static_cast<const int*>(lrows), static_cast<const int*>(dense),
      static_cast<float*>(dpos), n, levels, rows, seed);
  return cudaGetLastError();
}

template <int NC, bool TAB, bool POS>
cudaError_t launch_resident(const void* g, const void* pos, const void* table,
                            const void* res_m1, const void* lrows,
                            const void* dense, void* dtab, void* dpos,
                            void* scratch, int levels, int n, int rows,
                            int level_rows, int tiles, uint32_t seed,
                            cudaStream_t stream) {
  const auto kernel = hash_xbar_bwd_resident_kernel<NC, TAB, POS>;
  const int smem = level_rows * kLanes * ((TAB ? 8 : 0) + (POS ? 4 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (n + kResThreads - 1) / kResThreads;
  const int per_tile = (chunks + tiles - 1) / tiles;
  kernel<<<dim3(tiles, levels), kResThreads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(pos),
      static_cast<const float*>(table), static_cast<const float*>(res_m1),
      static_cast<const int*>(lrows), static_cast<const int*>(dense),
      static_cast<float*>(dtab), static_cast<float*>(scratch), n, levels,
      rows, per_tile, seed);
  if (POS) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    hash_xbar_sum_levels_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(scratch), static_cast<float*>(dpos), n,
        levels);
  }
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd_fused(const void* g, const void* pos,
                             const void* table, const void* res_m1,
                             const void* lrows, const void* dense, void* dtab,
                             void* dpos, void* scratch, int levels, int n,
                             int rows, int level_rows, int tiles,
                             uint32_t seed, cudaStream_t stream) {
  if (tiles == 0) {  // gather path
    cudaError_t err = cudaSuccess;
    if (dtab != nullptr) {
      err = launch_bwd<NC>(g, pos, res_m1, lrows, dense, dtab, levels, n,
                           rows, seed, stream);
    }
    if (err == cudaSuccess && dpos != nullptr) {
      err = launch_bwd_pos<NC>(table, pos, g, res_m1, lrows, dense, dpos,
                               levels, n, rows, seed, stream);
    }
    return err;
  }
  if (dtab != nullptr && dpos != nullptr) {
    return launch_resident<NC, true, true>(g, pos, table, res_m1, lrows,
                                           dense, dtab, dpos, scratch, levels,
                                           n, rows, level_rows, tiles, seed,
                                           stream);
  }
  if (dtab != nullptr) {
    return launch_resident<NC, true, false>(g, pos, table, res_m1, lrows,
                                            dense, dtab, dpos, scratch,
                                            levels, n, rows, level_rows,
                                            tiles, seed, stream);
  }
  return launch_resident<NC, false, true>(g, pos, table, res_m1, lrows, dense,
                                          dtab, dpos, scratch, levels, n,
                                          rows, level_rows, tiles, seed,
                                          stream);
}

}  // namespace

// table (L, 2, rows, 128) f32; pos (N, 3) f32 in [0, 1); per-level layout
// res_m1 (L,) f32, lrows (L,) i32, dense (L,) i32; out (N, L*2) f32;
// n_corners 0 (exact) or 1, 2, 4 (stochastic, drawn from seed); save_idx
// (L, C, N) i32 and save_w (L, C, N) f32, C = 8 or n_corners, are written
// when non-null. level_rows is the largest level's rows; tiles > 0 takes the
// level-resident path with that many sample tiles (levels a multiple of the
// levels a block owns), tiles == 0 the gather path.
extern "C" int nerficg_hash_xbar_fwd(const void* table, const void* pos,
                                     const void* res_m1, const void* lrows,
                                     const void* dense, void* out,
                                     void* save_idx, void* save_w, int levels,
                                     int n, int rows, int level_rows,
                                     int tiles, int n_corners,
                                     unsigned int seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles < 0 || levels <= 0 || level_rows <= 0 || level_rows > rows ||
      (tiles > 0 && levels % kFwdLevels != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  switch (n_corners) {
    case 0:
      return static_cast<int>(launch_fwd<0>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, level_rows, tiles, seed, s));
    case 1:
      return static_cast<int>(launch_fwd<1>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, level_rows, tiles, seed, s));
    case 2:
      return static_cast<int>(launch_fwd<2>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, level_rows, tiles, seed, s));
    case 4:
      return static_cast<int>(launch_fwd<4>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, level_rows, tiles, seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The crossbar backward: the table gradient dtab (L, 2, rows, 128) f32
// when dtab is non-null, the position gradient dpos (N, 3) f32 when dpos is
// non-null, at least one of them. g (N, L*2) f32; pos (N, 3) f32 in
// [0, 1); table (L, 2, rows, 128) f32 (read only for dpos); the layout,
// n_corners and seed as for the forward; level_rows the largest level's
// rows. tiles > 0 takes the level-resident path with that many sample
// tiles (and, for dpos, scratch (L, N, 3) f32); tiles == 0 takes the
// gather path. dtab is zeroed here.
extern "C" int nerficg_hash_xbar_bwd_fused(
    const void* g, const void* pos, const void* table, const void* res_m1,
    const void* lrows, const void* dense, void* dtab, void* dpos,
    void* scratch, int levels, int n, int rows, int level_rows, int tiles,
    int n_corners, unsigned int seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtab == nullptr && dpos == nullptr) || tiles < 0 || levels <= 0 ||
      level_rows <= 0 || level_rows > rows ||
      (tiles > 0 && dpos != nullptr && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtab != nullptr) {
    const size_t bytes =
        static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
    const cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  switch (n_corners) {
    case 0:
      return static_cast<int>(launch_bwd_fused<0>(
          g, pos, table, res_m1, lrows, dense, dtab, dpos, scratch, levels, n,
          rows, level_rows, tiles, seed, s));
    case 1:
      return static_cast<int>(launch_bwd_fused<1>(
          g, pos, table, res_m1, lrows, dense, dtab, dpos, scratch, levels, n,
          rows, level_rows, tiles, seed, s));
    case 2:
      return static_cast<int>(launch_bwd_fused<2>(
          g, pos, table, res_m1, lrows, dense, dtab, dpos, scratch, levels, n,
          rows, level_rows, tiles, seed, s));
    case 4:
      return static_cast<int>(launch_bwd_fused<4>(
          g, pos, table, res_m1, lrows, dense, dtab, dpos, scratch, levels, n,
          rows, level_rows, tiles, seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
