// Windowed multiresolution hash encode: forward (exact 8 corners or
// stochastic corners) and its two table-gradient kernels.
//
// Forward. Replaces the TPU kernel nerficg_tpu/ops/hash_window.py
// `_fwd_kernel` (:468, launched by `_fwd_pallas` :709). It computes the same
// function as the jnp oracle `_fwd_jnp` (:379): per (sample, level) the
// trilinear corners, their table address by `_row_lane` (dense linear index,
// or brick morton row * rpb + hash bits), the wrap of that row into the
// sample's 8192-sample sub-block window [lo, lo + win) by `_wrap_rel`, a
// bf16-rounded read of both features, and the weighted sum. Output is
// feature-major (L*2, N), as the JAX package's MLP consumes it.
//
// Stochastic mode (n_corners in {1, 2, 4}, `_stoch_corners` of
// nerficg_tpu/ops/hash_xbar.py :176) evaluates n corners per (sample, level):
// log2(n) dims exactly, by min(f, 1-f), the rest drawn ~ Bernoulli(f). The
// TPU draws its bits with pltpu.prng_random_bits; here three 32-bit words per
// (sample, level) come from a counter hash keyed by (seed, level, sample,
// dim), the same words nerficg_torch/ops/counter_rng.py computes, so kernel
// and plain version choose identical corners. With saves, the forward also
// writes each corner's absolute flat table index (int32) and weight (f32),
// each (L, nc, N): the cached backward scatters from them without recomputing
// corners (the TPU packs rel<<7|lane; the function is the same).
//
// Backward. `hash_window_bwd` replaces `_bwd_kernel` (:526, launched by
// `_bwd_pallas` :779): the table gradient of the exact encode, recomputing
// corners; `hash_window_bwd_cached` replaces `_bwd_kernel_cached` (:630,
// `_bwd_pallas_cached` :824): the table gradient from the saved streams.
// The gradient passes straight through the bf16 read: each corner adds the
// f32 product g[2l+f, i] * w_c, as the oracle `_bwd_jnp` (:395) does (the TPU
// kernel rounds g*w to bf16 for its MXU; the port follows the oracle). The
// TPU kernels zero their output at grid step 0 and accumulate over sequential
// grid steps in VMEM; blocks here run in parallel, so the wrapper's output is
// zeroed with cudaMemsetAsync on the stream and every corner adds with an
// fp32 atomicAdd (summation order varies from run to run).
//
// What bounds them on an H100: 16 random 4-byte reads (forward) or 16 atomic
// adds (backward) per (sample, level) with exact corners, 2*nc stochastic. At
// 2^14 entries the whole table is 16 levels x 2 x 64 KiB = 2 MiB and stays in
// the 50 MB L2, so reads and atomics are L2 operations, and the exact
// forward's least time is its feature-major output, 8 bytes per (sample,
// level). The gradients and the stochastic forward: one thread per (sample,
// level) with the level on blockIdx.y keeps the dense/hash branch uniform
// per block and the feature-major loads and stores coalesced. The
// backward's atomics contend at coarse levels: samples arrive morton-sorted,
// so neighbouring threads of a warp hit the same vertex (level 0 has 16^3
// vertices for 65,536 x 8 corner adds) and same-address atomics serialise;
// a warp-level pre-aggregation (__match_any_sync) is the next redesign.
//
// The exact forward's design. By the wrap, every corner of an 8192-sample
// sub-block lies in rows [lo, lo + win) of its level: win x 128 entries
// per feature, contiguous from lo * 128. A block owns a tile of one
// sub-block's samples at one level, grid (N / tile, L) (the tile by the
// call's size, see kFwdTile), and chooses its path
// at run time from its own win, so the host never synchronises:
//   * window-resident, when win <= kFwdWinRows rows (512 bytes each): the
//     block stages the window's entries of both features as bf16x2 words
//     in dynamic shared memory (16-byte loads from L2, rounded as
//     bf16_round rounds), then each corner is one 4-byte shared load where
//     the gather paid two 32-byte L2 sectors. At 2^14 entries a hashed
//     level has 128 rows and a serving chunk's morton-sorted windows
//     14-64, so at the library's width every block of it takes this path;
//   * global, for wider windows (larger tables, unsorted samples, small
//     calls): the parent's gather, two __ldg per corner.
// Both paths sum with trilinear_sum in one order, so they give the same
// bits (and the parent's, whose gather summed the same expression). The
// blocks of one sub-block each stage the same window, which L2 serves. A
// sample's 8 corner addresses share their per-dimension terms
// (CornerTerms: each brick coordinate's morton bits and hash term, once
// per dimension and offset, not once per corner: 0.0468 against 0.0604 ms
// at a serving chunk, an NVIDIA H100 80GB HBM3 at 700 W); what is left per
// corner is the wrap and the sum. Those instructions are the suspected
// pace setter, not memory (the 25 MB output alone would take 0.0075 ms at
// 3.35 TB/s); no profiler run has shown it yet.
//
// Rounding: `scaled`, `frac`, the brick product, the wrap reciprocal, the
// wrap product and the corner weights use the _rn intrinsics, so nvcc cannot
// contract them into FMAs: they must equal the plain version's f32 results
// bit for bit (a one-ulp difference moves a corner across a row). Only the
// final weighted sum may contract; it is compared with a tolerance.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_common.cuh"

namespace {

using nerficg::kLanes;

constexpr int kSubBlockN = 64 * 128;  // samples per window sub-block

struct LevelLayout {
  int res;
  bool dense;
  float bscale;
  uint32_t rpb;
};

__device__ __forceinline__ LevelLayout level_layout(
    const int* res_l, const int* dense_l, const float* bscale_l,
    const int* rpb_l, int lvl) {
  LevelLayout lay;
  lay.res = res_l[lvl];
  lay.dense = dense_l[lvl] != 0;
  lay.bscale = bscale_l[lvl];
  lay.rpb = static_cast<uint32_t>(rpb_l[lvl]);
  return lay;
}

// One sample at one level: integer base vertex, fractional offset, window.
struct SampleLevel {
  int base[3];
  float frac[3];
  nerficg::Window w;
};

__device__ __forceinline__ SampleLevel sample_level(
    const float* __restrict__ pos, const nerficg::Window& w,
    const LevelLayout& lay, int i) {
  SampleLevel s;
  nerficg::level_coords(pos, i, static_cast<float>(lay.res - 1), s.base,
                        s.frac);
  s.w = w;
  return s;
}

// The same, reading sample i's window from the (L, nsb) lo / win.
__device__ __forceinline__ SampleLevel sample_level(
    const float* __restrict__ pos, const int* __restrict__ lo,
    const int* __restrict__ win, const LevelLayout& lay, int i, int lvl,
    int nsb) {
  return sample_level(
      pos, nerficg::window_at(lo, win, lvl * nsb + i / kSubBlockN), lay, i);
}

// Flat index into one level's (rows * 128) feature plane of the corner at
// base + (cx, cy, cz): `_row_lane`, then `_wrap_rel` into the window.
__device__ __forceinline__ int corner_index(const LevelLayout& lay,
                                            const SampleLevel& s, int cx,
                                            int cy, int cz) {
  const int vx = s.base[0] + cx, vy = s.base[1] + cy, vz = s.base[2] + cz;
  int row, lane;
  if (lay.dense) {
    const int lin = vx * (lay.res * lay.res) + vy * lay.res + vz;
    row = lin >> 7;
    lane = lin & (kLanes - 1);
  } else {
    const int bx = static_cast<int>(__fmul_rn(static_cast<float>(vx), lay.bscale));
    const int by = static_cast<int>(__fmul_rn(static_cast<float>(vy), lay.bscale));
    const int bz = static_cast<int>(__fmul_rn(static_cast<float>(vz), lay.bscale));
    const uint32_t h = nerficg::ngp_hash(vx, vy, vz);
    row = nerficg::morton3(bx, by, bz) * static_cast<int>(lay.rpb) +
          static_cast<int>((h >> 7) & (lay.rpb - 1u));
    lane = static_cast<int>(h & (kLanes - 1));
  }
  return nerficg::wrap_into(s.w, row) * kLanes + lane;
}

// The per-dimension terms of one (sample, level)'s 8 corner addresses,
// computed once: on hashed levels the brick's morton bits (morton_spread of
// floor(v * bscale)) and the hash's term (v times its prime), on dense ones
// the linear index's term, for v = base + 0 and base + 1 in each dimension.
// A corner's row and lane then combine one term of each dimension, the
// same integers corner_index computes.
struct CornerTerms {
  int m[3][2];
  uint32_t h[3][2];
};

__device__ __forceinline__ CornerTerms corner_terms(const LevelLayout& lay,
                                                    const SampleLevel& s) {
  const int scale[3] = {lay.res * lay.res, lay.res, 1};
  const uint32_t prime[3] = {1u, nerficg::kP1, nerficg::kP2};
  CornerTerms t;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int v = s.base[d] + o;
      if (lay.dense) {
        t.m[d][o] = v * scale[d];
        t.h[d][o] = 0u;
      } else {
        t.m[d][o] = nerficg::morton_spread(
            static_cast<int>(__fmul_rn(static_cast<float>(v), lay.bscale)),
            2 - d);
        t.h[d][o] = static_cast<uint32_t>(v) * prime[d];
      }
    }
  }
  return t;
}

// corner_index of corner (cx, cy, cz) from the sample's corner terms.
__device__ __forceinline__ int corner_index(const LevelLayout& lay,
                                            const SampleLevel& s,
                                            const CornerTerms& t, int cx,
                                            int cy, int cz) {
  int row, lane;
  if (lay.dense) {
    const int lin = t.m[0][cx] + t.m[1][cy] + t.m[2][cz];
    row = lin >> 7;
    lane = lin & (kLanes - 1);
  } else {
    const uint32_t h = t.h[0][cx] ^ t.h[1][cy] ^ t.h[2][cz];
    row = (t.m[0][cx] | t.m[1][cy] | t.m[2][cz]) * static_cast<int>(lay.rpb) +
          static_cast<int>((h >> 7) & (lay.rpb - 1u));
    lane = static_cast<int>(h & (kLanes - 1));
  }
  return nerficg::wrap_into(s.w, row) * kLanes + lane;
}

// Threads of an exact forward block; the samples it owns, its tile (a
// divisor of kSubBlockN: the sub-block's window is split over kSubBlockN /
// tile blocks, which each stage it), kFwdTileLarge for calls of at least
// kFwdLargeN samples, where fewer blocks still fill the card, else
// kFwdTile; and the widest window a block stages in shared memory, in rows
// of 128 bf16x2 words (the wrapper's FWD_WIN_ROWS). Swept on an NVIDIA
// H100 80GB HBM3 at 700 W (`kernel_timing.py window-fwd`, variants
// NAME=PATH:CONST=N; PERF.md section 6), ms at a serving chunk's 196,608
// sorted samples / at 8,192: tiles of 2048 0.0444 / 0.0097, of 1024
// 0.0468 / 0.0056 (parent 0.0776 / 0.0057), of 2048 faster from 65,536
// samples on (0.0174 against 0.0183); 64 rows 0.0468, 128 rows 0.0486
// (three blocks an SM, not four), 32 rows 0.0484, 0 (every block global)
// 0.0576. Unsorted samples put most blocks on the global path, and the
// shared memory the staged ones reserve takes the L1 that the gathers
// lean on: 0.1632 against the parent's 0.0887 (128 rows, every window
// staged: 0.0676).
constexpr int kFwdThreads = 512;
constexpr int kFwdTile = 1024;
constexpr int kFwdTileLarge = 2048;
constexpr int kFwdLargeN = 65536;
constexpr int kFwdWinRows = 64;
static_assert(kSubBlockN % kFwdTileLarge == 0 && kSubBlockN % kFwdTile == 0,
              "a block's samples in one window");
static_assert(kFwdTile % kFwdThreads == 0 && kFwdTileLarge % kFwdThreads == 0,
              "whole samples per thread");
// Blocks an SM should hold: 2048 threads, which caps a thread at 32
// registers (at 58 the first build held half as many threads).
constexpr int kFwdMinBlocks = 2048 / kFwdThreads;

// One (tile, level) block of the exact forward, window-resident or global
// by its sub-block's win.
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    hash_window_fwd_kernel(
    const float* __restrict__ table, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    float* __restrict__ out, int n, int nsb, int rows, int tile) {
  extern __shared__ __align__(16) uint32_t swin[];
  const int lvl = blockIdx.y;
  const int i0 = blockIdx.x * tile;
  const nerficg::Window w =
      nerficg::window_at(lo, win, lvl * nsb + i0 / kSubBlockN);
  const bool resident = w.win <= kFwdWinRows;
  const size_t plane = static_cast<size_t>(rows) * kLanes;
  const float* tab0 = table + static_cast<size_t>(2 * lvl) * plane;
  const float* tab1 = tab0 + plane;
  // The window's first entry in the level's plane.
  const int first = w.lo * kLanes;
  if (resident) {
    nerficg::stage_window_bf16x2<kFwdThreads>(tab0 + first, tab1 + first,
                                              w.win * kLanes, swin);
    __syncthreads();
  }
  const LevelLayout lay = level_layout(res_l, dense_l, bscale_l, rpb_l, lvl);
#pragma unroll 1
  for (int r = 0; r < tile / kFwdThreads; ++r) {
    const int i = i0 + r * kFwdThreads + threadIdx.x;
    const SampleLevel s = sample_level(pos, w, lay, i);
    const CornerTerms terms = corner_terms(lay, s);
    const auto corner = [&](int c) {
      return corner_index(lay, s, terms, (c >> 2) & 1, (c >> 1) & 1, c & 1);
    };
    const float2 acc =
        resident ? nerficg::trilinear_sum(s.frac, [&](int c) {
          return nerficg::bf16x2_features(swin[corner(c) - first]);
        })
                 : nerficg::trilinear_sum(s.frac, [&](int c) {
                     const int idx = corner(c);
                     return make_float2(nerficg::bf16_round(__ldg(tab0 + idx)),
                                        nerficg::bf16_round(__ldg(tab1 + idx)));
                   });
    out[static_cast<size_t>(2 * lvl) * n + i] = acc.x;
    out[static_cast<size_t>(2 * lvl + 1) * n + i] = acc.y;
  }
}

// Stochastic corners, NC in {1, 2, 4}, with optional saves of (absolute
// index, weight) per corner: one thread per (sample, level).
template <int NC>
__global__ void hash_window_fwd_stoch_kernel(
    const float* __restrict__ table, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    float* __restrict__ out, int* __restrict__ save_idx,
    float* __restrict__ save_w, int n, int nsb, int rows, uint32_t seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const LevelLayout lay = level_layout(res_l, dense_l, bscale_l, rpb_l, lvl);
  const SampleLevel s = sample_level(pos, lo, win, lay, i, lvl, nsb);
  const float* tab0 = table + static_cast<size_t>(2 * lvl) * rows * kLanes;
  const float* tab1 = tab0 + static_cast<size_t>(rows) * kLanes;
  float acc0 = 0.0f;
  float acc1 = 0.0f;
  int off[NC][3];
  float w[NC];
  nerficg::stoch_corners<NC>(s.frac, seed, lvl, i, off, w);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int idx = corner_index(lay, s, off[c][0], off[c][1], off[c][2]);
    acc0 += w[c] * nerficg::bf16_round(__ldg(tab0 + idx));
    acc1 += w[c] * nerficg::bf16_round(__ldg(tab1 + idx));
    if (save_idx != nullptr) {
      const size_t at = (static_cast<size_t>(lvl) * NC + c) * n + i;
      save_idx[at] = idx;
      save_w[at] = w[c];
    }
  }
  out[static_cast<size_t>(2 * lvl) * n + i] = acc0;
  out[static_cast<size_t>(2 * lvl + 1) * n + i] = acc1;
}

__global__ void hash_window_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    float* __restrict__ dtab, int n, int nsb, int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const float g0 = g[static_cast<size_t>(2 * lvl) * n + i];
  const float g1 = g[static_cast<size_t>(2 * lvl + 1) * n + i];
  if (g0 == 0.0f && g1 == 0.0f) return;  // padding samples add nothing
  const LevelLayout lay = level_layout(res_l, dense_l, bscale_l, rpb_l, lvl);
  const SampleLevel s = sample_level(pos, lo, win, lay, i, lvl, nsb);
  float* d0 = dtab + static_cast<size_t>(2 * lvl) * rows * kLanes;
  float* d1 = d0 + static_cast<size_t>(rows) * kLanes;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    const int idx = corner_index(lay, s, cx, cy, cz);
    const float w = nerficg::trilinear_weight(s.frac, cx, cy, cz);
    atomicAdd(d0 + idx, __fmul_rn(g0, w));
    atomicAdd(d1 + idx, __fmul_rn(g1, w));
  }
}

__global__ void hash_window_bwd_cached_kernel(
    const float* __restrict__ g, const int* __restrict__ save_idx,
    const float* __restrict__ save_w, float* __restrict__ dtab, int n,
    int nc, int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const float g0 = g[static_cast<size_t>(2 * lvl) * n + i];
  const float g1 = g[static_cast<size_t>(2 * lvl + 1) * n + i];
  if (g0 == 0.0f && g1 == 0.0f) return;
  float* d0 = dtab + static_cast<size_t>(2 * lvl) * rows * kLanes;
  float* d1 = d0 + static_cast<size_t>(rows) * kLanes;
  for (int c = 0; c < nc; ++c) {
    const size_t at = (static_cast<size_t>(lvl) * nc + c) * n + i;
    const int idx = save_idx[at];
    const float w = save_w[at];
    atomicAdd(d0 + idx, __fmul_rn(g0, w));
    atomicAdd(d1 + idx, __fmul_rn(g1, w));
  }
}

template <int NC>
cudaError_t launch_fwd_stoch(const void* table, const void* pos,
                             const void* lo, const void* win, const void* res,
                             const void* dense, const void* bscale,
                             const void* rpb, void* out, void* save_idx,
                             void* save_w, int levels, int n, int nsb,
                             int rows, uint32_t seed, cudaStream_t stream) {
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_window_fwd_stoch_kernel<NC><<<grid, block, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<float*>(out), static_cast<int*>(save_idx),
      static_cast<float*>(save_w), n, nsb, rows, seed);
  return cudaGetLastError();
}

}  // namespace

// table (L, 2, rows, 128) f32; pos (N, 3) f32, N a multiple of 8192;
// lo/win (L, nsb) i32; per-level layout res/dense/bscale/rpb (L,);
// out (L*2, N) f32.
extern "C" int nerficg_hash_window_fwd(
    const void* table, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    void* out, int levels, int n, int nsb, int rows, void* stream) {
  if (nsb == 0 || levels == 0) return static_cast<int>(cudaGetLastError());
  constexpr int smem = kFwdWinRows * kLanes * 4;
  if (smem > 48 * 1024) {
    // Per launch, not once: the attribute belongs to the current device.
    const cudaError_t err = cudaFuncSetAttribute(
        hash_window_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tile = n >= kFwdLargeN ? kFwdTileLarge : kFwdTile;
  hash_window_fwd_kernel<<<dim3(n / tile, levels), kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<float*>(out), n, nsb, rows, tile);
  return static_cast<int>(cudaGetLastError());
}

// As nerficg_hash_window_fwd with n_corners in {1, 2, 4} stochastic corners
// drawn from `seed`; save_idx (L, nc, N) i32 and save_w (L, nc, N) f32 are
// written when non-null.
extern "C" int nerficg_hash_window_fwd_stoch(
    const void* table, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    void* out, void* save_idx, void* save_w, int levels, int n, int nsb,
    int rows, int n_corners, unsigned int seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_corners) {
    case 1:
      return static_cast<int>(launch_fwd_stoch<1>(
          table, pos, lo, win, res, dense, bscale, rpb, out, save_idx,
          save_w, levels, n, nsb, rows, seed, s));
    case 2:
      return static_cast<int>(launch_fwd_stoch<2>(
          table, pos, lo, win, res, dense, bscale, rpb, out, save_idx,
          save_w, levels, n, nsb, rows, seed, s));
    case 4:
      return static_cast<int>(launch_fwd_stoch<4>(
          table, pos, lo, win, res, dense, bscale, rpb, out, save_idx,
          save_w, levels, n, nsb, rows, seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g (L*2, N) f32; pos, lo, win and the layout as for the forward;
// dtab (L, 2, rows, 128) f32, zeroed here.
extern "C" int nerficg_hash_window_bwd(
    const void* g, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    void* dtab, int levels, int n, int nsb, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_window_bwd_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<float*>(dtab), n, nsb, rows);
  return static_cast<int>(cudaGetLastError());
}

// g (L*2, N) f32; save_idx (L, nc, N) i32; save_w (L, nc, N) f32;
// dtab (L, 2, rows, 128) f32, zeroed here.
extern "C" int nerficg_hash_window_bwd_cached(
    const void* g, const void* save_idx, const void* save_w, void* dtab,
    int levels, int n, int nc, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_window_bwd_cached_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(g), static_cast<const int*>(save_idx),
      static_cast<const float*>(save_w), static_cast<float*>(dtab), n, nc,
      rows);
  return static_cast<int>(cudaGetLastError());
}
