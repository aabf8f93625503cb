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
// kernel rounds g*w to bf16 for its MXU; the port follows the oracle).
// Summation order varies from run to run (atomics).
//
// What bounds them on an H100: 16 random 4-byte reads (forward) or 16 atomic
// adds (backward) per (sample, level) with exact corners, 2*nc stochastic. At
// 2^14 entries the whole table is 16 levels x 2 x 64 KiB = 2 MiB and stays in
// the 50 MB L2, so reads and atomics are L2 operations, and the exact
// forward's least time is its feature-major output, 8 bytes per (sample,
// level). The stochastic forward: one thread per (sample, level) with the
// level on blockIdx.y keeps the dense/hash branch uniform per block and the
// feature-major loads and stores coalesced.
//
// The table gradients' design, one accumulation for both (`accumulate`,
// templated on where a sample's corners come from: #3's saved streams, or
// #2's positions, whose 8 corners are computed in registers from #1's
// per-dimension terms and the same _rn address math). The TPU kernels
// keep the level's gradient in VMEM over their sequential grid; what
// carries over is the level: at the library's 2^14 entries a level's
// gradient, both features, is 128 rows x 128 x 2 x 4 bytes = 128 KiB,
// which one block's shared memory holds. So kBwdLevelBlocks blocks share
// each level, grid (kBwdLevelBlocks, L): each zeroes the level's two
// planes in its shared memory, takes a contiguous share of the samples in
// whole 128-sample groups (the next chunk's cotangents and streams or
// positions loaded while the current one adds), and adds each corner's two
// products there with f32 atomics (compare-and-swap loops on sm_90).
// Before it adds, a warp whose neighbouring lanes share an entry
// (morton-sorted samples on the coarse levels) sums its lanes of equal
// entries (__match_any_sync and a tree of shuffles) so each entry is added
// once; the other warps skip that sum, which costs more than the few
// atomics it would save. Then each block adds its planes' non-zero quads
// to the table, zeroed by cudaMemsetAsync first, with one 16-byte
// atomicAdd each. Tables whose level exceeds kBwdMaxRows rows (a 2^16
// table's 512) take the global path: the same warp sums, then an fp32
// atomicAdd per entry into the table. Measured against this for #3 on an
// H100 80GB HBM3 at 700 W (`kernel_timing.py window-bwd`, PERF.md section
// 6) and dropped: a cluster per level summing its blocks' planes through
// distributed shared memory and storing the level (0.0860 against 0.0515
// ms at phase 2's inputs, before the other changes), a block per (level,
// feature) at two blocks an SM (0.0889 against 0.0521), both features of
// an entry in one 64-bit compare-and-swap (0.0900 against 0.0519), and the
// warp sum in every warp (0.0520 against 0.0466) or over runs of
// neighbouring lanes only (0.0582). What bounds them: #3, the streams' and
// cotangents' bytes, 40 per (sample, level) at 4 corners (0.0131 ms at
// phase 2's inputs); #2, its 20 bytes of positions and cotangents and its
// table; the shared compare-and-swap loops set the pace (#3's time grows
// with the corners).
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

// The table gradients' blocks: threads of a block; the blocks of a level,
// 16 (one block an SM, so 256 blocks run in two waves), swept on an H100
// 80GB HBM3 at 700 W (`kernel_timing.py window-bwd`, variants
// NAME=PATH:kBwdLevelBlocks=N; PERF.md section 6), ms of #3 at phase 2's
// 65,536 sorted samples x 4 corners / at 262,144: 8 blocks 0.0465 /
// 0.1595, 12 0.0484 / 0.1515, 16 0.0429 / 0.1364, 24 0.0457 / 0.1329, 32
// 0.0473 / 0.1338; of #2 at 65,536 x 8 corners / at 262,144: 8 0.0843 /
// 0.3166, 16 0.0743 / 0.2688, 24 0.0778 / 0.2590; the widest level a
// block keeps in shared memory, in rows of 128 entries x 2 features (1
// KiB; 224 KiB of the 227 KB a block may have); and the samples of a
// block on the global path.
constexpr int kBwdThreads = 1024;
constexpr int kBwdLevelBlocks = 16;
constexpr int kBwdMaxRows = 224;
constexpr int kBwdGlobalTile = 8192;

// A corner source of the table gradients' accumulation (`accumulate`):
// what a thread loads of one sample (its two cotangents first, as g0 and
// g1) and how it turns that into the sample's corners at one level. Each
// is built per block from its kernel arguments (Args) and the level.

// #3's source: one level's saved (nc, N) streams. NC = 0 for a corner
// count known only at run time (its corners are then read where they are
// added).
template <int NC>
struct StreamCorners {
  struct Args {
    const float* g;
    const int* idx;
    const float* w;
    int n;
    int nc;
  };
  struct Sample {
    float g0, g1;
    int idx[NC > 0 ? NC : 1];
    float w[NC > 0 ? NC : 1];
  };
  const float* g0;
  const float* g1;
  const int* il;
  const float* wl;
  int n;
  int nc;

  __device__ __forceinline__ StreamCorners(const Args& a, int lvl)
      : g0(a.g + static_cast<size_t>(2 * lvl) * a.n),
        g1(g0 + a.n),
        il(a.idx + static_cast<size_t>(lvl) * a.nc * a.n),
        wl(a.w + static_cast<size_t>(lvl) * a.nc * a.n),
        n(a.n),
        nc(NC > 0 ? NC : a.nc) {}

  __device__ __forceinline__ Sample load(int i, int end) const {
    Sample s;
    const bool in = i < end;
    s.g0 = in ? __ldg(g0 + i) : 0.0f;
    s.g1 = in ? __ldg(g1 + i) : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      s.idx[c] = in ? __ldg(il + static_cast<size_t>(c) * n + i) : -1;
      s.w[c] = in ? __ldg(wl + static_cast<size_t>(c) * n + i) : 0.0f;
    }
    return s;
  }

  // f(entry, weight) for each corner of sample i.
  template <typename F>
  __device__ __forceinline__ void corners(const Sample& s, int i, int end,
                                          F f) const {
    if constexpr (NC > 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) f(s.idx[c], s.w[c]);
    } else {
      const bool in = i < end;
      for (int c = 0; c < nc; ++c) {
        f(in ? il[static_cast<size_t>(c) * n + i] : -1,
          in ? wl[static_cast<size_t>(c) * n + i] : 0.0f);
      }
    }
  }
};

// #2's source: one level's positions and windows, 20 bytes a sample; its 8
// corners are computed in registers from their per-dimension terms
// (corner_terms, #1's), each entry and weight by the forward's _rn math.
struct PositionCorners {
  struct Args {
    const float* g;
    const float* pos;
    const int* lo;
    const int* win;
    const int* res;
    const int* dense;
    const float* bscale;
    const int* rpb;
    int n;
    int nsb;
  };
  struct Sample {
    float g0, g1;
    float p[3];
  };
  const float* g0;
  const float* g1;
  const float* pos;
  const int* lo;  // the level's (nsb,) windows
  const int* win;
  LevelLayout lay;

  __device__ __forceinline__ PositionCorners(const Args& a, int lvl)
      : g0(a.g + static_cast<size_t>(2 * lvl) * a.n),
        g1(g0 + a.n),
        pos(a.pos),
        lo(a.lo + lvl * a.nsb),
        win(a.win + lvl * a.nsb),
        lay(level_layout(a.res, a.dense, a.bscale, a.rpb, lvl)) {}

  __device__ __forceinline__ Sample load(int i, int end) const {
    Sample s;
    const bool in = i < end;
    s.g0 = in ? __ldg(g0 + i) : 0.0f;
    s.g1 = in ? __ldg(g1 + i) : 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) s.p[d] = in ? __ldg(pos + 3 * i + d) : 0.0f;
    return s;
  }

  template <typename F>
  __device__ __forceinline__ void corners(const Sample& s, int i, int end,
                                          F f) const {
    // Sample i's own sub-block's window (a block's share crosses
    // sub-blocks); a lane past the end takes the last sample's.
    const SampleLevel sl = sample_level(
        s.p, nerficg::window_at(lo, win, min(i, end - 1) / kSubBlockN), lay,
        0);
    const CornerTerms t = corner_terms(lay, sl);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
      f(corner_index(lay, sl, t, cx, cy, cz),
        nerficg::trilinear_weight(sl.frac, cx, cy, cz));
    }
  }
};

// The accumulation both table gradients share: the samples [begin, end) of
// the source's level, the next chunk loaded while the current one adds,
// each corner's products summed over the warp's lanes on one entry where
// two neighbouring lanes share one, then added by add(entry, v0, v1).
// Padding samples (g = 0) add nothing; an entry outside the level's
// `entries` is dropped. Called by all threads of the block; begin and end
// are uniform.
template <typename Source, typename Add>
__device__ __forceinline__ void accumulate(const Source& src, int entries,
                                           int begin, int end, Add add) {
  const auto corner = [&](bool active, int idx, float w, float g0v,
                          float g1v) {
    float v[2] = {__fmul_rn(g0v, w), __fmul_rn(g1v, w)};
    const int key = active && static_cast<unsigned>(idx) <
                                  static_cast<unsigned>(entries)
                        ? idx
                        : -1;
    // One shuffle tells whether the warp's entries repeat (morton-sorted
    // samples on the coarse levels) or not (the fine levels, unsorted
    // samples), where the peer sum would cost more than the atomics it
    // saves. Lanes of one entry that are not neighbours still add
    // correctly, each with its own atomic.
    const int prev = __shfl_up_sync(0xFFFFFFFFu, key, 1);
    const bool repeats = __any_sync(
        0xFFFFFFFFu, (threadIdx.x & 31) != 0 && key >= 0 && key == prev);
    if (repeats ? nerficg::warp_peer_sum(key, v) : key >= 0) {
      add(key, v[0], v[1]);
    }
  };
  int i0 = begin;
  typename Source::Sample cur = src.load(i0 + threadIdx.x, end);
#pragma unroll 1
  for (; i0 < end; i0 += kBwdThreads) {
    const typename Source::Sample next =
        src.load(i0 + kBwdThreads + threadIdx.x, end);
    const bool active = cur.g0 != 0.0f || cur.g1 != 0.0f;
    if (__any_sync(0xFFFFFFFFu, active)) {
      src.corners(cur, i0 + threadIdx.x, end, [&](int idx, float w) {
        corner(active, idx, w, cur.g0, cur.g1);
      });
    }
    cur = next;
  }
}

// One of a level's kBwdLevelBlocks blocks (grid: kBwdLevelBlocks x L): the
// level's gradient zeroed in shared memory, the block's share of the
// samples added there, then each non-zero quad added to dtab (zeroed by
// the caller) with one 16-byte atomic.
template <typename Source>
__global__ void __launch_bounds__(kBwdThreads)
    hash_window_bwd_level_kernel(const typename Source::Args args,
                                 float* __restrict__ dtab, int rows) {
  extern __shared__ __align__(16) float sacc[];
  const int lvl = blockIdx.y;
  const int entries = rows * kLanes;
  const int quads = entries / 2;  // both features, 4 floats each
  float4* s4 = reinterpret_cast<float4*>(sacc);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = threadIdx.x; q < quads; q += kBwdThreads) s4[q] = zero;
  __syncthreads();
  // Whole 128-sample groups per block, so its loads stay aligned.
  const int n = args.n;
  const int per = ((n + kBwdLevelBlocks - 1) / kBwdLevelBlocks + 127) & ~127;
  const int begin = min(n, static_cast<int>(blockIdx.x) * per);
  accumulate(Source(args, lvl), entries, begin, min(n, begin + per),
             [&](int key, float v0, float v1) {
               atomicAdd(sacc + key, v0);
               atomicAdd(sacc + entries + key, v1);
             });
  __syncthreads();
  float4* d0 = reinterpret_cast<float4*>(
      dtab + static_cast<size_t>(2 * lvl) * entries);
  float4* d1 = d0 + entries / 4;
  const auto flush = [](float4* d, const float4& v) {
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
      atomicAdd(d, v);
    }
  };
  for (int q = threadIdx.x; q < entries / 4; q += kBwdThreads) {
    flush(d0 + q, s4[q]);
    flush(d1 + q, s4[entries / 4 + q]);
  }
}

// The global path: a block's kBwdGlobalTile samples of one level, every
// group's sum added to dtab (zeroed by the caller).
template <typename Source>
__global__ void __launch_bounds__(kBwdThreads)
    hash_window_bwd_global_kernel(const typename Source::Args args,
                                  float* __restrict__ dtab, int rows) {
  const int lvl = blockIdx.y;
  const int entries = rows * kLanes;
  const int begin = blockIdx.x * kBwdGlobalTile;
  float* d0 = dtab + static_cast<size_t>(2 * lvl) * entries;
  accumulate(Source(args, lvl), entries, begin,
             min(args.n, begin + kBwdGlobalTile),
             [&](int key, float v0, float v1) {
               atomicAdd(d0 + key, v0);
               atomicAdd(d0 + entries + key, v1);
             });
}

// dtab zeroed, then the level-resident kernel, or the global one for a
// level of more than kBwdMaxRows rows.
template <typename Source>
cudaError_t launch_bwd(const typename Source::Args& args, float* dtab,
                       int levels, int rows, cudaStream_t stream) {
  const size_t bytes =
      static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, stream);
  if (err != cudaSuccess || args.n == 0 || levels == 0) return err;
  if (rows > kBwdMaxRows) {
    const dim3 grid((args.n + kBwdGlobalTile - 1) / kBwdGlobalTile, levels);
    hash_window_bwd_global_kernel<Source>
        <<<grid, kBwdThreads, 0, stream>>>(args, dtab, rows);
    return cudaGetLastError();
  }
  const int smem = rows * kLanes * 2 * static_cast<int>(sizeof(float));
  // Per launch, not once: the attribute belongs to the current device.
  err = cudaFuncSetAttribute(hash_window_bwd_level_kernel<Source>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  hash_window_bwd_level_kernel<Source>
      <<<dim3(kBwdLevelBlocks, levels), kBwdThreads, smem, stream>>>(
          args, dtab, rows);
  return cudaGetLastError();
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
  const PositionCorners::Args args{
      static_cast<const float*>(g),     static_cast<const float*>(pos),
      static_cast<const int*>(lo),      static_cast<const int*>(win),
      static_cast<const int*>(res),     static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      n,                                nsb};
  return static_cast<int>(launch_bwd<PositionCorners>(
      args, static_cast<float*>(dtab), levels, rows,
      static_cast<cudaStream_t>(stream)));
}

// g (L*2, N) f32; save_idx (L, nc, N) i32; save_w (L, nc, N) f32;
// dtab (L, 2, rows, 128) f32, zeroed here.
extern "C" int nerficg_hash_window_bwd_cached(
    const void* g, const void* save_idx, const void* save_w, void* dtab,
    int levels, int n, int nc, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const int* ip = static_cast<const int*>(save_idx);
  const float* wp = static_cast<const float*>(save_w);
  float* dp = static_cast<float*>(dtab);
  switch (nc) {
    case 1:
      return static_cast<int>(launch_bwd<StreamCorners<1>>(
          {gp, ip, wp, n, nc}, dp, levels, rows, s));
    case 2:
      return static_cast<int>(launch_bwd<StreamCorners<2>>(
          {gp, ip, wp, n, nc}, dp, levels, rows, s));
    case 4:
      return static_cast<int>(launch_bwd<StreamCorners<4>>(
          {gp, ip, wp, n, nc}, dp, levels, rows, s));
    default:
      return static_cast<int>(launch_bwd<StreamCorners<0>>(
          {gp, ip, wp, n, nc}, dp, levels, rows, s));
  }
}
