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
// the 50 MB L2, so reads and atomics are L2 operations; one thread per
// (sample, level) with the level on blockIdx.y keeps the dense/hash branch
// uniform per block and the feature-major loads and stores coalesced. The
// backward's atomics contend at coarse levels: samples arrive morton-sorted,
// so neighbouring threads of a warp hit the same vertex (level 0 has 16^3
// vertices for 65,536 x 8 corner adds) and same-address atomics serialise;
// a warp-level pre-aggregation (__match_any_sync) is the next redesign.
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
  int w_lo;
  int w_win;
  float inv;
};

__device__ __forceinline__ SampleLevel sample_level(
    const float* __restrict__ pos, const int* __restrict__ lo,
    const int* __restrict__ win, const LevelLayout& lay, int i, int lvl,
    int nsb) {
  SampleLevel s;
  nerficg::level_coords(pos, i, static_cast<float>(lay.res - 1), s.base,
                        s.frac);
  const int sb = i / kSubBlockN;
  s.w_lo = lo[lvl * nsb + sb];
  s.w_win = win[lvl * nsb + sb];
  s.inv = __fdiv_rn(1.0f, static_cast<float>(s.w_win));
  return s;
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
  return (s.w_lo + nerficg::wrap_rel(row - s.w_lo, s.w_win, s.inv)) * kLanes +
         lane;
}

// NC == 0: exact 8 corners; NC in {1, 2, 4}: stochastic corners, with
// optional saves of (absolute index, weight) per corner.
template <int NC>
__global__ void hash_window_fwd_kernel(
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
  if (NC == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
      const int idx = corner_index(lay, s, cx, cy, cz);
      const float w = nerficg::trilinear_weight(s.frac, cx, cy, cz);
      acc0 += w * nerficg::bf16_round(__ldg(tab0 + idx));
      acc1 += w * nerficg::bf16_round(__ldg(tab1 + idx));
    }
  } else {
    constexpr int kNC = NC == 0 ? 1 : NC;
    int off[kNC][3];
    float w[kNC];
    nerficg::stoch_corners<kNC>(s.frac, seed, lvl, i, off, w);
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int idx = corner_index(lay, s, off[c][0], off[c][1], off[c][2]);
      acc0 += w[c] * nerficg::bf16_round(__ldg(tab0 + idx));
      acc1 += w[c] * nerficg::bf16_round(__ldg(tab1 + idx));
      if (save_idx != nullptr) {
        const size_t at = (static_cast<size_t>(lvl) * kNC + c) * n + i;
        save_idx[at] = idx;
        save_w[at] = w[c];
      }
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
cudaError_t launch_fwd(const void* table, const void* pos, const void* lo,
                       const void* win, const void* res, const void* dense,
                       const void* bscale, const void* rpb, void* out,
                       void* save_idx, void* save_w, int levels, int n,
                       int nsb, int rows, uint32_t seed, cudaStream_t stream) {
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_window_fwd_kernel<NC><<<grid, block, 0, stream>>>(
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
  return static_cast<int>(launch_fwd<0>(
      table, pos, lo, win, res, dense, bscale, rpb, out, nullptr, nullptr,
      levels, n, nsb, rows, 0u, static_cast<cudaStream_t>(stream)));
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
      return static_cast<int>(launch_fwd<1>(table, pos, lo, win, res, dense,
                                            bscale, rpb, out, save_idx, save_w,
                                            levels, n, nsb, rows, seed, s));
    case 2:
      return static_cast<int>(launch_fwd<2>(table, pos, lo, win, res, dense,
                                            bscale, rpb, out, save_idx, save_w,
                                            levels, n, nsb, rows, seed, s));
    case 4:
      return static_cast<int>(launch_fwd<4>(table, pos, lo, win, res, dense,
                                            bscale, rpb, out, save_idx, save_w,
                                            levels, n, nsb, rows, seed, s));
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
