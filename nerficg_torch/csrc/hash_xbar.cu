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
// corners to the plain version's bit for bit.
//
// Backward. `hash_xbar_bwd` replaces `_bwd_kernel` (:394, `_bwd_pallas`
// :481), whose one-hot MXU block limits the TPU to tables of 2^14 entries;
// the function has no such limit and neither has this kernel. It recomputes
// the corners with the forward's device code (the same words in stochastic
// mode, which the TPU replays from its per-tile stream), so the gradient
// lands on the corners the forward read, bit for bit, and adds the f32
// product g * w_c at each, as `_bwd_jnp` (:721) does, with fp32 atomicAdd
// into a table zeroed by cudaMemsetAsync on the stream.
//
// Position gradient. `hash_xbar_bwd_pos` replaces `_bwd_pos_kernel` (:537,
// `_bwd_pos_pallas` :599), the d(encode)/d(position) that a deformation
// field (D-NeRF) trains through. Per sample and level, with g the sample's
// two cotangents and v_c the bf16-rounded features of corner c, it adds
//   ((g . v_c) * dfactor_{c,d}) * (prod_{e != d} factor_{c,e}) * (res - 1)
// over the corners in order into a per-level sum, and the levels' sums in
// order into dpos (N, 3), d/d(unit position) as the oracle `_dpos_jnp`
// (:642) differentiates the bf16 trilinear encode. Exact corners: factor f
// or 1 - f, dfactor +-1. Stochastic corners (the same draws as the forward):
// the interpolated dims likewise, the Bernoulli-sampled dims factor 1 and
// dfactor 0 (`_corner_set` :236, straight-through). One thread per sample
// loops over the levels and keeps the three sums in registers: no atomics,
// and every sum in the plain version's order with _rn intrinsics, so the
// result is the plain version's, bit for bit, from run to run. Not fused with
// the table gradient (the TPU launches them apart; a fused kernel would
// share the gather). A level whose two cotangents are 0 adds exact zeros and
// is skipped.
//
// What bounds them on an H100: 2 * C random 4-byte reads (forward) or atomic
// adds (backward) per (sample, level), C = 8 exact or 1/2/4 stochastic,
// against 8 bytes written or read per (sample, level). At the library's 2^14
// entries the whole table is 2 MiB and stays in the 50 MB L2, so the reads
// and atomics are L2 operations. The hash spreads neighbouring vertices over
// the table, so a warp's corners touch ~32 separate sectors at hashed levels:
// sector throughput, not arithmetic, is the limit. One thread per (sample,
// level), the level on blockIdx.y (uniform dense/hash branch per block); the
// sample-major output is written as one 8-byte pair per thread at a stride of
// L*2 floats, which L2 merges across the levels' blocks.
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
  const float* tab0 = table + static_cast<size_t>(2 * lvl) * rows * kLanes;
  const float* tab1 = tab0 + static_cast<size_t>(rows) * kLanes;
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < kMax; ++c) {
    acc0 += w[c] * nerficg::bf16_round(__ldg(tab0 + idx[c]));
    acc1 += w[c] * nerficg::bf16_round(__ldg(tab1 + idx[c]));
  }
  float* o = out + static_cast<size_t>(i) * (2 * levels) + 2 * lvl;
  o[0] = acc0;
  o[1] = acc1;
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

template <int NC>
cudaError_t launch_fwd(const void* table, const void* pos, const void* res_m1,
                       const void* lrows, const void* dense, void* out,
                       void* save_idx, void* save_w, int levels, int n,
                       int rows, uint32_t seed, cudaStream_t stream) {
  if (n == 0) return cudaGetLastError();
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_xbar_fwd_kernel<NC><<<grid, block, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(pos),
      static_cast<const float*>(res_m1), static_cast<const int*>(lrows),
      static_cast<const int*>(dense), static_cast<float*>(out),
      static_cast<int*>(save_idx), static_cast<float*>(save_w), n, levels,
      rows, seed);
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

}  // namespace

// table (L, 2, rows, 128) f32; pos (N, 3) f32; per-level layout res_m1 (L,)
// f32, lrows (L,) i32, dense (L,) i32; out (N, L*2) f32; n_corners 0 (exact)
// or 1, 2, 4 (stochastic, drawn from seed); save_idx (L, C, N) i32 and save_w
// (L, C, N) f32, C = 8 or n_corners, are written when non-null.
extern "C" int nerficg_hash_xbar_fwd(const void* table, const void* pos,
                                     const void* res_m1, const void* lrows,
                                     const void* dense, void* out,
                                     void* save_idx, void* save_w, int levels,
                                     int n, int rows, int n_corners,
                                     unsigned int seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_corners) {
    case 0:
      return static_cast<int>(launch_fwd<0>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, seed, s));
    case 1:
      return static_cast<int>(launch_fwd<1>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, seed, s));
    case 2:
      return static_cast<int>(launch_fwd<2>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, seed, s));
    case 4:
      return static_cast<int>(launch_fwd<4>(table, pos, res_m1, lrows, dense,
                                            out, save_idx, save_w, levels, n,
                                            rows, seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g (N, L*2) f32; pos, the layout, n_corners and seed as for the forward;
// dtab (L, 2, rows, 128) f32, zeroed here.
extern "C" int nerficg_hash_xbar_bwd(const void* g, const void* pos,
                                     const void* res_m1, const void* lrows,
                                     const void* dense, void* dtab,
                                     int levels, int n, int rows,
                                     int n_corners, unsigned int seed,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_corners) {
    case 0:
      return static_cast<int>(launch_bwd<0>(g, pos, res_m1, lrows, dense,
                                            dtab, levels, n, rows, seed, s));
    case 1:
      return static_cast<int>(launch_bwd<1>(g, pos, res_m1, lrows, dense,
                                            dtab, levels, n, rows, seed, s));
    case 2:
      return static_cast<int>(launch_bwd<2>(g, pos, res_m1, lrows, dense,
                                            dtab, levels, n, rows, seed, s));
    case 4:
      return static_cast<int>(launch_bwd<4>(g, pos, res_m1, lrows, dense,
                                            dtab, levels, n, rows, seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// table (L, 2, rows, 128) f32; pos (N, 3) f32 in [0, 1); g (N, L*2) f32;
// the layout, n_corners and seed as for the forward; dpos (N, 3) f32.
extern "C" int nerficg_hash_xbar_bwd_pos(const void* table, const void* pos,
                                         const void* g, const void* res_m1,
                                         const void* lrows, const void* dense,
                                         void* dpos, int levels, int n,
                                         int rows, int n_corners,
                                         unsigned int seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_corners) {
    case 0:
      return static_cast<int>(launch_bwd_pos<0>(table, pos, g, res_m1, lrows,
                                                dense, dpos, levels, n, rows,
                                                seed, s));
    case 1:
      return static_cast<int>(launch_bwd_pos<1>(table, pos, g, res_m1, lrows,
                                                dense, dpos, levels, n, rows,
                                                seed, s));
    case 2:
      return static_cast<int>(launch_bwd_pos<2>(table, pos, g, res_m1, lrows,
                                                dense, dpos, levels, n, rows,
                                                seed, s));
    case 4:
      return static_cast<int>(launch_bwd_pos<4>(table, pos, g, res_m1, lrows,
                                                dense, dpos, levels, n, rows,
                                                seed, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
