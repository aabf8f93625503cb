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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kBrickBitsMax = 5;
constexpr int kSubBlockN = 64 * 128;  // samples per window sub-block
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 805459861u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ int morton3(int x, int y, int z) {
  int m = 0;
#pragma unroll
  for (int i = 0; i < kBrickBitsMax; ++i) {
    m |= ((x >> i) & 1) << (3 * i + 2);
    m |= ((y >> i) & 1) << (3 * i + 1);
    m |= ((z >> i) & 1) << (3 * i);
  }
  return m;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// lowbias32 finalizer (nerficg_torch/ops/counter_rng.py mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

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
  const float res_m1 = static_cast<float>(lay.res - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float scaled = __fmul_rn(pos[3 * i + d], res_m1);
    const float f = floorf(scaled);
    s.frac[d] = __fsub_rn(scaled, f);
    s.base[d] = static_cast<int>(f);
  }
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
    const uint32_t h = static_cast<uint32_t>(vx) ^
                       (static_cast<uint32_t>(vy) * kP1) ^
                       (static_cast<uint32_t>(vz) * kP2);
    row = morton3(bx, by, bz) * static_cast<int>(lay.rpb) +
          static_cast<int>((h >> 7) & (lay.rpb - 1u));
    lane = static_cast<int>(h & (kLanes - 1));
  }
  // _wrap_rel: float-division modulo into [0, win), clamped.
  const int rel = row - s.w_lo;
  const float q = floorf(__fmul_rn(static_cast<float>(rel), s.inv));
  int r = rel - static_cast<int>(q) * s.w_win;
  r = min(max(r, 0), s.w_win - 1);
  return (s.w_lo + r) * kLanes + lane;
}

__device__ __forceinline__ float exact_weight(const SampleLevel& s, int cx,
                                              int cy, int cz) {
  const float wx = cx ? s.frac[0] : __fsub_rn(1.0f, s.frac[0]);
  const float wy = cy ? s.frac[1] : __fsub_rn(1.0f, s.frac[1]);
  const float wz = cz ? s.frac[2] : __fsub_rn(1.0f, s.frac[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// `_stoch_corners` for one (sample, level): NC corner offsets and weights.
template <int NC>
__device__ __forceinline__ void stoch_corners(const SampleLevel& s,
                                              uint32_t seed, int lvl, int i,
                                              int (*off)[3], float* w) {
  int draw[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const uint32_t key =
        mix32(seed ^ (static_cast<uint32_t>(lvl * 3 + d + 1) * kGolden));
    const uint32_t bits = mix32(static_cast<uint32_t>(i) ^ key);
    const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
    draw[d] = u < s.frac[d] ? 1 : 0;
  }
  if (NC == 1) {
    off[0][0] = draw[0];
    off[0][1] = draw[1];
    off[0][2] = draw[2];
    w[0] = 1.0f;
    return;
  }
  float m[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) m[d] = fminf(s.frac[d], __fsub_rn(1.0f, s.frac[d]));
  bool exact[3];
  if (NC == 2) {  // exact dim = argmax m
    const bool k0 = (m[0] >= m[1]) && (m[0] >= m[2]);
    const bool k1 = !k0 && (m[1] >= m[2]);
    exact[0] = k0;
    exact[1] = k1;
    exact[2] = !k0 && !k1;
  } else {  // NC == 4: stochastic dim = argmin m
    const bool s0 = (m[0] <= m[1]) && (m[0] <= m[2]);
    const bool s1 = !s0 && (m[1] <= m[2]);
    exact[0] = !s0;
    exact[1] = !s1;
    exact[2] = s0 || s1;
  }
  const bool first[3] = {exact[0], exact[1] && !exact[0],
                         exact[2] && !exact[0] && !exact[1]};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int bit0 = c & 1;
    const int bit_n = NC == 2 ? bit0 : (c >> 1) & 1;
    float wc = 1.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int o = exact[d] ? (first[d] ? bit0 : bit_n) : draw[d];
      off[c][d] = o;
      if (exact[d]) {
        wc = __fmul_rn(wc, o ? s.frac[d] : __fsub_rn(1.0f, s.frac[d]));
      }
    }
    w[c] = wc;
  }
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
      const float w = exact_weight(s, cx, cy, cz);
      acc0 += w * bf16_round(__ldg(tab0 + idx));
      acc1 += w * bf16_round(__ldg(tab1 + idx));
    }
  } else {
    constexpr int kNC = NC == 0 ? 1 : NC;
    int off[kNC][3];
    float w[kNC];
    stoch_corners<kNC>(s, seed, lvl, i, off, w);
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int idx = corner_index(lay, s, off[c][0], off[c][1], off[c][2]);
      acc0 += w[c] * bf16_round(__ldg(tab0 + idx));
      acc1 += w[c] * bf16_round(__ldg(tab1 + idx));
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
    const float w = exact_weight(s, cx, cy, cz);
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
