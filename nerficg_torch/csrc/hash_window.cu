// Windowed multiresolution hash encode, forward, exact 8 corners.
//
// Replaces the TPU kernel nerficg_tpu/ops/hash_window.py `_fwd_kernel`
// (:468, launched by `_fwd_pallas` :709). It computes the same function as
// the jnp oracle `_fwd_jnp` (:379): per (sample, level) the 8 trilinear
// corners, their table address by `_row_lane` (dense linear index, or brick
// morton row * rpb + hash bits), the wrap of that row into the sample's
// 8192-sample sub-block window [lo, lo + win) by `_wrap_rel`, a bf16-rounded
// read of both features, and the weighted sum. Output is feature-major
// (L*2, N), as the JAX package's MLP consumes it.
//
// The TPU kernel scans every window row per tile because a TPU has no vector
// gather; here each thread reads its corners straight from global memory.
// What bounds it on an H100: 16 random 4-byte reads per (sample, level). At
// 2^14 entries the whole table is 16 levels x 2 x 64 KiB = 2 MiB and stays in
// the 50 MB L2, so the reads are L2 hits; one thread per (sample, level) with
// the level on blockIdx.y keeps the dense/hash branch uniform per block and
// the feature-major stores coalesced.
//
// Rounding: `scaled`, `frac`, the brick product, the wrap reciprocal and the
// wrap product use the _rn intrinsics, so nvcc cannot contract them into
// FMAs: they must equal the oracle's f32 results bit for bit (a one-ulp
// difference moves a corner across a row). Only the final weighted sum may
// contract; it is compared with a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kBrickBitsMax = 5;
constexpr int kSubBlockN = 64 * 128;  // samples per window sub-block
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 805459861u;

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

__global__ void hash_window_fwd_kernel(
    const float* __restrict__ table, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    float* __restrict__ out, int n, int nsb, int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const int res = res_l[lvl];
  const bool dense = dense_l[lvl] != 0;
  const float bscale = bscale_l[lvl];
  const uint32_t rpb = static_cast<uint32_t>(rpb_l[lvl]);
  const float res_m1 = static_cast<float>(res - 1);

  int base[3];
  float frac[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float s = __fmul_rn(pos[3 * i + d], res_m1);
    const float f = floorf(s);
    frac[d] = __fsub_rn(s, f);
    base[d] = static_cast<int>(f);
  }
  const int sb = i / kSubBlockN;
  const int w_lo = lo[lvl * nsb + sb];
  const int w_win = win[lvl * nsb + sb];
  const float inv = __fdiv_rn(1.0f, static_cast<float>(w_win));

  const float* tab0 = table + static_cast<size_t>(2 * lvl) * rows * kLanes;
  const float* tab1 = tab0 + static_cast<size_t>(rows) * kLanes;
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    const int vx = base[0] + cx, vy = base[1] + cy, vz = base[2] + cz;
    int row, lane;
    if (dense) {
      const int lin = vx * (res * res) + vy * res + vz;
      row = lin >> 7;
      lane = lin & (kLanes - 1);
    } else {
      const int bx = static_cast<int>(__fmul_rn(static_cast<float>(vx), bscale));
      const int by = static_cast<int>(__fmul_rn(static_cast<float>(vy), bscale));
      const int bz = static_cast<int>(__fmul_rn(static_cast<float>(vz), bscale));
      const uint32_t h = static_cast<uint32_t>(vx) ^
                         (static_cast<uint32_t>(vy) * kP1) ^
                         (static_cast<uint32_t>(vz) * kP2);
      row = morton3(bx, by, bz) * static_cast<int>(rpb) +
            static_cast<int>((h >> 7) & (rpb - 1u));
      lane = static_cast<int>(h & (kLanes - 1));
    }
    // _wrap_rel: float-division modulo into [0, win), clamped.
    const int rel = row - w_lo;
    const float q = floorf(__fmul_rn(static_cast<float>(rel), inv));
    int r = rel - static_cast<int>(q) * w_win;
    r = min(max(r, 0), w_win - 1);
    const size_t idx = static_cast<size_t>(w_lo + r) * kLanes + lane;

    const float wx = cx ? frac[0] : __fsub_rn(1.0f, frac[0]);
    const float wy = cy ? frac[1] : __fsub_rn(1.0f, frac[1]);
    const float wz = cz ? frac[2] : __fsub_rn(1.0f, frac[2]);
    const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
    acc0 += w * bf16_round(__ldg(tab0 + idx));
    acc1 += w * bf16_round(__ldg(tab1 + idx));
  }
  out[static_cast<size_t>(2 * lvl) * n + i] = acc0;
  out[static_cast<size_t>(2 * lvl + 1) * n + i] = acc1;
}

}  // namespace

// table (L, 2, rows, 128) f32; pos (N, 3) f32, N a multiple of 8192;
// lo/win (L, nsb) i32; per-level layout res/dense/bscale/rpb (L,);
// out (L*2, N) f32.
extern "C" int nerficg_hash_window_fwd(
    const void* table, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    void* out, int levels, int n, int nsb, int rows, void* stream) {
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_window_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<float*>(out), n, nsb, rows);
  return static_cast<int>(cudaGetLastError());
}
