// Cell-packed windowed hash encode (exact 8 corners) and its table gradient.
//
// Forward. Replaces the TPU kernel nerficg_tpu/ops/hash_cell.py `_fwd_kernel`
// (:380, launched by `_fwd_pallas` :558). It computes what the jnp oracle
// `_fwd_jnp` (:316) computes: per (sample, level) ONE cell address, the base
// vertex's (base_row, lane) by `_cell_base_row_lane` (dense linear cell
// index, or (brick morton >> rsh) * rpb + hash bits), the wrap of base_row
// into the sample's 2048-sample sub-block window [lo, lo + win) by
// `_wrap_rel`, then the 8 corner features at table rows base_row*8 + c of
// the same lane, read as bf16, weighted by the trilinear weights in
// (i, j, k) corner order. Output is feature-major (L*2, N).
//
// Backward. `hash_cell_bwd` replaces `_bwd_kernel` (:441, `_bwd_pallas`
// :601): the table gradient, recomputing the address with the forward's
// device code and adding the f32 product g * w_c at each corner, as the
// oracle `_bwd_jnp` (:336) does (the TPU kernel rounds g * w to bf16 for its
// one-hot MXU dot; the port follows the oracle). The TPU kernel accumulates
// over sequential grid steps in VMEM; here the wrapper's output is zeroed
// with cudaMemsetAsync on the stream and every corner adds with an fp32
// atomicAdd (summation order varies from run to run).
//
// What bounds them on an H100: 8 random 4-byte reads per feature (forward)
// or 16 atomic adds (backward) per (sample, level), all in one 128-lane
// column of an (8, 128) row block, i.e. 8 x 32-byte sectors. At the
// reference's 2^19 entries the table is 16 levels x 2 x 2 MiB = 64 MiB,
// larger than the 50 MB L2, so the fine levels' reads go to HBM in 32-byte
// sectors of which 4 bytes are used: the kernels are bound by sector
// traffic, not by arithmetic. One thread per (sample, level), the level on
// blockIdx.y (uniform dense/hash branch per block, coalesced
// feature-major loads and stores of positions, g and out); morton-sorted
// samples make neighbouring threads hit neighbouring cells, so a warp's
// sectors overlap. Gathering the 8 corners of a lane through shared memory,
// or a GPU-native layout with a cell's 16 features in one 64-byte line, is
// the next redesign.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_common.cuh"

namespace {

using nerficg::kLanes;

constexpr int kSubBlockN = 16 * 128;  // samples per cell window sub-block

struct CellLevel {
  int res;
  bool dense;
  float bscale;
  int rpb;
  int rsh;
};

__device__ __forceinline__ CellLevel cell_level(
    const int* res_l, const int* dense_l, const float* bscale_l,
    const int* rpb_l, const int* rsh_l, int lvl) {
  CellLevel lay;
  lay.res = res_l[lvl];
  lay.dense = dense_l[lvl] != 0;
  lay.bscale = bscale_l[lvl];
  lay.rpb = rpb_l[lvl];
  lay.rsh = rsh_l[lvl];
  return lay;
}

// One (sample, level): the flat offset of corner 0 (row base_row*8, its
// lane) in the level's (rows * 128) plane, and the fractional offsets.
__device__ __forceinline__ int cell_address(
    const float* __restrict__ pos, const int* __restrict__ lo,
    const int* __restrict__ win, const CellLevel& lay, int i, int lvl,
    int nsb, float frac[3]) {
  int v[3];
  nerficg::level_coords(pos, i, static_cast<float>(lay.res - 1), v, frac);
  int row, lane;
  if (lay.dense) {
    const int side = lay.res - 1;
    const int lin = (v[0] * side + v[1]) * side + v[2];
    row = lin >> 7;
    lane = lin & (kLanes - 1);
  } else {
    const int bx = static_cast<int>(__fmul_rn(static_cast<float>(v[0]), lay.bscale));
    const int by = static_cast<int>(__fmul_rn(static_cast<float>(v[1]), lay.bscale));
    const int bz = static_cast<int>(__fmul_rn(static_cast<float>(v[2]), lay.bscale));
    const uint32_t h = nerficg::ngp_hash(v[0], v[1], v[2]);
    row = (nerficg::morton3(bx, by, bz) >> lay.rsh) * lay.rpb +
          static_cast<int>((h >> 7) & static_cast<uint32_t>(lay.rpb - 1));
    lane = static_cast<int>(h & (kLanes - 1));
  }
  const int sb = i / kSubBlockN;
  const int w_lo = lo[lvl * nsb + sb];
  const int w_win = win[lvl * nsb + sb];
  const float inv = __fdiv_rn(1.0f, static_cast<float>(w_win));
  const int brow = w_lo + nerficg::wrap_rel(row - w_lo, w_win, inv);
  return brow * 8 * kLanes + lane;
}

__global__ void hash_cell_fwd_kernel(
    const float* __restrict__ table, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    const int* __restrict__ rsh_l, float* __restrict__ out, int n, int nsb,
    int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const CellLevel lay = cell_level(res_l, dense_l, bscale_l, rpb_l, rsh_l,
                                   lvl);
  float frac[3];
  const int at = cell_address(pos, lo, win, lay, i, lvl, nsb, frac);
  const float* tab0 =
      table + static_cast<size_t>(2 * lvl) * rows * kLanes + at;
  const float* tab1 = tab0 + static_cast<size_t>(rows) * kLanes;
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w =
        nerficg::trilinear_weight(frac, (c >> 2) & 1, (c >> 1) & 1, c & 1);
    acc0 += w * nerficg::bf16_round(__ldg(tab0 + c * kLanes));
    acc1 += w * nerficg::bf16_round(__ldg(tab1 + c * kLanes));
  }
  out[static_cast<size_t>(2 * lvl) * n + i] = acc0;
  out[static_cast<size_t>(2 * lvl + 1) * n + i] = acc1;
}

__global__ void hash_cell_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    const int* __restrict__ rsh_l, float* __restrict__ dtab, int n, int nsb,
    int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lvl = blockIdx.y;
  if (i >= n) return;
  const float g0 = g[static_cast<size_t>(2 * lvl) * n + i];
  const float g1 = g[static_cast<size_t>(2 * lvl + 1) * n + i];
  if (g0 == 0.0f && g1 == 0.0f) return;  // padding samples add nothing
  const CellLevel lay = cell_level(res_l, dense_l, bscale_l, rpb_l, rsh_l,
                                   lvl);
  float frac[3];
  const int at = cell_address(pos, lo, win, lay, i, lvl, nsb, frac);
  float* d0 = dtab + static_cast<size_t>(2 * lvl) * rows * kLanes + at;
  float* d1 = d0 + static_cast<size_t>(rows) * kLanes;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w =
        nerficg::trilinear_weight(frac, (c >> 2) & 1, (c >> 1) & 1, c & 1);
    atomicAdd(d0 + c * kLanes, __fmul_rn(g0, w));
    atomicAdd(d1 + c * kLanes, __fmul_rn(g1, w));
  }
}

}  // namespace

// table (L, 2, rows, 128) f32; pos (N, 3) f32, N a multiple of 2048;
// lo/win (L, nsb) i32 in base rows; per-level layout res/dense/bscale/rpb/rsh
// (L,); out (L*2, N) f32.
extern "C" int nerficg_hash_cell_fwd(
    const void* table, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    const void* rsh, void* out, int levels, int n, int nsb, int rows,
    void* stream) {
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_cell_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<const int*>(rsh), static_cast<float*>(out), n, nsb, rows);
  return static_cast<int>(cudaGetLastError());
}

// g (L*2, N) f32; pos, lo, win and the layout as for the forward;
// dtab (L, 2, rows, 128) f32, zeroed here.
extern "C" int nerficg_hash_cell_bwd(
    const void* g, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    const void* rsh, void* dtab, int levels, int n, int nsb, int rows,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x, levels);
  hash_cell_bwd_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<const int*>(rsh), static_cast<float*>(dtab), n, nsb, rows);
  return static_cast<int>(cudaGetLastError());
}
