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
// one-hot MXU dot; the port follows the oracle). Summation order varies from
// run to run (atomics).
//
// What bounds them on an H100: 8 random 4-byte reads per feature (forward)
// or 16 adds (backward) per (sample, level), all in one 128-lane column of
// an (8, 128) row block, i.e. 8 x 32-byte sectors. At the reference's 2^19
// entries the table is 16 levels x 2 x 2 MiB = 64 MiB, larger than the 50
// MB L2, so the fine levels' reads go to HBM in 32-byte sectors of which 4
// bytes are used: the forward is bound by sector traffic, not by
// arithmetic. One forward thread per (sample, level), the level on
// blockIdx.y (uniform dense/hash branch per block, coalesced feature-major
// loads and stores of positions, g and out); morton-sorted samples make
// neighbouring threads hit neighbouring cells, so a warp's sectors overlap.
// Gathering the 8 corners of a lane through shared memory, or a GPU-native
// layout with a cell's 16 features in one 64-byte line, is the forward's
// next redesign.
//
// The backward's design. The TPU kernel keeps the level's gradient in VMEM
// and adds one window of base rows at a time; what carries over is the
// window: by the wrap, every corner of a 2048-sample sub-block lands in
// base rows [lo, lo + win) of its level, win x 8 rows x 128 lanes per
// feature. One block per (sub-block, level), grid (N / 2048, L), chooses
// its path at run time from its own win, so the host never synchronises:
//   * window-resident, when win <= kWinRows base rows (8 KiB each) and
//     the caller has not forced the level onto the global path: the block
//     zeroes both features' window in dynamic shared memory, adds every
//     corner there, then flushes the window into the table with one
//     16-byte vector atomicAdd (float4, sm_90) per non-zero quad. On
//     the fine levels a sub-block's 16,384 corner touches per feature
//     fall into a few thousand entries, each flushed once;
//   * global, for the wider windows (the middle levels, whose bricks span
//     more rows than a block holds): every add goes to the table as a
//     scalar f32 atomic.
// The two kinds of block run side by side in one launch, so the resident
// blocks' shared-memory work overlaps the global blocks' L2 atomics (two
// launches, one per path, measured slower on an H100). On both paths a
// warp first sums the lanes on one cell wherever they sit in the warp
// (__match_any_sync, then a tree of shuffles; morton-sorted samples share
// cells on the coarse levels, and on the fine ones the wrap folds several
// cells onto one entry), so each group adds once: shared f32 atomics are
// compare-and-swap loops on sm_90, and global ones to one address
// serialise in the L2 (summing only runs of neighbouring lanes measured
// 0.366 against 0.282 ms on an H100 80GB HBM3 at 700 W, phase 2's inputs).
// The table is zeroed by cudaMemsetAsync first: windows of neighbouring
// sub-blocks overlap and the table has entries no window reaches. The
// wrapper's `cell_bwd_paths` says which blocks take which path.
//
// What bounds the backward: it must write the whole 64 MiB table (0.031 ms
// at 3.35 TB/s, PERF.md section 2); the memset and a pass over cotangents
// that are all 0 take 0.041 ms on an H100 80GB HBM3 at 700 W. Past that,
// the global atomics of levels 5-8, whose samples share few cells and
// whose windows (32-320 base rows) no block holds, cost each level as much
// as in the parent (kernel_timing.py cell-bwd, its per-level lines).
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

// Threads of a backward block (on an H100, 512 beat 256 and 1024).
constexpr int kBwdThreads = 512;
// Shared memory of one base row of a window: 8 rows x 128 lanes x 2
// features of f32.
constexpr int kWinRowBytes = 8 * kLanes * 2 * 4;
// The widest window a block keeps in shared memory, in base rows (the
// wrapper's BWD_WIN_ROWS): 8 (64 KiB, three blocks an SM) beat 4, 6, 7,
// 10, 12, 16 and 28 at phase 2's inputs on an H100 80GB HBM3 at 700 W
// (0.2719 ms against 0.2810 at 12 and 0.3410 at 28; kernel_timing.py
// cell-bwd, variants NAME=PATH:kWinRows=N, PERF.md section 6).
constexpr int kWinRows = 8;

// One (sub-block, level) block of the backward, window-resident or global
// by its own win.
__global__ void __launch_bounds__(kBwdThreads) hash_cell_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ pos,
    const int* __restrict__ lo, const int* __restrict__ win,
    const int* __restrict__ res_l, const int* __restrict__ dense_l,
    const float* __restrict__ bscale_l, const int* __restrict__ rpb_l,
    const int* __restrict__ rsh_l, float* __restrict__ dtab, int n, int nsb,
    int rows, unsigned global_mask) {
  extern __shared__ __align__(16) float sw[];
  const int sb = blockIdx.x;
  const int lvl = blockIdx.y;
  const int w_lo = lo[lvl * nsb + sb];
  const int w_win = win[lvl * nsb + sb];
  const bool resident =
      w_win <= kWinRows && (lvl >= 32 || ((global_mask >> lvl) & 1u) == 0u);
  // Entries of one feature's window, and the window's first entry in the
  // level's plane.
  const int went = w_win * 8 * kLanes;
  const int first = w_lo * 8 * kLanes;
  const size_t plane = static_cast<size_t>(rows) * kLanes;
  float* d0 = dtab + static_cast<size_t>(2 * lvl) * plane;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (resident) {
    for (int q = threadIdx.x; q < went / 2; q += kBwdThreads) {
      reinterpret_cast<float4*>(sw)[q] = zero;
    }
    __syncthreads();
  }
  const CellLevel lay = cell_level(res_l, dense_l, bscale_l, rpb_l, rsh_l,
                                   lvl);
  const float* g0_l = g + static_cast<size_t>(2 * lvl) * n;
  const float* g1_l = g0_l + n;
  // Each thread's cotangents, all loaded before the first is used.
  constexpr int kPer = kSubBlockN / kBwdThreads;
  float g0s[kPer];
  float g1s[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = sb * kSubBlockN + r * kBwdThreads + threadIdx.x;
    g0s[r] = g0_l[i];
    g1s[r] = g1_l[i];
  }
  // n is a multiple of 2048, so every lane has a sample and whole warps
  // reach the peer sum.
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = sb * kSubBlockN + r * kBwdThreads + threadIdx.x;
    const float g0 = g0s[r];
    const float g1 = g1s[r];
    const bool active = g0 != 0.0f || g1 != 0.0f;  // padding adds nothing
    if (!__any_sync(0xFFFFFFFFu, active)) continue;
    float frac[3];
    const int at = cell_address(pos, lo, win, lay, i, lvl, nsb, frac);
    float v[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w =
          nerficg::trilinear_weight(frac, (c >> 2) & 1, (c >> 1) & 1, c & 1);
      v[c] = __fmul_rn(g0, w);
      v[8 + c] = __fmul_rn(g1, w);
    }
    if (!nerficg::warp_peer_sum(active ? at : -1, v)) continue;
    if (resident) {
      float* s0 = sw + (at - first);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        atomicAdd(s0 + c * kLanes, v[c]);
        atomicAdd(s0 + went + c * kLanes, v[8 + c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        atomicAdd(d0 + at + c * kLanes, v[c]);
        atomicAdd(d0 + plane + at + c * kLanes, v[8 + c]);
      }
    }
  }
  if (!resident) return;
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const float4* s = reinterpret_cast<const float4*>(sw + f * went);
    float4* d = reinterpret_cast<float4*>(d0 + f * plane + first);
    for (int q = threadIdx.x; q < went / 4; q += kBwdThreads) {
      const float4 v = s[q];
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
        atomicAdd(d + q, v);
      }
    }
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

// g (L*2, N) f32; pos, lo, win and the layout as for the forward; dtab
// (L, 2, rows, 128) f32, zeroed here; bit l of global_mask forces level l
// onto the global path.
extern "C" int nerficg_hash_cell_bwd(
    const void* g, const void* pos, const void* lo, const void* win,
    const void* res, const void* dense, const void* bscale, const void* rpb,
    const void* rsh, void* dtab, int levels, int n, int nsb, int rows,
    unsigned global_mask, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      static_cast<size_t>(levels) * 2 * rows * kLanes * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dtab, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsb == 0 || levels == 0) return static_cast<int>(cudaGetLastError());
  constexpr int smem = kWinRows * kWinRowBytes;
  if (smem > 48 * 1024) {
    // Per launch, not once: the attribute belongs to the current device.
    err = cudaFuncSetAttribute(hash_cell_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hash_cell_bwd_kernel<<<dim3(nsb, levels), kBwdThreads, smem, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(pos),
      static_cast<const int*>(lo), static_cast<const int*>(win),
      static_cast<const int*>(res), static_cast<const int*>(dense),
      static_cast<const float*>(bscale), static_cast<const int*>(rpb),
      static_cast<const int*>(rsh), static_cast<float*>(dtab), n, nsb, rows,
      global_mask);
  return static_cast<int>(cudaGetLastError());
}
