// Two-level block-bitfield occupancy probe, and the row permutation.
//
// Replaces the TPU kernel nerficg_tpu/ops/xbar_gather.py `_gather_kernel`
// (:36, launched by `xbar_gather` :52) where the marcher reaches it: the
// three crossbar gathers inside `block_probe_cells` (:293-328). The probe
// itself: block id, coarse word and rank word, the block's rank by popcount
// of the coarse bits below it, overflow against cap_blocks (overflow blocks
// report occupied), then the fine word and bit.
//
// Two kernels. `block_probe_kernel` takes integer cell coordinates (the op
// API's `block_probe_cells`). `block_probe_xyz_kernel` takes the marcher's
// three f32 world planes and computes the cells in registers, as the plain
// compositions compute them in some 33 PyTorch operations (cascaded:
// nerficg_tpu/ops/occupancy.py `_cascade_cell_coords` :627, the NGP
// mip_from_pos; single grid: the unit coordinates (p - aabb_min) /
// (aabb_max - aabb_min)), then probes: one launch and one byte per probe
// where the compositions wrote 12 bytes of int32 cells and read them back.
// Its cells must equal the compositions' on the card bit for bit (a cell
// or a cascade that moves changes which samples exist), so it runs their
// f32 operations as PyTorch's CUDA kernels run them: products, sums and
// quotients with the _rn intrinsics (no FMA contraction), log2f, ceilf and
// exp2f, __float2int_rz for the cast to int32, maxima and clamps that pass
// a NaN on, a tensor divided by a Python float as a product with the f32
// reciprocal the host computes (PyTorch's CUDA division by a CPU scalar),
// `1.0 / t` as a correctly rounded quotient (Tensor.__rdiv__ is
// reciprocal(t) * 1.0), and a quotient by a 0-dim CUDA tensor as a
// correctly rounded quotient.
//
// What bounds them on an H100: three dependent 4-byte reads per probe from a
// table of a few hundred 128-word rows (130 KiB at 2 cascades of 128^3 with
// cap 2048), which stays in L1/L2; the kernel is latency-bound on that
// chain, so a probe of an empty block returns after the first read. The
// world-plane kernel adds 12 bytes read and 1 written per probe; at a
// serving chunk's 344,064 probes its least time is ~0.0014 ms, below a
// launch's latency.
//
// Row permutation. `xbar_permute` replaces `_permute_kernel` (:88, launched
// by `xbar_permute` :111): out = mat[idx] for an (N, C) matrix of any 32-bit
// type, the bits moved exactly. The TPU scans every 128-lane row of the
// matrix per channel through its lane crossbar (~N/128 x C x 3 vector
// operations); a GPU reads each source row directly. One thread per (output
// row, 32-bit word): consecutive threads write consecutive words, and the C
// words of one source row are read by neighbouring threads. Bound by bytes:
// the index and the output once, and each source row that is read once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kBlockWords = 16;  // 8^3 bits per block

// The probe of one cell (x, y, z) of grid g: 1 if occupied.
__device__ __forceinline__ uint8_t probe_cell(const int* __restrict__ table,
                                              int x, int y, int z, int g,
                                              int res, int cap_blocks,
                                              int coarse_rows,
                                              int rank_rows) {
  const int b = res >> 3;
  const int blk = g * b * b * b + ((x >> 3) * b + (y >> 3)) * b + (z >> 3);
  const int w = blk >> 5;
  const uint32_t bit = static_cast<uint32_t>(blk & 31);
  const uint32_t cw = static_cast<uint32_t>(__ldg(table + w));
  if (((cw >> bit) & 1u) == 0u) return 0;
  const int rank = __ldg(table + coarse_rows * kLanes + w) +
                   __popc(cw & ((1u << bit) - 1u));
  const bool overflow = rank >= cap_blocks;
  const int within = ((x & 7) * 8 + (y & 7)) * 8 + (z & 7);
  const int safe = min(rank, cap_blocks - 1) * kBlockWords + (within >> 5);
  const uint32_t fw = static_cast<uint32_t>(
      __ldg(table + (coarse_rows + rank_rows) * kLanes + safe));
  const bool fine = ((fw >> (within & 31)) & 1u) != 0u;
  return (fine || overflow) ? 1 : 0;
}

__global__ void block_probe_kernel(const int* __restrict__ table,
                                   const int* __restrict__ cx,
                                   const int* __restrict__ cy,
                                   const int* __restrict__ cz,
                                   const int* __restrict__ grid_index,
                                   uint8_t* __restrict__ out, int n, int res,
                                   int cap_blocks, int coarse_rows,
                                   int rank_rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = grid_index != nullptr ? grid_index[i] : 0;
  out[i] = probe_cell(table, cx[i], cy[i], cz[i], g, res, cap_blocks,
                      coarse_rows, rank_rows);
}

// torch.maximum and clamp(min=) on the card: a NaN operand is the result.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// `torch.clamp((u * res).to(torch.int32), 0, res - 1)`.
__device__ __forceinline__ int unit_cell(float u, int res) {
  const int c = __float2int_rz(__fmul_rn(u, static_cast<float>(res)));
  return min(max(c, 0), res - 1);
}

// Cascaded (kCascaded): geo0 = center (3,) f32; inv_base_half = the f32
// reciprocal of base_half = max_half / 2^(cascades - 1), two_base_half =
// f32(2 * base_half). Single grid: geo0 = aabb_min, geo1 = aabb_max (3,).
template <bool kCascaded>
__global__ void block_probe_xyz_kernel(
    const int* __restrict__ table, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ geo0, const float* __restrict__ geo1,
    uint8_t* __restrict__ out, int n, int res,
    int cap_blocks, int coarse_rows, int rank_rows, int cascades,
    float inv_base_half, float two_base_half) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {__ldg(px + i), __ldg(py + i), __ldg(pz + i)};
  int cell[3];
  int g = 0;
  if constexpr (kCascaded) {
    float r[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) r[d] = __fsub_rn(p[d], __ldg(geo0 + d));
    const float m = nan_max(nan_max(fabsf(r[0]), fabsf(r[1])), fabsf(r[2]));
    const float q = nan_max(__fmul_rn(m, inv_base_half), 1.0f);
    const int c = __float2int_rz(ceilf(log2f(q)));
    g = min(max(c, 0), cascades - 1);
    const float inv = __fdiv_rn(
        1.0f, __fmul_rn(exp2f(static_cast<float>(g)), two_base_half));
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cell[d] = unit_cell(__fadd_rn(__fmul_rn(r[d], inv), 0.5f), res);
    }
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float lo = __ldg(geo0 + d);
      const float u = __fdiv_rn(__fsub_rn(p[d], lo),
                                __fsub_rn(__ldg(geo1 + d), lo));
      cell[d] = unit_cell(u, res);
    }
  }
  out[i] = probe_cell(table, cell[0], cell[1], cell[2], g, res, cap_blocks,
                      coarse_rows, rank_rows);
}

__global__ void xbar_permute_kernel(const uint32_t* __restrict__ mat,
                                    const int* __restrict__ idx,
                                    uint32_t* __restrict__ out, int64_t total,
                                    int cols) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= total) return;
  const int64_t r = k / cols;
  const int c = static_cast<int>(k - r * cols);
  out[k] = __ldg(mat + static_cast<int64_t>(__ldg(idx + r)) * cols + c);
}

}  // namespace

// table (rows, 128) i32 = [coarse | rank | compact]; cx/cy/cz (N,) i32 cell
// coords in [0, res); grid_index (N,) i32 or null (= grid 0); out (N,) u8.
extern "C" int nerficg_block_probe(const void* table, const void* cx,
                                   const void* cy, const void* cz,
                                   const void* grid_index, void* out, int n,
                                   int res, int cap_blocks, int coarse_rows,
                                   int rank_rows, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int block = 256;
  block_probe_kernel<<<(n + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(cx),
      static_cast<const int*>(cy), static_cast<const int*>(cz),
      static_cast<const int*>(grid_index), static_cast<uint8_t*>(out), n, res,
      cap_blocks, coarse_rows, rank_rows);
  return static_cast<int>(cudaGetLastError());
}

// table as for nerficg_block_probe; px/py/pz (N,) f32 world planes; out
// (N,) u8. cascades > 0: the cascaded probe, geo0 = center (3,) f32,
// inv_base_half and two_base_half as block_probe_xyz_kernel takes them
// (geo1 unused); cascades == 0: one grid, geo0 = aabb_min and geo1 =
// aabb_max (3,) f32.
extern "C" int nerficg_block_probe_xyz(const void* table, const void* px,
                                       const void* py, const void* pz,
                                       const void* geo0, const void* geo1,
                                       void* out, int n,
                                       int res, int cap_blocks,
                                       int coarse_rows, int rank_rows,
                                       int cascades, float inv_base_half,
                                       float two_base_half, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int block = 256;
  const int grid = (n + block - 1) / block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* z = static_cast<const float*>(pz);
  const float* g0 = static_cast<const float*>(geo0);
  const float* g1 = static_cast<const float*>(geo1);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (cascades > 0) {
    block_probe_xyz_kernel<true><<<grid, block, 0, s>>>(
        t, x, y, z, g0, g1, o, n, res, cap_blocks, coarse_rows, rank_rows,
        cascades, inv_base_half, two_base_half);
  } else {
    block_probe_xyz_kernel<false><<<grid, block, 0, s>>>(
        t, x, y, z, g0, g1, o, n, res, cap_blocks, coarse_rows, rank_rows, 1,
        inv_base_half, two_base_half);
  }
  return static_cast<int>(cudaGetLastError());
}

// mat (N, C) of 32-bit words; idx (M,) i32 in [0, N); out (M, C).
extern "C" int nerficg_xbar_permute(const void* mat, const void* idx,
                                    void* out, int m, int cols,
                                    void* stream) {
  const int64_t total = static_cast<int64_t>(m) * cols;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int block = 256;
  xbar_permute_kernel<<<static_cast<unsigned int>((total + block - 1) / block),
                        block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mat), static_cast<const int*>(idx),
      static_cast<uint32_t*>(out), total, cols);
  return static_cast<int>(cudaGetLastError());
}
