// Two-level block-bitfield occupancy probe, and the row permutation.
//
// Replaces the TPU kernel nerficg_tpu/ops/xbar_gather.py `_gather_kernel`
// (:36, launched by `xbar_gather` :52) where the marcher reaches it: the
// three crossbar gathers inside `block_probe_cells` (:293-328). One thread
// per probe does the whole probe: block id, coarse word and rank word, the
// block's rank by popcount of the coarse bits below it, overflow against
// cap_blocks (overflow blocks report occupied), then the fine word and bit.
//
// What bounds it on an H100: three dependent 4-byte reads per probe from a
// table of a few hundred 128-word rows (130 KiB at 2 cascades of 128^3 with
// cap 2048), which stays in L1/L2; the kernel is latency-bound on that
// chain, so a probe of an empty block returns after the first read.
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
  const int x = cx[i], y = cy[i], z = cz[i];
  const int g = grid_index != nullptr ? grid_index[i] : 0;
  const int b = res >> 3;
  const int blk = g * b * b * b + ((x >> 3) * b + (y >> 3)) * b + (z >> 3);
  const int w = blk >> 5;
  const uint32_t bit = static_cast<uint32_t>(blk & 31);
  const uint32_t cw = static_cast<uint32_t>(__ldg(table + w));
  if (((cw >> bit) & 1u) == 0u) {
    out[i] = 0;
    return;
  }
  const int rank = __ldg(table + coarse_rows * kLanes + w) +
                   __popc(cw & ((1u << bit) - 1u));
  const bool overflow = rank >= cap_blocks;
  const int within = ((x & 7) * 8 + (y & 7)) * 8 + (z & 7);
  const int safe = min(rank, cap_blocks - 1) * kBlockWords + (within >> 5);
  const uint32_t fw = static_cast<uint32_t>(
      __ldg(table + (coarse_rows + rank_rows) * kLanes + safe));
  const bool fine = ((fw >> (within & 31)) & 1u) != 0u;
  out[i] = (fine || overflow) ? 1 : 0;
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
