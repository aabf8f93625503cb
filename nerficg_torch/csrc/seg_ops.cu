// Segment gather and scatter-add by flat table index.
//
// Replace the TPU kernels nerficg_tpu/ops/hash_mxu.py `_gather_kernel`
// (:65, via `_mxu_gather_pallas` :83) and `_scatter_kernel` (:144, via
// `_mxu_scatter_pallas` :169), which build one-hot matrices for the MXU
// because a TPU has no vector gather and no atomics. On the serving path
// they carry composite_packed's per-ray segment offsets and its 5-channel
// per-ray sums (nerficg_tpu/ops/occupancy.py :451-485).
//
//   gather:      out[l, f, m] = table[l, f].flat[idx[l, m]]
//   scatter-add: out[l, f].flat[idx[l, m]] += g[l, f, m], out zeroed first
//
// What bounds them on an H100: one index read, one value read and one
// (atomic) write per element; the segment tables are a few KiB and live in
// L2. The scatter's fp32 atomics collide when consecutive elements belong
// to the same ray (blocks of a ray are contiguous), so same-address atomics
// serialise inside a warp; a warp-level segmented reduction is the next
// step if the composite shows up in the profile.
#include <cuda_runtime.h>

namespace {

__global__ void seg_gather_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ table,
                                  float* __restrict__ out, int feats, int m,
                                  int table_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int lf = blockIdx.y;
  const int l = lf / feats;
  int j = idx[static_cast<size_t>(l) * m + i];
  j = min(max(j, 0), table_size - 1);  // gathers clamp, as in XLA
  out[static_cast<size_t>(lf) * m + i] =
      __ldg(table + static_cast<size_t>(lf) * table_size + j);
}

__global__ void seg_scatter_add_kernel(const int* __restrict__ idx,
                                       const float* __restrict__ g,
                                       float* __restrict__ out, int feats,
                                       int m, int table_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int lf = blockIdx.y;
  const int l = lf / feats;
  const int j = idx[static_cast<size_t>(l) * m + i];
  if (j < 0 || j >= table_size) return;  // scatters drop, as in XLA
  atomicAdd(out + static_cast<size_t>(lf) * table_size + j,
            g[static_cast<size_t>(lf) * m + i]);
}

}  // namespace

// idx (L, M) i32; table (L, F, R, 128) f32; out (L, F, M) f32.
extern "C" int nerficg_seg_gather(const void* idx, const void* table,
                                  void* out, int levels, int feats, int m,
                                  int rows, void* stream) {
  if (m == 0 || levels * feats == 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(256);
  const dim3 grid((m + block.x - 1) / block.x, levels * feats);
  seg_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(table),
      static_cast<float*>(out), feats, m, rows * 128);
  return static_cast<int>(cudaGetLastError());
}

// idx (L, M) i32; g (L, F, M) f32; out (L, F, R, 128) f32, zeroed here.
extern "C" int nerficg_seg_scatter_add(const void* idx, const void* g,
                                       void* out, int levels, int feats,
                                       int m, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(levels) * feats * rows * 128 *
                       sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || levels * feats == 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(256);
  const dim3 grid((m + block.x - 1) / block.x, levels * feats);
  seg_scatter_add_kernel<<<grid, block, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(g),
      static_cast<float*>(out), feats, m, rows * 128);
  return static_cast<int>(cudaGetLastError());
}
