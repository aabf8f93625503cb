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
// Indices may come in any order. Both count an index in [-size, -1] from
// the end, as their oracles' NumPy-style indexing does. Past that they
// differ: the gather clamps any other index into [0, size - 1], as its
// oracle `_mxu_gather_jnp` (:116) does (XLA's gather); the scatter drops
// it, as `_mxu_scatter_jnp` (:205) does (`.at[].add`).
//
// What bounds them on an H100: one index read, one value read per feature
// and the output written once; at the serving chunk's (1, 5, 24,576) ->
// (1, 5, 13, 128) that is 0.6 MB, a fraction of a microsecond of HBM time,
// so a call costs what its graph nodes and the latency chain of its
// longest block cost.
//
// The scatter's design. The TPU kernel keeps the output block in VMEM
// across its sequential grid and writes it once. Fused path, for calls of
// at least 16,384 elements whose level planes take at most 1 MiB (the
// serving chunks; the plan, `seg_scatter_plan`, decides from the shapes):
// one launch, a cluster of kScatterCluster blocks per level. Each block
// loads its first elements (4 neighbours per thread, 16-byte loads),
// zeroes its share of the level's output planes with 16-byte stores and
// arrives at the cluster barrier (release); it then sums each thread's
// runs of equal indices, then the warp's runs of equal neighbouring tails
// with shuffles (the composite's ray ids are sorted, ~16 elements a ray),
// and only after waiting at the barrier (acquire: every block's zeros are
// in place) adds each run once with a fire-and-forget f32 atomic (RED) to
// the output. The loads and the sums hide the barrier's latency, and the
// call is one graph node where the parent's was two (a memset and an
// atomic kernel).
// Measured on an H100 80GB HBM3 at 700 W (kernel_timing.py seg-scatter,
// PERF.md section 6): the planes resident in shared memory instead, summed
// over the cluster through distributed shared memory and stored whole,
// took 0.0075 ms at the serving chunk, 3.8 us of it the launch, the
// zeroing, two cluster barriers and the stores alone (shared f32 atomics
// are compare-and-swap loops on sm_90); this path takes 0.0040. Ids with
// few repeats (unsorted) put one atomic per element on the cluster's 8
// SMs and run slower than the atomic path, which spreads them over the
// card (0.0168 against 0.0054 ms at the serving chunk's shape), so the
// fused path is fast only for ids in runs; the plan cannot see the order,
// and the port's callers (occupancy.py) pass sorted ray ids.
// Atomic path, for the other calls (smaller ones, and planes a memset
// zeroes faster than a cluster): the output zeroed by cudaMemsetAsync and
// one thread per element with an fp32 atomicAdd.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash_common.cuh"

namespace {

namespace cg = cooperative_groups;

// Threads of a fused scatter block; the neighbouring elements each thread
// loads with one 16-byte load per row and sums along its own runs before
// any lane talks to another; the most features and blocks per level it
// takes; and the warp's run count past which each lane adds on its own.
// Clusters of 8, the portable most: at the serving chunk's 24,576
// elements 0.0039 ms against 0.0055 with 4 blocks, 0.0071 with 2 and
// 0.0117 with 1, each block's first chunk its only one (an H100 80GB HBM3
// at 700 W; kernel_timing.py seg-scatter, variants
// NAME=PATH:kScatterCluster=N).
constexpr int kScatterThreads = 1024;
constexpr int kPerThread = 4;
constexpr int kScatterMaxFeats = 8;
constexpr int kScatterCluster = 8;
constexpr int kScatterRuns = 24;
static_assert(kPerThread % 4 == 0, "a thread loads whole 16-byte groups");

// The scatter's flat index of j: from the end when negative, -1 when out
// of range.
__device__ __forceinline__ int scatter_index(int j, int table_size) {
  if (j < 0) j += table_size;
  return j >= 0 && j < table_size ? j : -1;
}

__global__ void seg_gather_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ table,
                                  float* __restrict__ out, int feats, int m,
                                  int table_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int lf = blockIdx.y;
  const int l = lf / feats;
  int j = idx[static_cast<size_t>(l) * m + i];
  if (j < 0) j += table_size;          // from the end, then clamped
  j = min(max(j, 0), table_size - 1);  // as XLA's gather does
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
  const int j = scatter_index(idx[static_cast<size_t>(l) * m + i],
                              table_size);
  if (j < 0) return;
  atomicAdd(out + static_cast<size_t>(lf) * table_size + j,
            g[static_cast<size_t>(lf) * m + i]);
}

// The kPerThread elements of this thread from i0 (keys -1 past m, or
// dropped), with 16-byte loads where the rows allow.
template <int F>
__device__ __forceinline__ void scatter_load(
    const int* __restrict__ il, const float* __restrict__ gl, int m,
    int table_size, bool vec, int i0, int (&key)[kPerThread],
    float (&v)[kPerThread][F]) {
  if (vec && i0 < m) {  // M % 4 == 0: the thread's 4-groups are all in
#pragma unroll
    for (int q = 0; q < kPerThread; q += 4) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(il + i0 + q));
      key[q] = scatter_index(k.x, table_size);
      key[q + 1] = scatter_index(k.y, table_size);
      key[q + 2] = scatter_index(k.z, table_size);
      key[q + 3] = scatter_index(k.w, table_size);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(
            gl + static_cast<size_t>(f) * m + i0 + q));
        v[q][f] = t.x;
        v[q + 1][f] = t.y;
        v[q + 2][f] = t.z;
        v[q + 3][f] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int i = i0 + e;
      key[e] = i < m ? scatter_index(__ldg(il + i), table_size) : -1;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[e][f] = i < m ? __ldg(gl + static_cast<size_t>(f) * m + i) : 0.0f;
      }
    }
  }
}

// Each thread's runs summed into their last element (a run ends at e when
// key[e + 1] differs), and the runs that end at the thread's last element
// summed over the warp's equal neighbours. Returns whether this lane adds
// that last run. Called by all 32 lanes.
template <int F>
__device__ __forceinline__ bool scatter_sum(const int (&key)[kPerThread],
                                            float (&v)[kPerThread][F]) {
#pragma unroll
  for (int e = 1; e < kPerThread; ++e) {
    if (key[e] == key[e - 1]) {
#pragma unroll
      for (int f = 0; f < F; ++f) v[e][f] += v[e - 1][f];
    }
  }
  return nerficg::warp_run_sum(key[kPerThread - 1], v[kPerThread - 1],
                               kScatterRuns);
}

// Adds the runs scatter_sum left: those ending inside the thread, and the
// last one where this lane adds it (tail).
template <int F>
__device__ __forceinline__ void scatter_adds(float* __restrict__ ol,
                                             int table_size, bool tail,
                                             const int (&key)[kPerThread],
                                             const float (&v)[kPerThread][F]) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const bool ends = e == kPerThread - 1 ? tail
                                          : key[e] >= 0 && key[e] != key[e + 1];
    if (ends) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        atomicAdd(ol + static_cast<size_t>(f) * table_size + key[e], v[e][f]);
      }
    }
  }
}

// One block of a level's cluster (grid: kScatterCluster x L): load its
// first chunk of kPerThread * T elements, zero the block's share of the
// level's F output planes, arrive at the cluster barrier, sum the chunk,
// and add it once every block of the cluster has arrived; then the chunks
// rank + cluster, rank + 2 cluster, ...
template <int F>
__global__ void __launch_bounds__(kScatterThreads)
    seg_scatter_add_fused_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ g,
                                 float* __restrict__ out, int m,
                                 int table_size) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int l = blockIdx.y;
  const int* il = idx + static_cast<size_t>(l) * m;
  const float* gl = g + static_cast<size_t>(l) * F * m;
  // 16-byte aligned rows (M % 4 == 0) load as int4 / float4.
  const bool vec =
      ((m & 3) | ((reinterpret_cast<uintptr_t>(idx) |
                   reinterpret_cast<uintptr_t>(g)) & 15)) == 0;
  constexpr int kStep = kPerThread * kScatterThreads;
  int key[kPerThread];
  float v[kPerThread][F];
  // The first chunk's loads go out before the zeroing, and its sums run
  // before the wait, so both hide the barrier's latency. The bounds are
  // uniform across the block, so whole warps run each step.
  int base = rank * kStep;
  scatter_load(il, gl, m, table_size, vec, base + kPerThread * threadIdx.x,
               key, v);
  float* ol = out + static_cast<size_t>(l) * F * table_size;
  const int quads = F * table_size / 4;  // table_size is a multiple of 128
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = rank * kScatterThreads + threadIdx.x; q < quads;
       q += blocks * kScatterThreads) {
    reinterpret_cast<float4*>(ol)[q] = zero;
  }
  // Release: this thread's zeros before any block's adds.
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  bool tail = scatter_sum(key, v);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  scatter_adds(ol, table_size, tail, key, v);
  for (base += blocks * kStep; base < m; base += blocks * kStep) {
    scatter_load(il, gl, m, table_size, vec,
                 base + kPerThread * threadIdx.x, key, v);
    tail = scatter_sum(key, v);
    scatter_adds(ol, table_size, tail, key, v);
  }
}

template <int F>
cudaError_t launch_fused(const int* idx, const float* g, float* out,
                         int levels, int m, int table_size,
                         cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kScatterCluster, levels);
  config.blockDim = dim3(kScatterThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kScatterCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, seg_scatter_add_fused_kernel<F>, idx, g,
                            out, m, table_size);
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
// fused != 0: the fused path (F <= kScatterMaxFeats, as the wrapper's plan
// guarantees); 0: the atomic path.
extern "C" int nerficg_seg_scatter_add(const void* idx, const void* g,
                                       void* out, int levels, int feats,
                                       int m, int rows, int fused,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (levels * feats == 0) return static_cast<int>(cudaGetLastError());
  const int* i = static_cast<const int*>(idx);
  const float* v = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  const int size = rows * 128;
  if (fused != 0) {
    using Launch = cudaError_t (*)(const int*, const float*, float*, int,
                                   int, int, cudaStream_t);
    static constexpr Launch kLaunch[kScatterMaxFeats] = {
        launch_fused<1>, launch_fused<2>, launch_fused<3>, launch_fused<4>,
        launch_fused<5>, launch_fused<6>, launch_fused<7>, launch_fused<8>};
    if (feats > kScatterMaxFeats) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(kLaunch[feats - 1](i, v, o, levels, m, size, s));
  }
  const size_t bytes = static_cast<size_t>(levels) * feats * size *
                       sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(256);
  const dim3 grid((m + block.x - 1) / block.x, levels * feats);
  seg_scatter_add_kernel<<<grid, block, 0, s>>>(i, v, o, feats, m, size);
  return static_cast<int>(cudaGetLastError());
}
