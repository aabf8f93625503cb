// The 3DGS rasterizer's entry gather: the (tile, depth)-sorted, channel-
// major stream written straight from the Gaussians' attributes, and its
// gradient gathered back through the inverse permutation.
//
// Replaces no TPU kernel. The JAX package builds the stream with XLA ops
// (nerficg_tpu/ops/gs_rasterize.py :314-330: a stack of the ten attribute
// rows and their D copies, sorted with the keys by `_permute_entries`
// :200, whose custom VJP sorts the gradient back by the permutation). In
// eager PyTorch the same composition copied the (10, D*N) channels,
// gathered them and padded the result, and its backward was index_put_
// with accumulate: a second sort of D*N int64 indices and an accumulation
// into a zeroed (10, D*N) buffer, the largest operation of a 3DGS
// training step on the card. Nothing collides there: the permutation is
// one to one.
//
// This pair computes ops/gs_gather.py `gs_stream_gather_plain` and
// `gs_stream_gather_bwd_plain`.
//
// What bounds it on an H100: memory. The forward writes the 16-row stream
// (64 B an entry) and reads an entry's 40 B of attributes from five
// arrays at a random Gaussian, five or six 32 B sectors; the backward
// reads one int32 per (copy, Gaussian), and ten scattered f32 of the
// stream's gradient for each live entry only.
//
// Design:
//   * forward: one thread per stream column e < E_pad; columns from E on
//     and rows 10-15 are written as zeros, so the stream needs no memset.
//     The attributes are read from the five inputs as they are, with no
//     stacked copy; each row's stores are coalesced.
//   * inv, where autograd needs it: inv[perm[e]] = e for the live entries
//     alone, -1 (a memset) for the rest. An entry is live when it lies in
//     a tile (its sorted tile, read coalesced, is not T) within the first
//     k of the tile's segment (e - starts[t] < k): the only entries the
//     compositor composites, and the only ones whose gradient its backward
//     (#16, csrc/gs_tiles.cu) writes. About 5% of a training view's
//     entries are live; a scattered 4 B store for each of the D*N entries
//     cost the forward half its time.
//   * backward: one thread per Gaussian n, looping d = 0..D-1 in order:
//     e = inv[d N + n] (coalesced); -1 is skipped, which is exact, since
//     #16 wrote zero there; else the ten values of column e are added.
//     The ten sums are kept in registers and written once, every element
//     of the five gradients: no atomics, no zeroing, deterministic.
//   * indices: the wrapper refuses D*N >= 2^31, so positions and inv fit
//     an int32; offsets into the stream are 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;       // rows of the stream
constexpr int kAttrs = 10;      // mx, my, ca, cb, cc, op, r, g, b, d

struct Attrs {
  const float* means2d;         // (N, 2)
  const float* conics;          // (N, 3)
  const float* opacities;       // (N,)
  const float* colors;          // (N, 3)
  const float* depths;          // (N,)
};

struct AttrGrads {
  float* means2d;
  float* conics;
  float* opacities;
  float* colors;
  float* depths;
};

__global__ void __launch_bounds__(kThreads)
    stream_gather_kernel(Attrs in, const int64_t* __restrict__ perm,
                         const int* __restrict__ sorted_tile,
                         const int* __restrict__ starts,
                         float* __restrict__ mat, int* __restrict__ inv,
                         int n, int num_tiles, int k, int64_t e,
                         int64_t e_pad) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (col >= e_pad) return;
  float v[kAttrs];
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) v[a] = 0.0f;
  if (col < e) {
    const int p = static_cast<int>(perm[col]);
    const int g = p % n;
    v[0] = __ldg(in.means2d + 2 * static_cast<int64_t>(g));
    v[1] = __ldg(in.means2d + 2 * static_cast<int64_t>(g) + 1);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[2 + c] = __ldg(in.conics + 3 * static_cast<int64_t>(g) + c);
    v[5] = __ldg(in.opacities + g);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[6 + c] = __ldg(in.colors + 3 * static_cast<int64_t>(g) + c);
    v[9] = __ldg(in.depths + g);
    if (inv != nullptr) {
      const int t = __ldg(sorted_tile + col);
      if (t < num_tiles && col - __ldg(starts + t) < k)
        inv[p] = static_cast<int>(col);
    }
  }
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) mat[a * e_pad + col] = v[a];
#pragma unroll
  for (int a = kAttrs; a < kRows; ++a) mat[a * e_pad + col] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    stream_gather_bwd_kernel(const float* __restrict__ dmat,
                             const int* __restrict__ inv, AttrGrads out,
                             int n, int dup, int64_t e_pad) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  float acc[kAttrs];
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) acc[a] = 0.0f;
  for (int d = 0; d < dup; ++d) {
    const int e = __ldg(inv + static_cast<int64_t>(d) * n + g);
    if (e < 0) continue;
#pragma unroll
    for (int a = 0; a < kAttrs; ++a) acc[a] += __ldg(dmat + a * e_pad + e);
  }
  const int64_t g64 = g;
  out.means2d[2 * g64] = acc[0];
  out.means2d[2 * g64 + 1] = acc[1];
#pragma unroll
  for (int c = 0; c < 3; ++c) out.conics[3 * g64 + c] = acc[2 + c];
  out.opacities[g] = acc[5];
#pragma unroll
  for (int c = 0; c < 3; ++c) out.colors[3 * g64 + c] = acc[6 + c];
  out.depths[g] = acc[9];
}

}  // namespace

// Attributes f32, contiguous: means2d (N, 2), conics (N, 3), opacities
// (N,), colors (N, 3), depths (N,); perm (E,) int64, a permutation of the
// E = D*N entries (entry d N + n is a copy of Gaussian n); mat (16, E_pad)
// f32, every element written. inv (E,) int32 or null: where given,
// inv[perm[e]] = e for each live entry e and -1 elsewhere, from
// sorted_tile (E,) int32 (the tile of column e, T for none) and starts
// (T,) int32.
extern "C" int nerficg_gs_stream_gather(
    const void* means2d, const void* conics, const void* opacities,
    const void* colors, const void* depths, const void* perm,
    const void* sorted_tile, const void* starts, void* mat, void* inv, int n,
    int num_tiles, int k, int64_t e, int64_t e_pad, void* stream) {
  if (e_pad == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inv != nullptr) {
    const cudaError_t err = cudaMemsetAsync(inv, 0xFF, e * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Attrs in = {static_cast<const float*>(means2d),
                    static_cast<const float*>(conics),
                    static_cast<const float*>(opacities),
                    static_cast<const float*>(colors),
                    static_cast<const float*>(depths)};
  const unsigned blocks =
      static_cast<unsigned>((e_pad + kThreads - 1) / kThreads);
  stream_gather_kernel<<<blocks, kThreads, 0, s>>>(
      in, static_cast<const int64_t*>(perm),
      static_cast<const int*>(sorted_tile), static_cast<const int*>(starts),
      static_cast<float*>(mat), static_cast<int*>(inv), n, num_tiles, k, e,
      e_pad);
  return static_cast<int>(cudaGetLastError());
}

// dmat (16, E_pad) f32, zero at every entry that is not live (#16's
// contract); inv (D*N,) int32 from the forward. The five gradients f32 in
// the attributes' shapes, every element written.
extern "C" int nerficg_gs_stream_gather_bwd(
    const void* dmat, const void* inv, void* d_means2d, void* d_conics,
    void* d_opacities, void* d_colors, void* d_depths, int n, int dup,
    int64_t e_pad, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const AttrGrads out = {static_cast<float*>(d_means2d),
                         static_cast<float*>(d_conics),
                         static_cast<float*>(d_opacities),
                         static_cast<float*>(d_colors),
                         static_cast<float*>(d_depths)};
  const int blocks = (n + kThreads - 1) / kThreads;
  stream_gather_bwd_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dmat), static_cast<const int*>(inv), out, n,
      dup, e_pad);
  return static_cast<int>(cudaGetLastError());
}
