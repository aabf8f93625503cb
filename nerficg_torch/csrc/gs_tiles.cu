// 3D Gaussian Splatting: per-tile front-to-back compositing over the
// (tile, depth)-sorted, channel-major entry stream, or over per-tile slot
// windows, and the backward of each.
//
// Replace the TPU kernels nerficg_tpu/ops/gs_tiles_kernel.py
// `_fused_fwd_kernel` (#15, :414; 16-wide with saved per-chunk
// transmittance in training, 8-wide packed in serving) and
// `_fused_bwd_stream_kernel` (#16, :481) on the stream, and `_fwd_kernel`
// (#13, :164) and `_bwd_kernel` (#14, :200) on the slots of
// `composite_tiles` (:361): slots (T, K, 10) f32 entry-major, each tile's
// first min(count, K) composited, pixel origins read from `origins` (T, 2)
// (the TPU kernel derives them from tiles_x; the oracle `_composite_jnp`
// :322 reads them; the two agree on row-major origins). The slot kernels
// are the stream kernels with another source: the same per-chunk staging,
// front-to-back loop and reverse walk. Their output is (T, 8, 256), the
// function's, with three zero rows; their backward has no saved
// transmittance, so it first walks the tile forward to record each chunk's
// starting transmittance into a scratch (T, ceil(K / CH), 256) buffer, as
// the TPU kernel's first pass does, and writes d slots (T, K, 10), zero past
// each count. The TPU kernels stage three
// k-aligned blocks of the stream per tile, composite 128-entry chunks with
// Hillis-Steele scans and take the backward's suffix sums with tril
// matmuls, all for Mosaic's lane alignment. None of that carries over:
//
//   * one 256-thread block per 16x16 tile, one thread per pixel; the block
//     stages its segment [start, start + min(count, k)) into shared memory
//     CH entries at a time, and each thread composites front to back in
//     registers (T, rgb, acc, depth). No early stop at a transmittance
//     threshold: the function composites every entry up to k.
//   * the 16-wide forward saves each pixel's transmittance at the start of
//     every chunk the tile composites, tacc (T, ceil(k / CH), P); chunks at
//     and past ceil(min(count, k) / CH) are left unwritten (the backward
//     never reads them).
//   * the output is (T, 5, P): rgb, acc, depth. The TPU layout's three zero
//     rows (sublane padding to 8) are not written.
//   * the backward walks each tile's chunks in reverse. Within a chunk it
//     recomputes alpha and the transmittance before each entry from the
//     saved chunk start (never dividing by 1 - alpha to undo a step), then
//     walks the chunk backwards carrying S, the suffix sum of g * w over
//     later entries:
//       dL/dalpha_j = g_j T_j - S_j / (1 - alpha_j)  where 1/255 < a_raw < 0.99
//       g = <dL/drgb, color> + dL/dacc + depth * dL/ddepth.
//     dpow is zero where the raw power is > 0 (the oracle's min(power, 0)).
//   * every stream entry belongs to exactly one tile, so its gradient is a
//     sum over that tile's 256 pixels: a warp-shuffle reduction, the 8
//     warp partials in shared memory summed in a fixed order, one plain
//     store per (entry, channel). No atomics: the gradient is reproducible.
//     Rows past k and the guard rows stay zero (memset first). A warp none
//     of whose 32 pixels an entry reaches (alpha <= 1/255 on every lane, the
//     common case) writes zero partials and skips the entry's 10 sums.
//
// The geometry (dx, dy, power, a_raw) uses _rn intrinsics in the plain
// version's order of operations, so nvcc cannot contract it into FMAs: the
// alpha > 1/255 test then sees the plain version's bits on the card, and no
// entry flips across the threshold (a flip would move a pixel by ~0.004).
//
// The functions' least work on an H100 (chip_smoke.py's bound): each valid
// (entry, pixel) pair costs 14 f32 operations and one expf for its alpha;
// only where alpha passes 1/255 come 13 more forward, 54 more backward.
// Bytes: 20 (packed) or 40 per entry within k, the 5 output rows and, for
// training, the live transmittance chunks; for the slots, the 40 bytes of
// each slot within its count, 8 output rows, and 40 bytes of d slots per
// slot. The design keeps every per-pair
// intermediate in registers and shared memory: device memory sees each
// entry once per tile, the output and the transmittance.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;
constexpr int kP = kTile * kTile;   // pixels per tile = threads per block
constexpr int kWarps = kP / 32;
constexpr int kCH = 32;             // entries per chunk (ops/gs_tiles_kernel.CH)
constexpr int kAttrs = 10;          // mx my ca cb cc op r g b d
constexpr int kOut = 5;             // output rows: r g b acc depth
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kMeansStep = 1.0f / 32.0f;   // 1 / MEANS_FP_SCALE
constexpr float kMeansBias = 1024.0f;

// Where a tile's entries come from.
enum Layout {
  kStream = 0,   // (16, E_pad) channel-major stream, tile segments
  kPacked = 1,   // (8, E_pad) packed stream (serving)
  kSlots = 2,    // (T, K, 10) slots, entry-major, origins given
};

struct Tiles {
  const float* mat;       // the stream or the slots
  const int* starts;      // streams: each tile's first entry
  const int* counts;      // (T,)
  const float* origins;   // slots: (T, 2) pixel origins
  size_t e_pad;           // streams: entries per row
  int tiles_x;            // streams: tiles per image row
  int k;                  // entries composited per tile at most (K)
};

// Output rows per tile: the stream path writes rgb, acc, depth; the slot
// path writes the function's (T, 8, 256) with three zero rows.
template <int L>
__host__ __device__ constexpr int out_rows() {
  return L == kSlots ? 8 : kOut;
}

template <int L>
__device__ __forceinline__ void tile_origin(const Tiles& tl, int t, float* ox,
                                            float* oy) {
  if (L == kSlots) {
    *ox = tl.origins[2 * t];
    *oy = tl.origins[2 * t + 1];
  } else {
    *ox = static_cast<float>((t % tl.tiles_x) * kTile);
    *oy = static_cast<float>((t / tl.tiles_x) * kTile);
  }
}

// Index of the tile's first entry: in the stream, or in the slots' rows.
template <int L>
__device__ __forceinline__ size_t tile_start(const Tiles& tl, int t) {
  return L == kSlots ? static_cast<size_t>(t) * tl.k
                     : static_cast<size_t>(tl.starts[t]);
}

// Stage chunk entries [j0, j0 + m) of the tile's entries from `seg` into
// s[attr][j] as f32 attributes with ABSOLUTE means.
template <int L>
__device__ __forceinline__ void stage(const Tiles& tl, size_t seg, int j0,
                                      int m, float ox, float oy,
                                      float (*s)[kCH]) {
  const float* __restrict__ mat = tl.mat;
  const size_t e_pad = tl.e_pad;
  if (L == kSlots) {
    // Entry-major rows: consecutive threads read consecutive words.
    const float* rows = mat + (seg + j0) * kAttrs;
    for (int i = threadIdx.x; i < kAttrs * kCH; i += kP) {
      const int j = i / kAttrs;
      s[i - j * kAttrs][j] = j < m ? __ldg(rows + i) : 0.0f;
    }
    return;
  }
  if (L == kStream) {
    for (int i = threadIdx.x; i < kAttrs * kCH; i += kP) {
      const int a = i / kCH;
      const int j = i - a * kCH;
      const size_t e = seg + j0 + j;
      s[a][j] = (j < m && e < e_pad) ? __ldg(mat + a * e_pad + e) : 0.0f;
    }
    return;
  }
  const int j = threadIdx.x;
  if (j >= kCH) return;
  const size_t e = seg + j0 + j;
  uint32_t w[5] = {0u, 0u, 0u, 0u, 0u};
  if (j < m && e < e_pad) {
#pragma unroll
    for (int r = 0; r < 5; ++r) w[r] = __float_as_uint(__ldg(mat + r * e_pad + e));
  }
  s[0][j] = __fadd_rn(__fsub_rn(__fmul_rn(static_cast<float>(w[0] >> 16),
                                          kMeansStep), kMeansBias), ox);
  s[1][j] = __fadd_rn(__fsub_rn(__fmul_rn(static_cast<float>(w[0] & 0xFFFFu),
                                          kMeansStep), kMeansBias), oy);
#pragma unroll
  for (int r = 1; r < 5; ++r) {
    s[2 * r][j] = __uint_as_float(w[r] & 0xFFFF0000u);
    s[2 * r + 1][j] = __uint_as_float(w[r] << 16);
  }
}

// Raw power -0.5 * (ca dx dx + cc dy dy) - cb dx dy, in the plain version's
// order of operations, without contraction.
__device__ __forceinline__ float raw_power(float ca, float cb, float cc,
                                           float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// Pixel centre of thread p: origin + (p % 16 + 0.5), the plain version's
// order (exact for the streams' integer origins).
__device__ __forceinline__ void pixel(float ox, float oy, int p, float* px,
                                      float* py) {
  *px = __fadd_rn(ox, static_cast<float>(p % kTile) + 0.5f);
  *py = __fadd_rn(oy, static_cast<float>(p / kTile) + 0.5f);
}

template <int L, bool kSave>
__global__ void __launch_bounds__(kP)
gs_fwd_kernel(Tiles tl, float* __restrict__ out, float* __restrict__ tacc,
              int nc) {
  __shared__ float s[kAttrs][kCH];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const size_t seg = tile_start<L>(tl, t);
  const int n = min(max(tl.counts[t], 0), tl.k);
  float ox, oy, px, py;
  tile_origin<L>(tl, t, &ox, &oy);
  pixel(ox, oy, p, &px, &py);
  float trans = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, acc = 0.0f,
        dep = 0.0f;
  const int n_chunks = (n + kCH - 1) / kCH;
  for (int c = 0; c < n_chunks; ++c) {
    if (kSave) tacc[(static_cast<size_t>(t) * nc + c) * kP + p] = trans;
    const int j0 = c * kCH;
    const int m = min(kCH, n - j0);
    __syncthreads();
    stage<L>(tl, seg, j0, m, ox, oy, s);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float dx = __fsub_rn(px, s[0][j]);
      const float dy = __fsub_rn(py, s[1][j]);
      const float power = fminf(raw_power(s[2][j], s[3][j], s[4][j], dx, dy),
                                0.0f);
      const float a_raw = __fmul_rn(s[5][j], expf(power));
      if (!(a_raw > kAlphaMin)) continue;   // alpha 0: nothing changes
      const float alpha = fminf(a_raw, kAlphaMax);
      const float w = trans * alpha;
      cr += s[6][j] * w;
      cg += s[7][j] * w;
      cb += s[8][j] * w;
      acc += w;
      dep += s[9][j] * w;
      trans = trans * (1.0f - alpha);
    }
  }
  float* o = out + static_cast<size_t>(t) * out_rows<L>() * kP + p;
  o[0 * kP] = cr;
  o[1 * kP] = cg;
  o[2 * kP] = cb;
  o[3 * kP] = acc;
  o[4 * kP] = dep;
#pragma unroll
  for (int r = kOut; r < out_rows<L>(); ++r) o[r * kP] = 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// Alpha of staged entry j at pixel (px, py), 0 where a_raw <= 1/255.
__device__ __forceinline__ float staged_alpha(float (*s)[kCH], int j,
                                              float px, float py) {
  const float dx = __fsub_rn(px, s[0][j]);
  const float dy = __fsub_rn(py, s[1][j]);
  const float power = fminf(raw_power(s[2][j], s[3][j], s[4][j], dx, dy),
                            0.0f);
  const float a_raw = __fmul_rn(s[5][j], expf(power));
  return a_raw > kAlphaMin ? fminf(a_raw, kAlphaMax) : 0.0f;
}

// The stream backward reads the forward's saved transmittance; the slot
// backward (kSlots) first records it into `tacc` itself.
template <int L>
__global__ void __launch_bounds__(kP)
gs_bwd_kernel(Tiles tl, float* __restrict__ tacc,
              const float* __restrict__ dout, float* __restrict__ dmat,
              int nc) {
  __shared__ float s[kAttrs][kCH];
  __shared__ float s_trans[kCH][kP];             // T before entry j, per pixel
  __shared__ float s_part[kWarps][kCH][kAttrs];  // per-warp entry gradients
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const size_t seg = tile_start<L>(tl, t);
  const int n = min(max(tl.counts[t], 0), tl.k);
  float ox, oy, px, py;
  tile_origin<L>(tl, t, &ox, &oy);
  pixel(ox, oy, p, &px, &py);
  const float* g_out = dout + static_cast<size_t>(t) * out_rows<L>() * kP + p;
  const float d_r = g_out[0 * kP], d_g = g_out[1 * kP], d_b = g_out[2 * kP];
  const float d_acc = g_out[3 * kP], d_dep = g_out[4 * kP];
  float suffix = 0.0f;                           // S: sum of g * w after j
  const int n_chunks = (n + kCH - 1) / kCH;
  if (L == kSlots) {
    // Pass 1: each chunk's starting transmittance, as the forward has it.
    float trans = 1.0f;
    for (int c = 0; c < n_chunks; ++c) {
      tacc[(static_cast<size_t>(t) * nc + c) * kP + p] = trans;
      const int j0 = c * kCH;
      const int m = min(kCH, n - j0);
      __syncthreads();
      stage<L>(tl, seg, j0, m, ox, oy, s);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        trans = trans * (1.0f - staged_alpha(s, j, px, py));
      }
    }
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int j0 = c * kCH;
    const int m = min(kCH, n - j0);
    __syncthreads();
    stage<L>(tl, seg, j0, m, ox, oy, s);
    __syncthreads();
    // Forward through the chunk from its saved starting transmittance.
    float trans = tacc[(static_cast<size_t>(t) * nc + c) * kP + p];
    for (int j = 0; j < m; ++j) {
      s_trans[j][p] = trans;
      const float dx = __fsub_rn(px, s[0][j]);
      const float dy = __fsub_rn(py, s[1][j]);
      const float power = fminf(raw_power(s[2][j], s[3][j], s[4][j], dx, dy),
                                0.0f);
      const float a_raw = __fmul_rn(s[5][j], expf(power));
      if (a_raw > kAlphaMin) trans = trans * (1.0f - fminf(a_raw, kAlphaMax));
    }
    // Backward through the chunk.
    for (int j = m - 1; j >= 0; --j) {
      const float ca = s[2][j], cbc = s[3][j], cc = s[4][j], op = s[5][j];
      const float dx = __fsub_rn(px, s[0][j]);
      const float dy = __fsub_rn(py, s[1][j]);
      const float pw = raw_power(ca, cbc, cc, dx, dy);
      const float ep = expf(fminf(pw, 0.0f));
      const float a_raw = __fmul_rn(op, ep);
      if (!__any_sync(0xFFFFFFFFu, a_raw > kAlphaMin)) {
        // No pixel of this warp composites entry j: every term below is 0.
        if (lane == 0) {
#pragma unroll
          for (int a = 0; a < kAttrs; ++a) s_part[warp][j][a] = 0.0f;
        }
        continue;
      }
      const float tj = s_trans[j][p];
      const float alpha = a_raw > kAlphaMin ? fminf(a_raw, kAlphaMax) : 0.0f;
      const float w = tj * alpha;
      const float g = d_r * s[6][j] + d_g * s[7][j] + d_b * s[8][j] + d_acc +
                      s[9][j] * d_dep;
      float d_alpha = 0.0f;
      if (a_raw > kAlphaMin && a_raw < kAlphaMax)
        d_alpha = g * tj - suffix / (1.0f - alpha);
      suffix += g * w;
      const float d_op = d_alpha * ep;
      const float d_pow = pw > 0.0f ? 0.0f : d_alpha * op * ep;
      float v[kAttrs];
      v[0] = d_pow * (ca * dx + cbc * dy);
      v[1] = d_pow * (cc * dy + cbc * dx);
      v[2] = d_pow * (-0.5f * dx * dx);
      v[3] = d_pow * (-dx * dy);
      v[4] = d_pow * (-0.5f * dy * dy);
      v[5] = d_op;
      v[6] = w * d_r;
      v[7] = w * d_g;
      v[8] = w * d_b;
      v[9] = w * d_dep;
#pragma unroll
      for (int a = 0; a < kAttrs; ++a) {
        const float sum = warp_sum(v[a]);
        if (lane == 0) s_part[warp][j][a] = sum;
      }
    }
    __syncthreads();
    for (int i = p; i < kAttrs * kCH; i += kP) {
      // Slots: a fastest, so consecutive threads write consecutive words.
      const int a = L == kSlots ? i % kAttrs : i / kCH;
      const int j = L == kSlots ? i / kAttrs : i - a * kCH;
      const size_t e = seg + j0 + j;
      if (j < m && (L == kSlots || e < tl.e_pad)) {
        float sum = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi][j][a];
        dmat[L == kSlots ? e * kAttrs + a : a * tl.e_pad + e] = sum;
      }
    }
  }
}

Tiles stream_tiles(const void* mat, const void* starts, const void* counts,
                   int e_pad, int tiles_x, int k) {
  return Tiles{static_cast<const float*>(mat), static_cast<const int*>(starts),
               static_cast<const int*>(counts), nullptr,
               static_cast<size_t>(e_pad), tiles_x, k};
}

Tiles slot_tiles(const void* slots, const void* counts, const void* origins,
                 int k) {
  return Tiles{static_cast<const float*>(slots), nullptr,
               static_cast<const int*>(counts),
               static_cast<const float*>(origins), 0, 0, k};
}

template <int L, bool kSave>
int launch_fwd(const Tiles& tl, void* out, void* tacc, int num_tiles,
               void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int nc = (tl.k + kCH - 1) / kCH;
  gs_fwd_kernel<L, kSave>
      <<<num_tiles, kP, 0, static_cast<cudaStream_t>(stream)>>>(
          tl, static_cast<float*>(out), static_cast<float*>(tacc), nc);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_bwd(const Tiles& tl, void* tacc, const void* dout, void* dmat,
               size_t dmat_bytes, int num_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dmat, 0, dmat_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  gs_bwd_kernel<L><<<num_tiles, kP, 0, s>>>(
      tl, static_cast<float*>(tacc), static_cast<const float*>(dout),
      static_cast<float*>(dmat), (tl.k + kCH - 1) / kCH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mat (16, E_pad) f32; starts, counts (T,) i32; out (T, 5, 256) f32;
// tacc (T, ceil(k / 32), 256) f32, written for each tile's live chunks.
extern "C" int nerficg_gs_composite_fwd(const void* mat, const void* starts,
                                        const void* counts, void* out,
                                        void* tacc, int e_pad, int num_tiles,
                                        int tiles_x, int k, void* stream) {
  return launch_fwd<kStream, true>(
      stream_tiles(mat, starts, counts, e_pad, tiles_x, k), out, tacc,
      num_tiles, stream);
}

// mat (8, E_pad) packed words; out (T, 5, 256) f32.
extern "C" int nerficg_gs_composite_fwd_packed(const void* mat,
                                               const void* starts,
                                               const void* counts, void* out,
                                               int e_pad, int num_tiles,
                                               int tiles_x, int k,
                                               void* stream) {
  return launch_fwd<kPacked, false>(
      stream_tiles(mat, starts, counts, e_pad, tiles_x, k), out, nullptr,
      num_tiles, stream);
}

// mat (16, E_pad) f32; tacc from the forward; dout (T, 5, 256) f32;
// dmat (16, E_pad) f32, zeroed here.
extern "C" int nerficg_gs_composite_bwd(const void* mat, const void* starts,
                                        const void* counts, const void* tacc,
                                        const void* dout, void* dmat,
                                        int e_pad, int num_tiles, int tiles_x,
                                        int k, void* stream) {
  return launch_bwd<kStream>(
      stream_tiles(mat, starts, counts, e_pad, tiles_x, k),
      const_cast<void*>(tacc), dout, dmat,
      static_cast<size_t>(16) * e_pad * sizeof(float), num_tiles, stream);
}

// slots (T, K, 10) f32; counts (T,) i32; origins (T, 2) f32; out (T, 8, 256)
// f32 (rows r, g, b, acc, depth, 0, 0, 0).
extern "C" int nerficg_gs_tiles_fwd(const void* slots, const void* counts,
                                    const void* origins, void* out,
                                    int num_tiles, int k, void* stream) {
  return launch_fwd<kSlots, false>(slot_tiles(slots, counts, origins, k), out,
                                   nullptr, num_tiles, stream);
}

// slots, counts, origins as for the forward; tacc (T, ceil(K / 32), 256) f32
// scratch; dout (T, 8, 256) f32; dslots (T, K, 10) f32, zeroed here.
extern "C" int nerficg_gs_tiles_bwd(const void* slots, const void* counts,
                                    const void* origins, void* tacc,
                                    const void* dout, void* dslots,
                                    int num_tiles, int k, void* stream) {
  return launch_bwd<kSlots>(
      slot_tiles(slots, counts, origins, k), tacc, dout, dslots,
      static_cast<size_t>(num_tiles) * k * kAttrs * sizeof(float), num_tiles,
      stream);
}
