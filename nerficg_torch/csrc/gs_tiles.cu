// 3D Gaussian Splatting: per-tile front-to-back compositing over the
// (tile, depth)-sorted, channel-major entry stream, and its backward.
//
// Replace the TPU kernels nerficg_tpu/ops/gs_tiles_kernel.py
// `_fused_fwd_kernel` (#15, :414; 16-wide with saved per-chunk
// transmittance in training, 8-wide packed in serving) and
// `_fused_bwd_stream_kernel` (#16, :481). The TPU kernels stage three
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
// The function's least work on an H100 (chip_smoke.py's bound): each valid
// (entry, pixel) pair costs 14 f32 operations and one expf for its alpha;
// only where alpha passes 1/255 come 13 more forward, 54 more backward.
// Bytes: 20 (packed) or 40 per entry within k, the 5 output rows and, for
// training, the live transmittance chunks. The design keeps every per-pair
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

// Stage chunk entries [j0, j0 + m) of the segment at `seg` into s[attr][j]
// as f32 attributes with ABSOLUTE means.
template <bool kPacked>
__device__ __forceinline__ void stage(const float* __restrict__ mat,
                                      size_t e_pad, int seg, int j0, int m,
                                      float ox, float oy,
                                      float (*s)[kCH]) {
  if (!kPacked) {
    for (int i = threadIdx.x; i < kAttrs * kCH; i += kP) {
      const int a = i / kCH;
      const int j = i - a * kCH;
      const size_t e = static_cast<size_t>(seg) + j0 + j;
      s[a][j] = (j < m && e < e_pad) ? __ldg(mat + a * e_pad + e) : 0.0f;
    }
    return;
  }
  const int j = threadIdx.x;
  if (j >= kCH) return;
  const size_t e = static_cast<size_t>(seg) + j0 + j;
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

template <bool kPacked, bool kSave>
__global__ void __launch_bounds__(kP)
gs_fwd_kernel(const float* __restrict__ mat, const int* __restrict__ starts,
              const int* __restrict__ counts, float* __restrict__ out,
              float* __restrict__ tacc, size_t e_pad, int tiles_x, int k,
              int nc) {
  __shared__ float s[kAttrs][kCH];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int seg = starts[t];
  const int n = min(max(counts[t], 0), k);
  const float ox = static_cast<float>((t % tiles_x) * kTile);
  const float oy = static_cast<float>((t / tiles_x) * kTile);
  const float px = ox + static_cast<float>(p % kTile) + 0.5f;   // exact
  const float py = oy + static_cast<float>(p / kTile) + 0.5f;
  float trans = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, acc = 0.0f,
        dep = 0.0f;
  const int n_chunks = (n + kCH - 1) / kCH;
  for (int c = 0; c < n_chunks; ++c) {
    if (kSave) tacc[(static_cast<size_t>(t) * nc + c) * kP + p] = trans;
    const int j0 = c * kCH;
    const int m = min(kCH, n - j0);
    __syncthreads();
    stage<kPacked>(mat, e_pad, seg, j0, m, ox, oy, s);
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
  float* o = out + static_cast<size_t>(t) * kOut * kP + p;
  o[0 * kP] = cr;
  o[1 * kP] = cg;
  o[2 * kP] = cb;
  o[3 * kP] = acc;
  o[4 * kP] = dep;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__global__ void __launch_bounds__(kP)
gs_bwd_kernel(const float* __restrict__ mat, const int* __restrict__ starts,
              const int* __restrict__ counts, const float* __restrict__ tacc,
              const float* __restrict__ dout, float* __restrict__ dmat,
              size_t e_pad, int tiles_x, int k, int nc) {
  __shared__ float s[kAttrs][kCH];
  __shared__ float s_trans[kCH][kP];             // T before entry j, per pixel
  __shared__ float s_part[kWarps][kCH][kAttrs];  // per-warp entry gradients
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int seg = starts[t];
  const int n = min(max(counts[t], 0), k);
  const float ox = static_cast<float>((t % tiles_x) * kTile);
  const float oy = static_cast<float>((t / tiles_x) * kTile);
  const float px = ox + static_cast<float>(p % kTile) + 0.5f;
  const float py = oy + static_cast<float>(p / kTile) + 0.5f;
  const float* g_out = dout + static_cast<size_t>(t) * kOut * kP + p;
  const float d_r = g_out[0 * kP], d_g = g_out[1 * kP], d_b = g_out[2 * kP];
  const float d_acc = g_out[3 * kP], d_dep = g_out[4 * kP];
  float suffix = 0.0f;                           // S: sum of g * w after j
  const int n_chunks = (n + kCH - 1) / kCH;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int j0 = c * kCH;
    const int m = min(kCH, n - j0);
    __syncthreads();
    stage<false>(mat, e_pad, seg, j0, m, ox, oy, s);
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
      const int a = i / kCH;
      const int j = i - a * kCH;
      const size_t e = static_cast<size_t>(seg) + j0 + j;
      if (j < m && e < e_pad) {
        float sum = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi][j][a];
        dmat[a * e_pad + e] = sum;
      }
    }
  }
}

template <bool kPacked, bool kSave>
int launch_fwd(const void* mat, const void* starts, const void* counts,
               void* out, void* tacc, int e_pad, int num_tiles, int tiles_x,
               int k, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int nc = (k + kCH - 1) / kCH;
  gs_fwd_kernel<kPacked, kSave>
      <<<num_tiles, kP, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(mat), static_cast<const int*>(starts),
          static_cast<const int*>(counts), static_cast<float*>(out),
          static_cast<float*>(tacc), static_cast<size_t>(e_pad), tiles_x, k,
          nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mat (16, E_pad) f32; starts, counts (T,) i32; out (T, 5, 256) f32;
// tacc (T, ceil(k / 32), 256) f32, written for each tile's live chunks.
extern "C" int nerficg_gs_composite_fwd(const void* mat, const void* starts,
                                        const void* counts, void* out,
                                        void* tacc, int e_pad, int num_tiles,
                                        int tiles_x, int k, void* stream) {
  return launch_fwd<false, true>(mat, starts, counts, out, tacc, e_pad,
                                 num_tiles, tiles_x, k, stream);
}

// mat (8, E_pad) packed words; out (T, 5, 256) f32.
extern "C" int nerficg_gs_composite_fwd_packed(const void* mat,
                                               const void* starts,
                                               const void* counts, void* out,
                                               int e_pad, int num_tiles,
                                               int tiles_x, int k,
                                               void* stream) {
  return launch_fwd<true, false>(mat, starts, counts, out, nullptr, e_pad,
                                 num_tiles, tiles_x, k, stream);
}

// mat (16, E_pad) f32; tacc from the forward; dout (T, 5, 256) f32;
// dmat (16, E_pad) f32, zeroed here.
extern "C" int nerficg_gs_composite_bwd(const void* mat, const void* starts,
                                        const void* counts, const void* tacc,
                                        const void* dout, void* dmat,
                                        int e_pad, int num_tiles, int tiles_x,
                                        int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      dmat, 0, static_cast<size_t>(16) * e_pad * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  gs_bwd_kernel<<<num_tiles, kP, 0, s>>>(
      static_cast<const float*>(mat), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const float*>(tacc),
      static_cast<const float*>(dout), static_cast<float*>(dmat),
      static_cast<size_t>(e_pad), tiles_x, k, (k + kCH - 1) / kCH);
  return static_cast<int>(cudaGetLastError());
}
