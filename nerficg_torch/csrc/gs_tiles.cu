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
//   * most (entry, pixel) pairs of a tile have alpha 0 (at 1080p 8.1% pass
//     1/255), and the per-pair geometry and expf were the forward's pace.
//     Both directions bound each entry's reach per warp strip (strip_reach,
//     two pixel rows) when they stage it, and a warp walks only the entries
//     that reach its strip; the forward double-buffers its chunks, packed
//     as 16-byte vectors, and loads the next one while it composites.
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
//     sum over that tile's 256 pixels. A reduction across the lanes of a
//     warp costs five shuffles per value, 50 per (entry, warp) for the 10
//     gradients, and an SM retires one warp-wide shuffle per clock: that
//     network set the pace of the first version of this kernel. The chunk
//     is instead transposed through shared memory (the per-splat backward
//     of Mallick et al., "Taming 3DGS", arXiv 2406.15643): a pixel pass
//     (thread = pixel) leaves each pair's scalar terms w and dL/dop, and an
//     entry pass (lane = entry) sums each entry's gradients over the warp's
//     32 pixels in series, then the 8 warp partials in a fixed order: one
//     plain store per (entry, channel), no shuffles, no atomics, the
//     gradient reproducible. Pixels no entry of the chunk reaches are
//     skipped. Rows past k and the guard rows stay zero (memset first).
//
// The geometry (dx, dy, power, a_raw) uses _rn intrinsics in the plain
// version's order of operations, so nvcc cannot contract it into FMAs: the
// alpha > 1/255 test then sees the plain version's bits on the card, and no
// entry flips across the threshold (a flip would move a pixel by ~0.004).
//
// The functions' least work on an H100 (chip_smoke.py's bound): a pair
// whose alpha passes 1/255 costs 14 f32 operations and one expf for its
// alpha and 13 more forward, 54 more backward; the other pairs need none,
// since a bound like strip_reach proves most of them zero.
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
// s[attr][j] as f32 attributes (the backward's; the 16-wide stream or the
// slots, all threads of the block).
template <int L>
__device__ __forceinline__ void stage(const Tiles& tl, size_t seg, int j0,
                                      int m, float (*s)[kCH]) {
  static_assert(L != kPacked, "the packed stream has no backward");
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
  for (int i = threadIdx.x; i < kAttrs * kCH; i += kP) {
    const int a = i / kCH;
    const int j = i - a * kCH;
    const size_t e = seg + j0 + j;
    s[a][j] = (j < m && e < e_pad) ? __ldg(mat + a * e_pad + e) : 0.0f;
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

// Bit w set where an entry's alpha may pass 1/255 at a pixel of strip w of
// the tile (pixel rows 2w and 2w + 1, one warp's pixels); all eight bits
// where no bound applies. The bound is conservative: alpha = op e^power >
// 1/255 needs power > -ln(255 op), an ellipse of the conic whose extent is
// sqrt(2 tau cc / det) in x and sqrt(2 tau ca / det) in y; tau is widened
// by 1% and 0.01 and the extents by 1/16 px, far beyond the rounding of
// expf, of the power's _rn arithmetic and of this bound. A conic that is
// not positive definite, or so ill-conditioned that det loses its digits,
// reaches every strip.
__device__ __forceinline__ unsigned strip_reach(float mx, float my, float ca,
                                                float cb, float cc, float op,
                                                float ox, float oy) {
  // a_raw = op e^power <= op: an entry below the threshold passes nowhere.
  if (!(op > kAlphaMin)) return 0u;
  const float det = ca * cc - cb * cb;
  constexpr unsigned kEvery = (1u << kWarps) - 1u;
  if (!(ca > 0.0f && cc > 0.0f && det > 1e-3f * ca * cc)) return kEvery;
  const float tau = 1.01f * logf(255.0f * op) + 0.01f;
  const float ex = sqrtf(2.0f * tau * cc / det) + 0.0625f;
  const float ey = sqrtf(2.0f * tau * ca / det) + 0.0625f;
  if (!(ex <= 3.0e38f && ey <= 3.0e38f)) return kEvery;   // NaN or inf
  // Distance from the mean to the tile's pixel centres in x.
  const float gx = fmaxf(fmaxf(ox + 0.5f - mx, mx - (ox + 15.5f)), 0.0f);
  if (!(gx <= ex)) return 0u;
  unsigned reach = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float lo = oy + static_cast<float>(2 * w) + 0.5f;
    const float gy = fmaxf(fmaxf(lo - my, my - (lo + 1.0f)), 0.0f);
    if (gy <= ey) reach |= 1u << w;
  }
  return reach;
}

// Entry j of the tile's entries from `seg` as the 10 f32 attributes with
// ABSOLUTE means (packed means are tile-relative: the origin is added);
// zeros where j is past the tile's m entries (or the stream's end). The
// forward's, one entry per lane.
template <int L>
__device__ __forceinline__ void load_entry(const Tiles& tl, size_t seg, int j,
                                           int m, float ox, float oy,
                                           float* v) {
  const float* __restrict__ mat = tl.mat;
  const size_t e = seg + j;
  if (L == kSlots) {
#pragma unroll
    for (int a = 0; a < kAttrs; ++a)
      v[a] = j < m ? __ldg(mat + e * kAttrs + a) : 0.0f;
    return;
  }
  const bool ok = j < m && e < tl.e_pad;
  if (L == kStream) {
#pragma unroll
    for (int a = 0; a < kAttrs; ++a)
      v[a] = ok ? __ldg(mat + a * tl.e_pad + e) : 0.0f;
    return;
  }
  uint32_t w[5] = {0u, 0u, 0u, 0u, 0u};
  if (ok) {
#pragma unroll
    for (int r = 0; r < 5; ++r)
      w[r] = __float_as_uint(__ldg(mat + r * tl.e_pad + e));
  }
  v[0] = __fadd_rn(__fsub_rn(__fmul_rn(static_cast<float>(w[0] >> 16),
                                       kMeansStep), kMeansBias), ox);
  v[1] = __fadd_rn(__fsub_rn(__fmul_rn(static_cast<float>(w[0] & 0xFFFFu),
                                       kMeansStep), kMeansBias), oy);
#pragma unroll
  for (int r = 1; r < 5; ++r) {
    v[2 * r] = __uint_as_float(w[r] & 0xFFFF0000u);
    v[2 * r + 1] = __uint_as_float(w[r] << 16);
  }
}

// One chunk of the forward, packed for two 16-byte and one 8-byte shared
// load per pair, with each entry's strip_reach.
struct FwdChunk {
  float4 geo[kCH];      // mx my ca cb
  float4 opc[kCH];      // cc op r g
  float2 bd[kCH];       // b depth
  unsigned reach[kCH];  // 0 past the chunk's entries
};

__device__ __forceinline__ void put_entry(FwdChunk& ch, int j, int m,
                                          const float* v, float ox,
                                          float oy) {
  ch.geo[j] = make_float4(v[0], v[1], v[2], v[3]);
  ch.opc[j] = make_float4(v[4], v[5], v[6], v[7]);
  ch.bd[j] = make_float2(v[8], v[9]);
  ch.reach[j] = j < m ? strip_reach(v[0], v[1], v[2], v[3], v[4], v[5], ox,
                                    oy)
                      : 0u;
}

// Blocks of the forward an SM should hold, which sets the registers a
// thread may keep (65,536 / (256 * blocks)): more tiles in flight hide the
// loads' latency. On an H100 (kernel_timing.py gs-fwd; PERF.md section 6)
// 8 blocks (32 registers, a few spilled) beat 6 and 4 at 1080p by 10-24%
// and lose 6% at 400x400, whose 625 tiles are fewer than the card holds.
constexpr int kFwdBlocksPerSm = 8;

// The forward: a 256-thread block per tile, a thread per pixel, chunks of
// kCH entries in two shared buffers. Chunk j is loaded (one lane per entry,
// into registers) by warp j % 8 after it walks chunk j - 2, and packed into
// the free buffer with its strip_reach before it walks chunk j - 1: the
// load has a whole chunk's walk to land, the registers are not held during
// a walk, a chunk costs one __syncthreads, and the work rotates over the
// warps. Each warp walks, in ascending order, only the chunk's entries whose
// bound reaches its two pixel rows: the others have alpha 0 at each of its
// pixels, where the walk would `continue`, so the composite and the saved
// transmittance keep their bits.
template <int L, bool kSave>
__global__ void __launch_bounds__(kP, kFwdBlocksPerSm)
gs_fwd_kernel(Tiles tl, float* __restrict__ out, float* __restrict__ tacc,
              int nc) {
  __shared__ FwdChunk buf[2];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const size_t seg = tile_start<L>(tl, t);
  const int n = min(max(tl.counts[t], 0), tl.k);
  float ox, oy, px, py;
  tile_origin<L>(tl, t, &ox, &oy);
  pixel(ox, oy, p, &px, &py);
  float trans = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, acc = 0.0f,
        dep = 0.0f;
  const int n_chunks = (n + kCH - 1) / kCH;
  float v[kAttrs];
  if (warp == 0 && n_chunks > 0) {
    load_entry<L>(tl, seg, lane, n, ox, oy, v);
    put_entry(buf[0], lane, n, v, ox, oy);
  }
  if (warp == 1 % kWarps && n_chunks > 1)
    load_entry<L>(tl, seg, kCH + lane, n, ox, oy, v);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();   // chunk c is packed; every warp is done with c - 1
    if (warp == (c + 1) % kWarps && c + 1 < n_chunks)
      put_entry(buf[(c + 1) & 1], lane, n - (c + 1) * kCH, v, ox, oy);
    if (kSave) tacc[(static_cast<size_t>(t) * nc + c) * kP + p] = trans;
    const FwdChunk& ch = buf[c & 1];
    const unsigned near = __ballot_sync(0xFFFFFFFFu,
                                        (ch.reach[lane] >> warp) & 1u);
    for (unsigned bits = near; bits != 0u; bits &= bits - 1u) {
      const int j = __ffs(bits) - 1;
      const float4 g4 = ch.geo[j];
      const float4 o4 = ch.opc[j];
      const float dx = __fsub_rn(px, g4.x);
      const float dy = __fsub_rn(py, g4.y);
      const float power = fminf(raw_power(g4.z, g4.w, o4.x, dx, dy), 0.0f);
      const float a_raw = __fmul_rn(o4.y, expf(power));
      if (!(a_raw > kAlphaMin)) continue;   // alpha 0: nothing changes
      const float2 b2 = ch.bd[j];
      const float alpha = fminf(a_raw, kAlphaMax);
      const float w = trans * alpha;
      cr += o4.z * w;
      cg += o4.w * w;
      cb += b2.x * w;
      acc += w;
      dep += b2.y * w;
      trans = trans * (1.0f - alpha);
    }
    if (warp == (c + 2) % kWarps && c + 2 < n_chunks)
      load_entry<L>(tl, seg, (c + 2) * kCH + lane, n, ox, oy, v);
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

// Quantities the entry pass sums per entry over pixels: the moments of
// dL/dpower in tile-centred pixel coordinates (1, x, y, xx, xy, yy), dL/dop,
// and w times each of dL/d(r, g, b, depth).
constexpr int kSums = 11;

// The backward's shared memory (dynamic: above the 48 KB static limit).
// 75,392 bytes, so three blocks share an SM.
struct BwdShared {
  // Per (pixel, entry) of the chunk, rows padded to 33 so that a warp's
  // lanes hit distinct banks whether they vary the pixel (pixel pass) or
  // the entry (entry pass). After the forward walk: (T before the entry,
  // e^power, negated where the raw power is > 0). After the backward walk:
  // (w = T alpha, negated where the raw power is > 0; dL/dop).
  float2 pair[kP][kCH + 1];
  float4 dout[kP];          // dL/d(r, g, b, depth) of each pixel
  unsigned live[kP];        // bit j: entry j's alpha passes 1/255 here
  float s[kAttrs][kCH];     // the staged chunk, as stage() writes it
  float4 geo[kCH];          // the same, packed: mx my ca cb
  float4 opc[kCH];          //                   cc op r g
  float2 bd[kCH];           //                   b depth
  unsigned reach[kCH];      // strip_reach of each entry
};
// The 8 warps' partial sums per (quantity, entry) reuse `pair` once every
// warp has finished reading it.
static_assert(sizeof(float) * kWarps * kSums * kCH <=
                  sizeof(float2) * kP * (kCH + 1),
              "partials must fit in pair");

// The stream backward reads the forward's saved transmittance; the slot
// backward (kSlots) first records it into `tacc` itself. Each chunk runs
// in two passes that need no shuffles and no atomics:
//   pixel pass (thread = pixel): walk the chunk forward from the saved
//     transmittance, keeping T and e^power per entry (one expf per pair),
//     then backward with the suffix S, leaving w and dL/dop per (pixel,
//     entry) in `pair`. Both walks visit only the entries whose bound
//     (strip_reach) reaches the warp's two pixel rows, a set the whole warp
//     shares: most (entry, pixel) pairs of a tile have alpha 0;
//   entry pass (lane = entry, warp = the 32 pixels it walked): each thread
//     sums over the warp's pixels in series the 11 quantities its entry's
//     10 gradients follow from. dL/dpower is taken through its moments in
//     pixel coordinates, so a pair costs 8 multiply-adds against constants
//     instead of recomputing dx, dy and 10 products: with p = pixel - centre
//     and c = mean - centre, dx = p_x - c_x and
//       sum d dx dx = M_xx - 2 c_x M_x + c_x^2 M_1, and so on.
//   The 8 warp partials are then added in a fixed order.
// Only __syncwarp separates the two passes: a warp's entry pass reads the
// pixels its own pixel pass wrote.
template <int L>
__global__ void __launch_bounds__(kP, 3)
gs_bwd_kernel(Tiles tl, float* __restrict__ tacc,
              const float* __restrict__ dout, float* __restrict__ dmat,
              int nc) {
  extern __shared__ float4 shared_raw[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(shared_raw);
  float (*s)[kCH] = sh.s;
  float (*part)[kSums][kCH] = reinterpret_cast<float (*)[kSums][kCH]>(
      &sh.pair[0][0]);
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
  sh.dout[p] = make_float4(d_r, d_g, d_b, d_dep);
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
      stage<L>(tl, seg, j0, m, s);
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
    stage<L>(tl, seg, j0, m, s);
    __syncthreads();
    if (p < kCH) {
      sh.geo[p] = make_float4(s[0][p], s[1][p], s[2][p], s[3][p]);
      sh.opc[p] = make_float4(s[4][p], s[5][p], s[6][p], s[7][p]);
      sh.bd[p] = make_float2(s[8][p], s[9][p]);
      sh.reach[p] = p < m ? strip_reach(s[0][p], s[1][p], s[2][p], s[3][p],
                                        s[4][p], s[5][p], ox, oy)
                          : 0u;
    }
    __syncthreads();
    // The entries that may reach this warp's pixels; the others have alpha
    // 0 at every one of them and change nothing.
    const unsigned near = __ballot_sync(0xFFFFFFFFu,
                                        (sh.reach[lane] >> warp) & 1u);
    // Pixel pass, forward from the chunk's saved starting transmittance:
    // T before each entry and e^power.
    float trans = tacc[(static_cast<size_t>(t) * nc + c) * kP + p];
    for (unsigned bits = near; bits != 0u; bits &= bits - 1u) {
      const int j = __ffs(bits) - 1;
      const float4 g4 = sh.geo[j];
      const float2 co = make_float2(sh.opc[j].x, sh.opc[j].y);
      const float dx = __fsub_rn(px, g4.x);
      const float dy = __fsub_rn(py, g4.y);
      const float pw = raw_power(g4.z, g4.w, co.x, dx, dy);
      const float ep = expf(fminf(pw, 0.0f));
      sh.pair[p][j] = make_float2(trans, pw > 0.0f ? -ep : ep);
      const float a_raw = __fmul_rn(co.y, ep);
      if (a_raw > kAlphaMin) trans = trans * (1.0f - fminf(a_raw, kAlphaMax));
    }
    // Pixel pass, backward: the pair's scalar terms.
    //   dL/dalpha = g T - S / (1 - alpha)  where 1/255 < a_raw < 0.99,
    //   dL/dop = dL/dalpha e^power,  dL/dpower = dL/dop op (0 where the raw
    //   power is > 0, the oracle's min(power, 0)).
    unsigned live = 0u;
    for (unsigned bits = near; bits != 0u;) {
      const int j = 31 - __clz(bits);
      bits ^= 1u << j;
      const float2 te = sh.pair[p][j];
      const float4 o4 = sh.opc[j];
      const float ep = fabsf(te.y);
      const float a_raw = __fmul_rn(o4.y, ep);
      float w = 0.0f, d_op = 0.0f;
      if (a_raw > kAlphaMin) {
        live |= 1u << j;
        const float2 bd = sh.bd[j];
        const float alpha = fminf(a_raw, kAlphaMax);
        w = te.x * alpha;
        const float g = d_r * o4.z + d_g * o4.w + d_b * bd.x + d_acc +
                        bd.y * d_dep;
        if (a_raw < kAlphaMax)
          d_op = (g * te.x - suffix * __frcp_rn(1.0f - alpha)) * ep;
        suffix += g * w;
      }
      sh.pair[p][j] = make_float2(copysignf(w, te.y), d_op);
    }
    sh.live[p] = live;
    __syncwarp();
    // Entry pass: lane j sums entry j's quantities over this warp's pixels,
    // two rows of 16 (pixel coordinates relative to the tile's centre).
    float sum[kSums];
#pragma unroll
    for (int a = 0; a < kSums; ++a) sum[a] = 0.0f;
    if ((near >> lane) & 1u) {
      const float op = sh.opc[lane].y;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 2 * warp + r;
        const float yc = static_cast<float>(row) - 7.5f;
        float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
#pragma unroll
        for (int x = 0; x < kTile; ++x) {
          const int q = row * kTile + x;
          if (sh.live[q] == 0u) continue;   // no entry passes at pixel q
          const float xc = static_cast<float>(x) - 7.5f;
          const float2 wd = sh.pair[q][lane];
          const float4 go = sh.dout[q];
          const float w = fabsf(wd.x);
          const float d_pow = signbit(wd.x) ? 0.0f : wd.y * op;
          r0 += d_pow;
          r1 += d_pow * xc;
          r2 += d_pow * (xc * xc);
          sum[6] += wd.y;
          sum[7] += w * go.x;
          sum[8] += w * go.y;
          sum[9] += w * go.z;
          sum[10] += w * go.w;
        }
        sum[0] += r0;
        sum[1] += r1;
        sum[2] += yc * r0;
        sum[3] += r2;
        sum[4] += yc * r1;
        sum[5] += (yc * yc) * r0;
      }
    }
    __syncthreads();   // every warp is done with `pair`: reuse it
#pragma unroll
    for (int a = 0; a < kSums; ++a) part[warp][a][lane] = sum[a];
    __syncthreads();
    for (int i = p; i < kSums * kCH; i += kP) {
      const int a = i / kCH;
      const int j = i - a * kCH;
      float total = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) total += part[wi][a][j];
      part[0][a][j] = total;
    }
    __syncthreads();
    if (p < m) {
      const float4 g4 = sh.geo[p];
      const float cc = sh.opc[p].x;
      const float m1 = part[0][0][p], mx = part[0][1][p], my = part[0][2][p];
      const float mxx = part[0][3][p], mxy = part[0][4][p];
      const float myy = part[0][5][p];
      // The mean relative to the tile's centre.
      const float cx = g4.x - (ox + 8.0f);
      const float cy = g4.y - (oy + 8.0f);
      const float sdx = mx - cx * m1;                      // sum d dx
      const float sdy = my - cy * m1;                      // sum d dy
      const float sdxx = mxx - 2.0f * cx * mx + cx * cx * m1;
      const float sdxy = mxy - cx * my - cy * mx + cx * cy * m1;
      const float sdyy = myy - 2.0f * cy * my + cy * cy * m1;
      float grad[kAttrs];
      grad[0] = g4.z * sdx + g4.w * sdy;
      grad[1] = cc * sdy + g4.w * sdx;
      grad[2] = -0.5f * sdxx;
      grad[3] = -sdxy;
      grad[4] = -0.5f * sdyy;
#pragma unroll
      for (int a = 5; a < kAttrs; ++a) grad[a] = part[0][a + 1][p];
      const size_t e = seg + j0 + p;
      if (L == kSlots || e < tl.e_pad) {
#pragma unroll
        for (int a = 0; a < kAttrs; ++a)
          dmat[L == kSlots ? e * kAttrs + a : a * tl.e_pad + e] = grad[a];
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
  // Per launch, not once: the attributes belong to the current device.
  err = cudaFuncSetAttribute(gs_bwd_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(BwdShared)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gs_bwd_kernel<L>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  gs_bwd_kernel<L><<<num_tiles, kP, sizeof(BwdShared), s>>>(
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
