// Device helpers shared by the hash-encode kernels (hash_window.cu,
// hash_cell.cu, hash_xbar.cu) and the segment scatter (seg_ops.cu): the
// Instant-NGP hash primes, the brick morton code, the bf16 table read, the
// window wrap, the staging of a window as bf16x2 words and the trilinear
// sum of the windowed forwards, the counter hash with the
// stochastic-corner choice, and the warp's run sum before a scatter-add.
//
// Every float operation that decides an address or a weight uses the _rn
// intrinsics, so nvcc cannot contract it into an FMA: the plain PyTorch
// versions must reach the same f32 bits (a one-ulp difference moves a corner
// across a row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nerficg {

constexpr int kLanes = 128;
constexpr int kBrickBitsMax = 5;
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 805459861u;
constexpr uint32_t kGolden = 0x9E3779B9u;

// One coordinate's share of a morton code: its low kBrickBitsMax bits, bit
// i moved to 3i + shift.
__device__ __forceinline__ int morton_spread(int v, int shift) {
  int m = 0;
#pragma unroll
  for (int i = 0; i < kBrickBitsMax; ++i) {
    m |= ((v >> i) & 1) << (3 * i + shift);
  }
  return m;
}

// Generalized 3D morton code over <= kBrickBitsMax bits per dim (x at 3i+2).
__device__ __forceinline__ int morton3(int x, int y, int z) {
  return morton_spread(x, 2) | morton_spread(y, 1) | morton_spread(z, 0);
}

// The Instant-NGP spatial hash, wrapping modulo 2^32.
__device__ __forceinline__ uint32_t ngp_hash(int x, int y, int z) {
  return static_cast<uint32_t>(x) ^ (static_cast<uint32_t>(y) * kP1) ^
         (static_cast<uint32_t>(z) * kP2);
}

// The table is read rounded to bf16, as the TPU kernels' packed lanes are.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The two features of a table entry rounded to bf16 (bf16_round's bits),
// packed as one word: feature 0 low, feature 1 high.
__device__ __forceinline__ uint32_t bf16x2_word(float v0, float v1) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v0))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v1)))
          << 16);
}

// A bf16x2 word's two features as f32: bf16_round's values, bit for bit.
__device__ __forceinline__ float2 bf16x2_features(uint32_t word) {
  return make_float2(__uint_as_float(word << 16),
                     __uint_as_float(word & 0xFFFF0000u));
}

// Stage entries [0, count) of two feature planes p0, p1 of a window into
// shared memory s as bf16x2 words, with 16-byte loads and stores: p0, p1
// and s 16-byte aligned, count a multiple of 4. Called by the kThreads
// threads of the block; the caller synchronises after it.
template <int kThreads>
__device__ __forceinline__ void stage_window_bf16x2(
    const float* __restrict__ p0, const float* __restrict__ p1, int count,
    uint32_t* __restrict__ s) {
#pragma unroll 4
  for (int e = 4 * threadIdx.x; e < count; e += 4 * kThreads) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p0 + e));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p1 + e));
    *reinterpret_cast<uint4*>(s + e) =
        make_uint4(bf16x2_word(a.x, b.x), bf16x2_word(a.y, b.y),
                   bf16x2_word(a.z, b.z), bf16x2_word(a.w, b.w));
  }
}

// `_wrap_rel`: fold rel into [0, win) by floor(rel * (1/win)) in f32, then
// clamp (inv = __fdiv_rn(1, win)).
__device__ __forceinline__ int wrap_rel(int rel, int win, float inv) {
  const float q = floorf(__fmul_rn(static_cast<float>(rel), inv));
  const int r = rel - static_cast<int>(q) * win;
  return min(max(r, 0), win - 1);
}

// A sub-block's window at one level, rows [lo, lo + win), and the wrap's
// reciprocal: what every sample of the sub-block shares.
struct Window {
  int lo;
  int win;
  float inv;
};

__device__ __forceinline__ Window window_at(const int* __restrict__ lo,
                                            const int* __restrict__ win,
                                            int at) {
  Window w;
  w.lo = lo[at];
  w.win = win[at];
  w.inv = __fdiv_rn(1.0f, static_cast<float>(w.win));
  return w;
}

// `lo + _wrap_rel(row - lo, win)`: row folded into the window.
__device__ __forceinline__ int wrap_into(const Window& w, int row) {
  return w.lo + wrap_rel(row - w.lo, w.win, w.inv);
}

// Per-dimension base vertex and fractional offset of one sample at a level
// with res_m1 = res - 1 (f32).
__device__ __forceinline__ void level_coords(const float* __restrict__ pos,
                                             int i, float res_m1, int base[3],
                                             float frac[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float scaled = __fmul_rn(pos[3 * i + d], res_m1);
    const float f = floorf(scaled);
    frac[d] = __fsub_rn(scaled, f);
    base[d] = static_cast<int>(f);
  }
}

// Trilinear weight of corner (cx, cy, cz): ((wx * wy) * wz).
__device__ __forceinline__ float trilinear_weight(const float frac[3], int cx,
                                                  int cy, int cz) {
  const float wx = cx ? frac[0] : __fsub_rn(1.0f, frac[0]);
  const float wy = cy ? frac[1] : __fsub_rn(1.0f, frac[1]);
  const float wz = cz ? frac[2] : __fsub_rn(1.0f, frac[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The exact trilinear encode of one (sample, level): over the 8 corners in
// (i, j, k) order, acc_f += w_c * v_{c,f}, where read(c) returns corner
// c's two bf16-rounded features as a float2. The exact windowed forwards
// sum with it (#1's window-resident and global paths, #8's gather), so
// the sums are one expression in one order (nvcc contracts each step into
// the same FMA) and #1's two paths give the same bits.
template <typename Read>
__device__ __forceinline__ float2 trilinear_sum(const float frac[3],
                                                Read read) {
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = trilinear_weight(frac, (c >> 2) & 1, (c >> 1) & 1, c & 1);
    const float2 v = read(c);
    acc0 += w * v.x;
    acc1 += w * v.y;
  }
  return make_float2(acc0, acc1);
}

// Segmented warp sum over runs of equal keys in neighbouring lanes, for
// scatter-adds whose targets are shared atomics (compare-and-swap loops on
// sm_90) or global ones: when the warp's keys form at most max_runs runs,
// each run's V values are summed by a shuffle reduction into the run's
// first lane, and only that lane adds; otherwise every lane adds its own.
// Returns whether this lane adds (key < 0: nothing to add). Keys equal but
// not adjacent stay separate runs, so any order is summed correctly, and
// sorted keys (ray ids, morton-sorted samples' cells) fold the most. Called
// by all 32 lanes.
template <int V>
__device__ __forceinline__ bool warp_run_sum(int key, float (&v)[V],
                                             int max_runs) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  if (__popc(heads) > max_runs) return key >= 0;
  const unsigned after = heads & ~((2u << lane) - 1u);
  const int end = after != 0u ? __ffs(after) - 1 : 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = __shfl_down_sync(kFull, v[j], d);
      if (lane + d < end) v[j] = __fadd_rn(v[j], t);
    }
  }
  return key >= 0 && ((heads >> lane) & 1u) != 0u;
}

// Warp sum over all lanes of equal keys, adjacent or not (__match_any_sync
// groups them): each group's V values are summed into its lowest lane by a
// tree of shuffles, log2(group size) + 1 rounds, none when no two lanes
// share a key. Returns whether this lane adds (its group's lowest lane,
// key >= 0). Called by all 32 lanes.
template <int V>
__device__ __forceinline__ bool warp_peer_sum(int key, float (&v)[V]) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(kFull, key);
  int rank = __popc(group & ((1u << lane) - 1u));
  unsigned above = group & (0xFFFFFFFEu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next lane of the group
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = __shfl_sync(kFull, v[j], max(next - 1, 0));
      if (next != 0) v[j] = __fadd_rn(v[j], t);
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return key >= 0 && (group & ((1u << lane) - 1u)) == 0u;
}

// lowbias32 finalizer (nerficg_torch/ops/counter_rng.py mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The corner-bit word of (seed, level, sample, dim)
// (nerficg_torch/ops/counter_rng.py corner_bits).
__device__ __forceinline__ uint32_t corner_word(uint32_t seed, int lvl, int i,
                                                int d) {
  const uint32_t key =
      mix32(seed ^ (static_cast<uint32_t>(lvl * 3 + d + 1) * kGolden));
  return mix32(static_cast<uint32_t>(i) ^ key);
}

// `_stoch_corners` (nerficg_tpu/ops/hash_xbar.py :176) for one (sample,
// level): NC in {1, 2, 4} corner offsets and their weights. log2(NC) dims,
// those with the largest min(f, 1-f), are interpolated exactly; the others
// take corner ~ Bernoulli(f) from the counter-hash words. With `exact_out`,
// also which dims were interpolated (none for NC == 1).
template <int NC>
__device__ __forceinline__ void stoch_corners(const float frac[3],
                                              uint32_t seed, int lvl, int i,
                                              int (*off)[3], float* w,
                                              bool* exact_out = nullptr) {
  int draw[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const uint32_t bits = corner_word(seed, lvl, i, d);
    const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
    draw[d] = u < frac[d] ? 1 : 0;
  }
  if (NC == 1) {
    off[0][0] = draw[0];
    off[0][1] = draw[1];
    off[0][2] = draw[2];
    w[0] = 1.0f;
    if (exact_out != nullptr) {
      exact_out[0] = exact_out[1] = exact_out[2] = false;
    }
    return;
  }
  float m[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) m[d] = fminf(frac[d], __fsub_rn(1.0f, frac[d]));
  bool exact[3];
  if (NC == 2) {  // exact dim = argmax m
    const bool k0 = (m[0] >= m[1]) && (m[0] >= m[2]);
    const bool k1 = !k0 && (m[1] >= m[2]);
    exact[0] = k0;
    exact[1] = k1;
    exact[2] = !k0 && !k1;
  } else {  // NC == 4: stochastic dim = argmin m
    const bool s0 = (m[0] <= m[1]) && (m[0] <= m[2]);
    const bool s1 = !s0 && (m[1] <= m[2]);
    exact[0] = !s0;
    exact[1] = !s1;
    exact[2] = s0 || s1;
  }
  if (exact_out != nullptr) {
    exact_out[0] = exact[0];
    exact_out[1] = exact[1];
    exact_out[2] = exact[2];
  }
  const bool first[3] = {exact[0], exact[1] && !exact[0],
                         exact[2] && !exact[0] && !exact[1]};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int bit0 = c & 1;
    const int bit_n = NC == 2 ? bit0 : (c >> 1) & 1;
    float wc = 1.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int o = exact[d] ? (first[d] ? bit0 : bit_n) : draw[d];
      off[c][d] = o;
      if (exact[d]) {
        wc = __fmul_rn(wc, o ? frac[d] : __fsub_rn(1.0f, frac[d]));
      }
    }
    w[c] = wc;
  }
}

}  // namespace nerficg
