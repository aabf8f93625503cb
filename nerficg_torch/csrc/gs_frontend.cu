// 3D Gaussian Splatting frontend: each Gaussian's activations, 3D
// covariance, EWA projection and view-dependent SH colour, read from the
// raw parameters in one pass, and the backward of all of it in one more.
//
// Replaces no TPU kernel. The JAX package's frontend
// (nerficg_tpu/methods/gaussian_splatting/renderer.py `frontend`,
// nerficg_tpu/ops/gaussian.py, nerficg_tpu/ops/encoding.py `eval_sh`) is
// jnp code that XLA fuses into a few loops. Eager PyTorch ran it as ~170
// launches forward and ~300 in autograd's backward, each moving a
// 12-112 MB intermediate through device memory, the 3x3 products on
// cuBLAS batched GEMMs whose 32x32 tiles are nearly all padding: the
// largest layer of a 3DGS step or frame on the card. This pair computes
// ops/gaussian.py `gs_frontend_plain` and its gradient.
//
// What bounds it on an H100: memory. About 420 f32 operations a Gaussian
// forward and 840 backward, against 236 B of raw parameters (16 SH
// coefficients) read by each direction: under 4 operations a byte, where
// the card does 20. The forward writes 45 B a Gaussian; the backward reads
// 40 B of output gradients and writes 236 B of parameter gradients.
//
// Design:
//   * one thread per Gaussian. The forward keeps every intermediate in
//     registers. The backward recomputes the forward from the raw
//     parameters (the autograd node saves nothing but its inputs) and
//     writes every row of the six gradients, so they need no zeroing.
//   * a features_rest row is 180 B at 16 coefficients: 45 loads a thread
//     at a 180 B stride touch 32 lines each. A block stages its
//     Gaussians' rows in shared memory with 16-byte loads of consecutive
//     addresses (rows at an odd stride, so the threads' reads hit distinct
//     banks), and the backward writes that gradient back the same way.
//   * the forward rounds as the plain version does on the card: _rn
//     intrinsics in its order of operations (nvcc may not contract them
//     into FMAs), each small matrix product summed as cuBLAS's f32 GEMM
//     sums it (FMAs over k from 0, found on the card against the plain
//     version), and the reductions in the order of PyTorch's reduce
//     kernels. Serving sorts on the top 19 bits of the f32 depth, so one
//     ulp there can move a Gaussian across a key: depths and means2d are
//     the plain version's bits.
//   * the backward follows autograd's conventions: a clamp passes the
//     gradient where min <= x <= max; radii, visible and the ceil have
//     none; a missing output gradient counts as zero.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;     // Gaussians a block

// Real SH constants (ops/encoding.py), rounded to f32 as PyTorch rounds
// a Python float scalar.
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

struct Camera {
  float fx, fy, cx, cy;   // focal lengths and principal point, pixels
  float lim_x, lim_y;     // the tan-fov clamp, 1.3 * (0.5 * W / fx)
  float width, height;
  float near, low_pass;
};

struct Params {
  const float* positions;      // (N, 3)
  const float* scales;         // (N, 3) log scales
  const float* rotations;      // (N, 4) wxyz, unnormalised
  const float* opacities;      // (N, 1) logits
  const float* features_dc;    // (N, 1, 3)
  const float* features_rest;  // (N, K - 1, 3)
  const float* w2c;            // (4, 4) row-major
  const float* cam_pos;        // (3,)
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  // cuBLAS's f32 GEMM at k = 3: the accumulator starts at zero and takes
  // one FMA per k, in order.
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Shared-memory staging of a block's (rows, kWidth) slice of a row-major
// f32 array, at row stride kStride.
template <int kWidth, int kStride>
__device__ __forceinline__ int staged(int e) {
  return (e / kWidth) * kStride + e % kWidth;
}

template <int kWidth, int kStride>
__device__ void stage_in(float* sm, const float* src, int rows) {
  const int total = rows * kWidth;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    done = total / 4 * 4;
    for (int v = threadIdx.x; v < total / 4; v += kThreads) {
      const float4 q = __ldg(src4 + v);
      const int e = 4 * v;
      sm[staged<kWidth, kStride>(e)] = q.x;
      sm[staged<kWidth, kStride>(e + 1)] = q.y;
      sm[staged<kWidth, kStride>(e + 2)] = q.z;
      sm[staged<kWidth, kStride>(e + 3)] = q.w;
    }
  }
  for (int e = done + threadIdx.x; e < total; e += kThreads)
    sm[staged<kWidth, kStride>(e)] = __ldg(src + e);
}

template <int kWidth, int kStride>
__device__ void stage_out(float* dst, const float* sm, int rows) {
  const int total = rows * kWidth;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    done = total / 4 * 4;
    for (int v = threadIdx.x; v < total / 4; v += kThreads) {
      const int e = 4 * v;
      dst4[v] = make_float4(sm[staged<kWidth, kStride>(e)],
                            sm[staged<kWidth, kStride>(e + 1)],
                            sm[staged<kWidth, kStride>(e + 2)],
                            sm[staged<kWidth, kStride>(e + 3)]);
    }
  }
  for (int e = done + threadIdx.x; e < total; e += kThreads)
    dst[e] = sm[staged<kWidth, kStride>(e)];
}

// K stored SH coefficients a Gaussian (1, 4, 9 or 16).
template <int K>
struct Layout {
  static constexpr int kWidth = 3 * (K - 1);   // floats of a rest row
  static constexpr int kStride = kWidth % 2 ? kWidth : kWidth + 1;
  static constexpr int kShared = K > 1 ? kThreads * kStride : 1;
};

// The SH basis of a unit direction (ops/encoding.py sh_encode, op for op).
template <int K>
__device__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if constexpr (K > 1) {
    b[1] = mul(-kC1, y);
    b[2] = mul(kC1, z);
    b[3] = mul(-kC1, x);
  }
  if constexpr (K > 4) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(kC20, xy);
    b[5] = mul(kC21, yz);
    b[6] = mul(kC22, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul(kC23, xz);
    b[8] = mul(kC24, sub(xx, yy));
    if constexpr (K > 9) {
      b[9] = mul(mul(kC30, y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(kC31, xy), z);
      b[11] = mul(mul(kC32, y), sub(sub(mul(4.0f, zz), xx), yy));
      b[12] = mul(mul(kC33, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(kC34, x), sub(sub(mul(4.0f, zz), xx), yy));
      b[14] = mul(mul(kC35, z), sub(xx, yy));
      b[15] = mul(mul(kC36, x), sub(xx, mul(3.0f, yy)));
    }
  }
}

// Everything the forward computes for one Gaussian, which the backward
// recomputes.
template <int K>
struct Gaussian {
  float p[3];                   // position
  float s_raw[3], s[3];         // log scales, scales
  float q_raw[4], ss, r, q[4];  // raw quaternion, |q|^2, its rsqrt, unit q
  float R[3][3], M[3][3], S[3][3];  // rotation, R diag(s), covariance
  float W[3][3];                // the camera's rotation
  float x, y, z, zs, u, v;      // camera space, z clamped, x / zs, y / zs
  float tx, ty;                 // the tan-fov clamped x and y
  float J00, J02, J11, J12;     // the projection's Jacobian
  float T[2][3], A[2][3];       // J W, J W S
  float a, b, c, det, ds;       // 2D covariance (+ low pass), det, clamped
  float px, py;                 // means2d
  float dir[3], n, nc, d[3];    // view direction, its norm, clamped, unit
  float basis[K];
  float col[3];                 // the SH sum, before + 0.5 and the clamp
  float op_raw, op;
};

// `rest` is the Gaussian's staged features_rest row.
template <int K>
__device__ void evaluate(const Params& in, const Camera& cam, int64_t i,
                         const float* rest, int coeffs, Gaussian<K>& g) {
  for (int k = 0; k < 3; ++k) {
    g.p[k] = __ldg(in.positions + 3 * i + k);
    g.s_raw[k] = __ldg(in.scales + 3 * i + k);
    g.s[k] = expf(clampf(g.s_raw[k], -15.0f, 10.0f));
  }
  const float4 q4 = __ldg(reinterpret_cast<const float4*>(in.rotations) + i);
  g.q_raw[0] = q4.x; g.q_raw[1] = q4.y; g.q_raw[2] = q4.z; g.q_raw[3] = q4.w;
  // (q * q).sum(-1) as PyTorch's reduce adds the four squares on the card.
  g.ss = add(add(mul(q4.x, q4.x), mul(q4.z, q4.z)),
             add(mul(q4.y, q4.y), mul(q4.w, q4.w)));
  g.r = rsqrtf(fmaxf(g.ss, 1e-12f));
  for (int k = 0; k < 4; ++k) g.q[k] = mul(g.q_raw[k], g.r);
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  g.R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  g.R[0][1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
  g.R[0][2] = mul(2.0f, add(mul(x, z), mul(w, y)));
  g.R[1][0] = mul(2.0f, add(mul(x, y), mul(w, z)));
  g.R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  g.R[1][2] = mul(2.0f, sub(mul(y, z), mul(w, x)));
  g.R[2][0] = mul(2.0f, sub(mul(x, z), mul(w, y)));
  g.R[2][1] = mul(2.0f, add(mul(y, z), mul(w, x)));
  g.R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) g.M[a][b] = mul(g.R[a][b], g.s[b]);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      g.S[a][b] = fma3(g.M[a][0], g.M[b][0], g.M[a][1], g.M[b][1],
                       g.M[a][2], g.M[b][2]);

  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) g.W[a][b] = __ldg(in.w2c + 4 * a + b);
  float cam_xyz[3];
  for (int a = 0; a < 3; ++a)
    cam_xyz[a] = add(fma3(g.p[0], g.W[a][0], g.p[1], g.W[a][1], g.p[2],
                          g.W[a][2]),
                     __ldg(in.w2c + 4 * a + 3));
  g.x = cam_xyz[0]; g.y = cam_xyz[1]; g.z = cam_xyz[2];
  g.zs = fmaxf(g.z, cam.near);
  g.u = dvd(g.x, g.zs);
  g.v = dvd(g.y, g.zs);
  g.px = add(mul(g.u, cam.fx), cam.cx);
  g.py = add(mul(g.v, cam.fy), cam.cy);
  g.tx = mul(clampf(g.u, -cam.lim_x, cam.lim_x), g.zs);
  g.ty = mul(clampf(g.v, -cam.lim_y, cam.lim_y), g.zs);
  // focal / zs is PyTorch's reciprocal(zs) * focal.
  const float rz = dvd(1.0f, g.zs), zz = mul(g.zs, g.zs);
  g.J00 = mul(rz, cam.fx);
  g.J11 = mul(rz, cam.fy);
  g.J02 = dvd(mul(g.tx, -cam.fx), zz);
  g.J12 = dvd(mul(g.ty, -cam.fy), zz);
  // T = J W with J's zeros (J01 = J10 = 0) taken by the GEMM's FMAs.
  for (int b = 0; b < 3; ++b) {
    g.T[0][b] = fma3(g.J00, g.W[0][b], 0.0f, g.W[1][b], g.J02, g.W[2][b]);
    g.T[1][b] = fma3(0.0f, g.W[0][b], g.J11, g.W[1][b], g.J12, g.W[2][b]);
  }
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 3; ++b)
      g.A[a][b] = fma3(g.T[a][0], g.S[0][b], g.T[a][1], g.S[1][b], g.T[a][2],
                       g.S[2][b]);
  const float c00 = fma3(g.A[0][0], g.T[0][0], g.A[0][1], g.T[0][1],
                         g.A[0][2], g.T[0][2]);
  const float c01 = fma3(g.A[0][0], g.T[1][0], g.A[0][1], g.T[1][1],
                         g.A[0][2], g.T[1][2]);
  const float c11 = fma3(g.A[1][0], g.T[1][0], g.A[1][1], g.T[1][1],
                         g.A[1][2], g.T[1][2]);
  g.a = add(c00, cam.low_pass);
  g.b = c01;
  g.c = add(c11, cam.low_pass);
  g.det = sub(mul(g.a, g.c), mul(g.b, g.b));
  g.ds = fmaxf(g.det, 1e-12f);

  // View direction and SH colour.
  for (int k = 0; k < 3; ++k) g.dir[k] = sub(g.p[k], __ldg(in.cam_pos + k));
  // torch.linalg.norm's reduce on the card: (x^2 + z^2) + y^2.
  g.n = __fsqrt_rn(add(add(mul(g.dir[0], g.dir[0]), mul(g.dir[2], g.dir[2])),
                       mul(g.dir[1], g.dir[1])));
  g.nc = fmaxf(g.n, 1e-8f);
  for (int k = 0; k < 3; ++k) g.d[k] = dvd(g.dir[k], g.nc);
  sh_basis<K>(g.d[0], g.d[1], g.d[2], g.basis);
  // The colour's sum over the coefficients as cuBLAS's batched gemv takes
  // it at a scene's batch (found on the card at 16,384 and 3,112,960
  // Gaussians): an FMA chain over each half, then the two halves added.
  const int half = (coeffs + 1) / 2;
  for (int ch = 0; ch < 3; ++ch) {
    float lo = mul(__ldg(in.features_dc + 3 * i + ch), g.basis[0]), hi = 0.0f;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const float f = rest[3 * (k - 1) + ch];
      if (k < half) lo = __fmaf_rn(f, g.basis[k], lo);
      else if (k == half) hi = mul(f, g.basis[k]);
      else if (k < coeffs) hi = __fmaf_rn(f, g.basis[k], hi);
    }
    g.col[ch] = coeffs > 1 ? add(lo, hi) : lo;
  }
  g.op_raw = __ldg(in.opacities + i);
  g.op = dvd(1.0f, add(1.0f, expf(-g.op_raw)));
}

struct Outputs {
  float* means2d;     // (N, 2)
  float* depths;      // (N,)
  float* conics;      // (N, 3)
  float* radii;       // (N,)
  float* colors;      // (N, 3)
  float* opacities;   // (N,)
  uint8_t* visible;   // (N,) bool
};

template <int K>
__global__ void __launch_bounds__(kThreads)
    frontend_fwd_kernel(Params in, Outputs out, Camera cam, int n,
                        int coeffs) {
  using L = Layout<K>;
  __shared__ float rest_sm[L::kShared];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows =
      static_cast<int>(n - first < kThreads ? n - first : kThreads);
  if constexpr (K > 1) {
    stage_in<L::kWidth, L::kStride>(rest_sm,
                                    in.features_rest + first * L::kWidth,
                                    rows);
    __syncthreads();
  }
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const int64_t i = first + threadIdx.x;
  Gaussian<K> g;
  evaluate<K>(in, cam, i, rest_sm + threadIdx.x * L::kStride, coeffs, g);

  const float conic0 = dvd(g.c, g.ds);
  const float conic1 = dvd(-g.b, g.ds);
  const float conic2 = dvd(g.a, g.ds);
  const float mid = mul(0.5f, add(g.a, g.c));
  const float eig1 =
      add(mid, __fsqrt_rn(fmaxf(sub(mul(mid, mid), g.det), 0.1f)));
  const float radius = ceilf(mul(3.0f, __fsqrt_rn(fmaxf(eig1, 0.0f))));
  const bool visible = g.z > cam.near && g.det > 0.0f &&
                       add(g.px, radius) > 0.0f &&
                       sub(g.px, radius) < cam.width &&
                       add(g.py, radius) > 0.0f &&
                       sub(g.py, radius) < cam.height;

  reinterpret_cast<float2*>(out.means2d)[i] = make_float2(g.px, g.py);
  out.depths[i] = g.z;
  out.conics[3 * i] = conic0;
  out.conics[3 * i + 1] = conic1;
  out.conics[3 * i + 2] = conic2;
  out.radii[i] = visible ? radius : 0.0f;
  for (int ch = 0; ch < 3; ++ch)
    out.colors[3 * i + ch] = fmaxf(add(g.col[ch], 0.5f), 0.0f);
  out.opacities[i] = g.op;
  out.visible[i] = visible;
}

struct OutputGrads {     // each may be null: a zero gradient
  const float* means2d;
  const float* depths;
  const float* conics;
  const float* colors;
  const float* opacities;
};

struct ParamGrads {
  float* positions;
  float* scales;
  float* rotations;
  float* opacities;
  float* features_dc;
  float* features_rest;
};

__device__ __forceinline__ float grad_at(const float* g, int64_t idx) {
  return g ? __ldg(g + idx) : 0.0f;
}

// d(sum_k basis_k * gb_k) / d direction, for the first `coeffs` terms.
template <int K>
__device__ void sh_basis_grad(float x, float y, float z, const float* gb,
                              int coeffs, float* gd) {
  gd[0] = gd[1] = gd[2] = 0.0f;
  if constexpr (K > 1) {
    if (coeffs <= 1) return;
    gd[0] += -kC1 * gb[3];
    gd[1] += -kC1 * gb[1];
    gd[2] += kC1 * gb[2];
  }
  if constexpr (K > 4) {
    if (coeffs <= 4) return;
    gd[0] += kC20 * y * gb[4] + kC22 * (-2.0f * x) * gb[6] +
             kC23 * z * gb[7] + kC24 * (2.0f * x) * gb[8];
    gd[1] += kC20 * x * gb[4] + kC21 * z * gb[5] +
             kC22 * (-2.0f * y) * gb[6] + kC24 * (-2.0f * y) * gb[8];
    gd[2] += kC21 * y * gb[5] + kC22 * (4.0f * z) * gb[6] +
             kC23 * x * gb[7];
  }
  if constexpr (K > 9) {
    if (coeffs <= 9) return;
    const float xx = x * x, yy = y * y, zz = z * z;
    gd[0] += kC30 * (6.0f * x * y) * gb[9] + kC31 * (y * z) * gb[10] +
             kC32 * (-2.0f * x * y) * gb[11] +
             kC33 * (-6.0f * x * z) * gb[12] +
             kC34 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
             kC35 * (2.0f * x * z) * gb[14] +
             kC36 * (3.0f * xx - 3.0f * yy) * gb[15];
    gd[1] += kC30 * (3.0f * xx - 3.0f * yy) * gb[9] +
             kC31 * (x * z) * gb[10] +
             kC32 * (4.0f * zz - xx - 3.0f * yy) * gb[11] +
             kC33 * (-6.0f * y * z) * gb[12] +
             kC34 * (-2.0f * x * y) * gb[13] +
             kC35 * (-2.0f * y * z) * gb[14] +
             kC36 * (-6.0f * x * y) * gb[15];
    gd[2] += kC31 * (x * y) * gb[10] + kC32 * (8.0f * y * z) * gb[11] +
             kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] +
             kC34 * (8.0f * x * z) * gb[13] + kC35 * (xx - yy) * gb[14];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    frontend_bwd_kernel(Params in, OutputGrads go, ParamGrads gp, Camera cam,
                        int n, int coeffs) {
  using L = Layout<K>;
  __shared__ float rest_sm[L::kShared];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows =
      static_cast<int>(n - first < kThreads ? n - first : kThreads);
  if constexpr (K > 1) {
    stage_in<L::kWidth, L::kStride>(rest_sm,
                                    in.features_rest + first * L::kWidth,
                                    rows);
    __syncthreads();
  }
  const bool live = static_cast<int>(threadIdx.x) < rows;
  const int64_t i = first + threadIdx.x;
  float* rest = rest_sm + threadIdx.x * L::kStride;
  if (live) {
    Gaussian<K> g;
    evaluate<K>(in, cam, i, rest, coeffs, g);
    const float gpx = grad_at(go.means2d, 2 * i);
    const float gpy = grad_at(go.means2d, 2 * i + 1);
    const float gdepth = grad_at(go.depths, i);
    const float gca = grad_at(go.conics, 3 * i);
    const float gcb = grad_at(go.conics, 3 * i + 1);
    const float gcc = grad_at(go.conics, 3 * i + 2);
    const float gop = grad_at(go.opacities, i);

    gp.opacities[i] = gop * (1.0f - g.op) * g.op;

    // Colour: clamp(col + 0.5, min=0) passes where col + 0.5 >= 0.
    float gcol[3];
    for (int ch = 0; ch < 3; ++ch)
      gcol[ch] = add(g.col[ch], 0.5f) >= 0.0f
                     ? grad_at(go.colors, 3 * i + ch) : 0.0f;
    float gbasis[K];
    for (int ch = 0; ch < 3; ++ch)
      gp.features_dc[3 * i + ch] = g.basis[0] * gcol[ch];
    gbasis[0] = 0.0f;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const bool on = k < coeffs;
      float acc = 0.0f;
      for (int ch = 0; ch < 3; ++ch) {
        float* coeff = rest + 3 * (k - 1) + ch;
        acc += on ? *coeff * gcol[ch] : 0.0f;
        *coeff = on ? g.basis[k] * gcol[ch] : 0.0f;   // d features_rest
      }
      gbasis[k] = acc;
    }
    float gd[3];
    sh_basis_grad<K>(g.d[0], g.d[1], g.d[2], gbasis, coeffs, gd);
    // d = dir / max(|dir|, 1e-8); |dir|'s gradient is dir / |dir|.
    const float gdot = gd[0] * g.dir[0] + gd[1] * g.dir[1] + gd[2] * g.dir[2];
    const float gn = g.n >= 1e-8f ? -gdot / (g.nc * g.nc) / g.n : 0.0f;
    float gpos[3];
    for (int k = 0; k < 3; ++k) gpos[k] = gd[k] / g.nc + gn * g.dir[k];

    // Conic (c, -b, a) / ds, ds = max(det, 1e-12), det = a c - b^2.
    const float ids = 1.0f / g.ds;
    float ga = gcc * ids, gb = -gcb * ids, gc = gca * ids;
    const float gds = (-gca * g.c + gcb * g.b - gcc * g.a) * ids * ids;
    const float gdet = g.det >= 1e-12f ? gds : 0.0f;
    ga += gdet * g.c;
    gc += gdet * g.a;
    gb += -2.0f * g.b * gdet;
    // C2 = T S T^T with C2's gradient [[ga, gb], [0, gc]]; its symmetric
    // part G = [[2 ga, gb], [gb, 2 gc]] gives dT = G T S = G A and
    // dS (symmetrised) = T^T G T.
    const float G00 = 2.0f * ga, G01 = gb, G11 = 2.0f * gc;
    float dT[2][3];
    for (int b = 0; b < 3; ++b) {
      dT[0][b] = G00 * g.A[0][b] + G01 * g.A[1][b];
      dT[1][b] = G01 * g.A[0][b] + G11 * g.A[1][b];
    }
    float P[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        P[a][b] = g.T[0][a] * (G00 * g.T[0][b] + G01 * g.T[1][b]) +
                  g.T[1][a] * (G01 * g.T[0][b] + G11 * g.T[1][b]);
    // Symmetric to the bit, as autograd's dS + dS^T is: an isotropic
    // Gaussian's rotation gradient is then exactly zero, as autograd's.
    for (int a = 0; a < 3; ++a)
      for (int b = a + 1; b < 3; ++b)
        P[a][b] = P[b][a] = 0.5f * (P[a][b] + P[b][a]);
    // dJ = dT W^T (the entries that are not constant zeros).
    const float dJ00 = dT[0][0] * g.W[0][0] + dT[0][1] * g.W[0][1] +
                       dT[0][2] * g.W[0][2];
    const float dJ02 = dT[0][0] * g.W[2][0] + dT[0][1] * g.W[2][1] +
                       dT[0][2] * g.W[2][2];
    const float dJ11 = dT[1][0] * g.W[1][0] + dT[1][1] * g.W[1][1] +
                       dT[1][2] * g.W[1][2];
    const float dJ12 = dT[1][0] * g.W[2][0] + dT[1][1] * g.W[2][1] +
                       dT[1][2] * g.W[2][2];
    const float izs = 1.0f / g.zs, izs2 = izs * izs;
    float gzs = -(dJ00 * cam.fx + dJ11 * cam.fy) * izs2 +
                2.0f * (dJ02 * cam.fx * g.tx + dJ12 * cam.fy * g.ty) * izs2 *
                    izs;
    const float gtx = -dJ02 * cam.fx * izs2, gty = -dJ12 * cam.fy * izs2;
    const float ucl = clampf(g.u, -cam.lim_x, cam.lim_x);
    const float vcl = clampf(g.v, -cam.lim_y, cam.lim_y);
    float gu = gpx * cam.fx, gv = gpy * cam.fy;
    if (g.u >= -cam.lim_x && g.u <= cam.lim_x) gu += gtx * g.zs;
    if (g.v >= -cam.lim_y && g.v <= cam.lim_y) gv += gty * g.zs;
    gzs += gtx * ucl + gty * vcl - (gu * g.x + gv * g.y) * izs2;
    const float gcam[3] = {gu * izs, gv * izs,
                           gdepth + (g.z >= cam.near ? gzs : 0.0f)};
    for (int k = 0; k < 3; ++k)
      gp.positions[3 * i + k] = gpos[k] + g.W[0][k] * gcam[0] +
                                g.W[1][k] * gcam[1] + g.W[2][k] * gcam[2];

    // M = R diag(s), S = M M^T: dM = P M, dR = dM diag(s).
    float dR[3][3], gs[3] = {0.0f, 0.0f, 0.0f};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        const float dM = P[a][0] * g.M[0][b] + P[a][1] * g.M[1][b] +
                         P[a][2] * g.M[2][b];
        dR[a][b] = dM * g.s[b];
        gs[b] += dM * g.R[a][b];
      }
    for (int k = 0; k < 3; ++k)
      gp.scales[3 * i + k] =
          g.s_raw[k] >= -15.0f && g.s_raw[k] <= 10.0f ? gs[k] * g.s[k] : 0.0f;
    // The rotation's gradient in the unit quaternion (w, x, y, z) ...
    const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
    const float dq[4] = {
        2.0f * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] -
                y * dR[2][0] + x * dR[2][1]),
        2.0f * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] -
                2.0f * x * dR[1][1] - w * dR[1][2] + z * dR[2][0] +
                w * dR[2][1] - 2.0f * x * dR[2][2]),
        2.0f * (-2.0f * y * dR[0][0] + x * dR[0][1] + w * dR[0][2] +
                x * dR[1][0] + z * dR[1][2] - w * dR[2][0] + z * dR[2][1] -
                2.0f * y * dR[2][2]),
        2.0f * (-2.0f * z * dR[0][0] - w * dR[0][1] + x * dR[0][2] +
                w * dR[1][0] - 2.0f * z * dR[1][1] + y * dR[1][2] +
                x * dR[2][0] + y * dR[2][1])};
    // ... then through q = q_raw * rsqrt(max(|q_raw|^2, 1e-12)).
    const float qdot = dq[0] * g.q_raw[0] + dq[1] * g.q_raw[1] +
                       dq[2] * g.q_raw[2] + dq[3] * g.q_raw[3];
    const float gr = g.ss >= 1e-12f ? g.r * g.r * g.r * qdot : 0.0f;
    reinterpret_cast<float4*>(gp.rotations)[i] =
        make_float4(g.r * dq[0] - gr * g.q_raw[0],
                    g.r * dq[1] - gr * g.q_raw[1],
                    g.r * dq[2] - gr * g.q_raw[2],
                    g.r * dq[3] - gr * g.q_raw[3]);
  }
  if constexpr (K > 1) {
    __syncthreads();
    stage_out<L::kWidth, L::kStride>(gp.features_rest + first * L::kWidth,
                                     rest_sm, rows);
  }
}

template <int K>
int launch_fwd(const Params& in, const Outputs& out, const Camera& cam,
               int n, int coeffs, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  frontend_fwd_kernel<K><<<blocks, kThreads, 0, stream>>>(in, out, cam, n,
                                                          coeffs);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_bwd(const Params& in, const OutputGrads& go, const ParamGrads& gp,
               const Camera& cam, int n, int coeffs, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  frontend_bwd_kernel<K><<<blocks, kThreads, 0, stream>>>(in, go, gp, cam, n,
                                                          coeffs);
  return static_cast<int>(cudaGetLastError());
}

Params params_of(const void* positions, const void* scales,
                 const void* rotations, const void* opacities,
                 const void* features_dc, const void* features_rest,
                 const void* w2c, const void* cam_pos) {
  return {static_cast<const float*>(positions),
          static_cast<const float*>(scales),
          static_cast<const float*>(rotations),
          static_cast<const float*>(opacities),
          static_cast<const float*>(features_dc),
          static_cast<const float*>(features_rest),
          static_cast<const float*>(w2c), static_cast<const float*>(cam_pos)};
}

Camera camera_of(const float* c) {
  return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9]};
}

}  // namespace

// Parameters as the model holds them (f32, contiguous); w2c (4, 4) and
// cam_pos (3,) on the device; camera: the 10 floats of `Camera` on the
// host; stored_coeffs K in {1, 4, 9, 16}; coeffs = sh_degree^2 <= K, the
// coefficients the colour sums. Outputs: means2d (N, 2), depths (N,),
// conics (N, 3), radii (N,), colors (N, 3), opacities (N,) f32, visible
// (N,) bool.
extern "C" int nerficg_gs_frontend_fwd(
    const void* positions, const void* scales, const void* rotations,
    const void* opacities, const void* features_dc, const void* features_rest,
    const void* w2c, const void* cam_pos, const float* camera, void* means2d,
    void* depths, void* conics, void* radii, void* colors,
    void* opacities_out, void* visible, int n, int stored_coeffs, int coeffs,
    void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Params in = params_of(positions, scales, rotations, opacities,
                              features_dc, features_rest, w2c, cam_pos);
  const Outputs out = {static_cast<float*>(means2d),
                       static_cast<float*>(depths),
                       static_cast<float*>(conics),
                       static_cast<float*>(radii),
                       static_cast<float*>(colors),
                       static_cast<float*>(opacities_out),
                       static_cast<uint8_t*>(visible)};
  const Camera cam = camera_of(camera);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stored_coeffs) {
    case 1: return launch_fwd<1>(in, out, cam, n, coeffs, s);
    case 4: return launch_fwd<4>(in, out, cam, n, coeffs, s);
    case 9: return launch_fwd<9>(in, out, cam, n, coeffs, s);
    case 16: return launch_fwd<16>(in, out, cam, n, coeffs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward's inputs; the output gradients (each null for zero):
// d means2d (N, 2), d depths (N,), d conics (N, 3), d colors (N, 3),
// d opacities (N,); the parameters' gradients in their shapes, every row
// written.
extern "C" int nerficg_gs_frontend_bwd(
    const void* positions, const void* scales, const void* rotations,
    const void* opacities, const void* features_dc, const void* features_rest,
    const void* w2c, const void* cam_pos, const float* camera,
    const void* g_means2d, const void* g_depths, const void* g_conics,
    const void* g_colors, const void* g_opacities, void* d_positions,
    void* d_scales, void* d_rotations, void* d_opacities,
    void* d_features_dc, void* d_features_rest, int n, int stored_coeffs,
    int coeffs, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Params in = params_of(positions, scales, rotations, opacities,
                              features_dc, features_rest, w2c, cam_pos);
  const OutputGrads go = {static_cast<const float*>(g_means2d),
                          static_cast<const float*>(g_depths),
                          static_cast<const float*>(g_conics),
                          static_cast<const float*>(g_colors),
                          static_cast<const float*>(g_opacities)};
  const ParamGrads gp = {static_cast<float*>(d_positions),
                         static_cast<float*>(d_scales),
                         static_cast<float*>(d_rotations),
                         static_cast<float*>(d_opacities),
                         static_cast<float*>(d_features_dc),
                         static_cast<float*>(d_features_rest)};
  const Camera cam = camera_of(camera);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stored_coeffs) {
    case 1: return launch_bwd<1>(in, go, gp, cam, n, coeffs, s);
    case 4: return launch_bwd<4>(in, go, gp, cam, n, coeffs, s);
    case 9: return launch_bwd<9>(in, go, gp, cam, n, coeffs, s);
    case 16: return launch_bwd<16>(in, go, gp, cam, n, coeffs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
