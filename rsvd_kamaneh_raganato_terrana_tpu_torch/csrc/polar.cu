// Kernel K2: Newton-Schulz polar orthonormalization of a tall-skinny f32
// panel, for Hopper (sm_90a).
//
// Replaces the TPU kernel in
//   rsvd_kamaneh_raganato_terrana_tpu/linalg/polar.py
//   polar_qr_fused / _polar_kernel.
// Given Y (m x l, row-major f32) and the schedule's per-step coefficients
// (a_k, b_k, c_k), k = 1..iters, it computes
//   G = Y^T Y,  alpha = max_i sum_j |G_ij| + 1e-30,  G~ = G (1 / alpha),
//   W_1 = a_1 I + b_1 G~ + c_1 G~^2,  H_1 = sym(W_1^T G~ W_1),
//   W_k = W_{k-1} (a_k I + b_k H + c_k H^2),  H_k = sym(W_k^T G~ W_k),
//   W_s = W_iters / sqrt(alpha),
// and returns Q = Y W_s (m x l) and R = W_s G (l x l, symmetric, not
// triangular); sym(H) = (H + H^T) / 2.  With `stage` >= 0 it stops early
// and writes one l x l intermediate to R instead (0: G, 1: G~, 2: W_1,
// 2 + k: H_k), and Q is not written.  This is the stage probe of
// benchmarks/diagnostics/polar_tpu_debug2.py (make_probe) for the
// current row-sum algorithm.
//
// Design.  The TPU kernel keeps Y resident in VMEM; here Y (1.25 MiB at
// 4096 x 80) does not fit an SM, so the work is three launches on one
// stream, with the Gram and the apply shared with K1 (panel.cuh):
//   (a) panel::gram_partials: partial Grams over row splits,
//       deterministic, no atomics;
//   (b) ns_iterate: ONE block of 1024 threads sums the partials in split
//       order and runs the whole l x l iteration.  It keeps six l x l
//       matrices (H, two temporaries, W, G~, G) in dynamic shared memory
//       as far as they fit (all six up to l = 98, 6 x 37.5 KB; three at
//       l = 128), the rest in the workspace.  Each l x l product gives a
//       thread 2 x 2 outputs summed in order over k.  It writes W_s to
//       the workspace and R = W_s G to the output;
//   (c) panel::apply_right: tiles of Q = Y W_s.
// The TPU kernel pads l to 128 for its tiles and restores an identity on
// the pad block of G~; nothing is padded here.
//
// Numerics.  Every product is plain fp32 FMA: no TF32, no tensor cores,
// matching Precision.HIGHEST (a single bf16 pass makes the schedule
// diverge, polar.py:84-92).  The elementwise steps use __fmul_rn and
// __fadd_rn so that they round as the plain version does.  No clamp and
// no shift: a rank-deficient Y is out of domain (NaN or garbage), as the
// polar contract says.
//
// What bounds it.  At the main path's 4096 x 80 the work is ~105 MFLOP
// in (a) and (c) and 4 x iters = 32 products of 2 l^3 = 33 MFLOP in
// (b): ~2.1 us at the card's 67 TFLOP/s fp32, above the ~0.8 us of its
// 2.65 MB of traffic.  The kernel is far from both: (b) runs 32 dependent
// products on ONE SM while the others idle.  Spreading (b) over a
// cluster, or the products onto tensor cores at 3 x TF32, is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "panel.cuh"

namespace {

constexpr int kIterThreads = 1024;
constexpr int kMaxIters = 16;
constexpr int kSlots = 6;           // l x l matrices the iteration keeps
constexpr int kRed = 64;            // floats of reduction scratch
constexpr size_t kSmemMax = 232448;  // bytes of shared memory a block may use

struct Schedule {
  float abc[kMaxIters][3];
};

struct Plan {
  panel::GramPlan gram;
  size_t ws_off;          // W_s (l x l), read by the apply
  size_t slots_off;       // matrices that do not fit shared memory
  int slots_in_smem;
  size_t total_floats;
  size_t smem_bytes;
};

Plan make_plan(int m, int l) {
  Plan p;
  p.gram = panel::make_gram_plan(m, l);
  const size_t ll = (size_t)l * l;
  p.ws_off = (size_t)p.gram.nsplit * ll;
  p.slots_off = p.ws_off + ll;
  const size_t fit = (kSmemMax - kRed * sizeof(float)) / (ll * sizeof(float));
  p.slots_in_smem = fit > (size_t)kSlots ? kSlots : (int)fit;
  p.total_floats = p.slots_off + (size_t)(kSlots - p.slots_in_smem) * ll;
  p.smem_bytes = sizeof(float) * (kRed + (size_t)p.slots_in_smem * ll);
  return p;
}

// C = op(A) B for l x l row-major matrices, op(A) = A^T when kTransA.
// Each thread owns a 2 x 2 block of C; every sum runs over k in order.
// C must not alias A or B.  Ends with a block barrier.
template <bool kTransA>
__device__ void block_mm(float* c, const float* a, const float* b, int l) {
  const int h = (l + 1) / 2;
  for (int t = threadIdx.x; t < h * h; t += blockDim.x) {
    const int i = 2 * (t / h);
    const int j = 2 * (t % h);
    const bool i1 = i + 1 < l;
    const bool j1 = j + 1 < l;
    float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
    for (int k = 0; k < l; ++k) {
      const float a0 = kTransA ? a[(size_t)k * l + i] : a[(size_t)i * l + k];
      float a1 = 0.f;
      if (i1)
        a1 = kTransA ? a[(size_t)k * l + i + 1] : a[(size_t)(i + 1) * l + k];
      const float* brow = b + (size_t)k * l;
      const float b0 = brow[j];
      const float b1 = j1 ? brow[j + 1] : 0.f;
      c00 = fmaf(a0, b0, c00);
      c01 = fmaf(a0, b1, c01);
      c10 = fmaf(a1, b0, c10);
      c11 = fmaf(a1, b1, c11);
    }
    c[(size_t)i * l + j] = c00;
    if (j1) c[(size_t)i * l + j + 1] = c01;
    if (i1) {
      c[(size_t)(i + 1) * l + j] = c10;
      if (j1) c[(size_t)(i + 1) * l + j + 1] = c11;
    }
  }
  __syncthreads();
}

// out = a I + b h + c h2, elementwise; out may alias h2.
__device__ void poly(float* out, const float* h, const float* h2, float a,
                     float b, float c, int l) {
  const size_t ll = (size_t)l * l;
  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    const float diag = (e / l == e % l) ? a : 0.f;
    out[e] = __fadd_rn(__fadd_rn(diag, __fmul_rn(b, h[e])),
                       __fmul_rn(c, h2[e]));
  }
  __syncthreads();
}

// h = (h + h^T) / 2 in place.
__device__ void symmetrize(float* h, int l) {
  const size_t ll = (size_t)l * l;
  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    const int i = (int)(e / l);
    const int j = (int)(e % l);
    if (i < j) {
      const float v = __fmul_rn(
          0.5f, __fadd_rn(h[e], h[(size_t)j * l + i]));
      h[e] = v;
      h[(size_t)j * l + i] = v;
    }
  }
  __syncthreads();
}

__device__ void copy_out(float* dst, const float* src, int l) {
  const size_t ll = (size_t)l * l;
  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) dst[e] = src[e];
}

// max that keeps a NaN, as jnp.max does
__device__ float max_nan(float x, float y) {
  return (y > x || y != y) ? y : x;
}

// (b) one block: G from the partials, the whole iteration, W_s and R.
__global__ void __launch_bounds__(kIterThreads)
ns_iterate(const float* __restrict__ part, int nsplit, float* r,
           float* ws_out, float* slots_global, int slots_in_smem, int l,
           Schedule sch, int iters, int stage) {
  extern __shared__ float smem[];
  float* red = smem;
  const size_t ll = (size_t)l * l;
  float* slot[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    slot[s] = s < slots_in_smem
                  ? smem + kRed + (size_t)s * ll
                  : slots_global + (size_t)(s - slots_in_smem) * ll;
  // the most used first, so that they are the ones in shared memory
  float* h = slot[0];
  float* t1 = slot[1];
  float* t2 = slot[2];
  float* w = slot[3];
  float* gt = slot[4];
  float* g = slot[5];

  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += part[(size_t)p * ll + e];
    g[e] = s;
  }
  __syncthreads();
  if (stage == 0) return copy_out(r, g, l);

  // alpha: the largest row sum of |G| (a lambda_max bound), no shift
  float mx = 0.f;
  for (int i = threadIdx.x; i < l; i += blockDim.x) {
    float rs = 0.f;
    for (int j = 0; j < l; ++j) rs += fabsf(g[(size_t)i * l + j]);
    mx = max_nan(mx, rs);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[32] = __fadd_rn(mx, 1e-30f);
  }
  __syncthreads();
  const float alpha = red[32];
  const float inv_alpha = 1.f / alpha;
  for (size_t e = threadIdx.x; e < ll; e += blockDim.x)
    gt[e] = __fmul_rn(g[e], inv_alpha);
  __syncthreads();
  if (stage == 1) return copy_out(r, gt, l);

  block_mm<false>(t1, gt, gt, l);                       // G~^2
  poly(w, gt, t1, sch.abc[0][0], sch.abc[0][1], sch.abc[0][2], l);
  if (stage == 2) return copy_out(r, w, l);
  block_mm<false>(t2, gt, w, l);                        // G~ W
  block_mm<true>(h, w, t2, l);                          // W^T G~ W
  symmetrize(h, l);
  if (stage == 3) return copy_out(r, h, l);

  for (int k = 1; k < iters; ++k) {
    block_mm<false>(t1, h, h, l);                       // H^2
    poly(t1, h, t1, sch.abc[k][0], sch.abc[k][1], sch.abc[k][2], l);
    block_mm<false>(t2, w, t1, l);                      // W P
    float* swap = w;
    w = t2;
    t2 = swap;
    block_mm<false>(t1, gt, w, l);                      // G~ W
    block_mm<true>(h, w, t1, l);                        // W^T G~ W
    symmetrize(h, l);
    if (stage == 3 + k) return copy_out(r, h, l);
  }

  const float scale = 1.f / sqrtf(alpha);
  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    const float v = __fmul_rn(w[e], scale);
    w[e] = v;
    ws_out[e] = v;
  }
  __syncthreads();
  block_mm<false>(r, w, g, l);                          // R = W_s G
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_polar_f32 needs for an m x l panel.
size_t rsvd_polar_workspace_floats(int m, int l) {
  if (m <= 0 || l <= 0) return 0;
  return make_plan(m, l).total_floats;
}

// Launches (a)-(c) on `stream` (only (a) and (b) when stage >= 0);
// `coeffs` holds 3 * iters floats on the host.  Returns
// cudaGetLastError() (0 = launched).
int rsvd_polar_f32(const float* y, float* q, float* r, float* work, int m,
                   int l, const float* coeffs, int iters, int stage,
                   void* stream) {
  if (m <= 0 || l <= 0) return 0;
  if (iters < 1 || iters > kMaxIters || stage > 2 + iters)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(m, l);
  Schedule sch = {};
  for (int k = 0; k < iters; ++k)
    for (int c = 0; c < 3; ++c) sch.abc[k][c] = coeffs[3 * k + c];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ns_iterate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  float* part = work;
  float* ws = work + p.ws_off;
  panel::launch_gram_partials(y, part, m, l, p.gram, s);
  ns_iterate<<<1, kIterThreads, p.smem_bytes, s>>>(
      part, p.gram.nsplit, r, ws, work + p.slots_off, p.slots_in_smem, l,
      sch, iters, stage);
  if (stage < 0)
    panel::launch_apply_right<false>(y, ws, q, m, l, /*upper=*/false, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
