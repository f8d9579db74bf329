// Kernel K1: CholeskyQR1 of a tall-skinny f32 panel, for Hopper (sm_90a).
//
// Replaces the TPU kernel in
//   rsvd_kamaneh_raganato_terrana_tpu/linalg/pallas_kernels.py
//   fused_cholqr1 / _cholqr_kernel.
// Given Y (m x l, row-major f32) it returns R (l x l, upper-triangular,
// R = L^T where G = Y^T Y = L L^T) and Q = Y L^{-T} (m x l).
//
// Design.  The TPU kernel keeps Y resident in VMEM for the whole kernel.
// An SM has at most 227 KB of shared memory and Y at 4096 x 80 is
// 1.25 MiB, so here the work is three launches on one stream:
//   (a) panel::gram_partials (panel.cuh): partial Grams over row splits,
//       deterministic, no atomics.
//   (b) eliminate: ONE block sums the partials in split order into
//       M = [G | I] (l x 2l; dynamic shared memory when l <= 128, else
//       the workspace) and runs the l steps of the augmented elimination
//       of the TPU kernel's `step`: the pivot's rsqrt, the normalized
//       pivot row, a rank-1 update of the rows below.  The left half ends
//       as R and the right half as L^{-1}.
//   (c) panel::apply_right (panel.cuh): tiles of Q = Y (L^{-1})^T; the
//       sum of each tile stops at its last column, since (L^{-1})^T is
//       upper-triangular.
// All arithmetic is plain fp32 FMA: no TF32, no tensor cores, matching
// Precision.HIGHEST in the Pallas kernel.  A non-positive pivot (rank-
// deficient Y) gives inf/NaN with no clamp, which is the cholqr1 contract.
//
// What bounds it.  At the main path's 4096 x 80 the work is ~53 MFLOP in
// (a) and (c) and ~0.5 MFLOP in (b).  The bound is latency: the l
// dependent steps of (b), two block barriers each, on one SM while the
// rest of the card idles, plus three launches.  Making it fast (a
// cluster- or warp-level elimination, one persistent launch for (a)-(c))
// is left to a later change.

#include <cuda_runtime.h>

#include <cstddef>

#include "panel.cuh"

namespace {

constexpr int kElimThreads = 1024;
constexpr int kSmemRowsMax = 128;  // M in shared memory up to this l

struct Plan {
  panel::GramPlan gram;
  size_t part_floats;
  size_t linv_off;
  size_t m_off;
  size_t total_floats;
  bool m_in_smem;
  size_t smem_bytes;
};

Plan make_plan(int m, int l) {
  Plan p;
  p.gram = panel::make_gram_plan(m, l);
  const size_t ll = (size_t)l * l;
  p.part_floats = (size_t)p.gram.nsplit * ll;
  p.linv_off = p.part_floats;
  p.m_off = p.linv_off + ll;
  p.m_in_smem = l <= kSmemRowsMax;
  p.total_floats = p.m_off + (p.m_in_smem ? 0 : 2 * ll);
  // rown (l + 1 floats) and mult (l floats), plus M when it fits
  p.smem_bytes = sizeof(float) *
                 ((size_t)(2 * l + 1) + (p.m_in_smem ? 2 * ll : 0));
  return p;
}

// (b) one block: M = [sum of partials | I], then the l elimination steps.
__global__ void __launch_bounds__(kElimThreads)
eliminate(const float* __restrict__ part, int nsplit, float* __restrict__ r,
          float* __restrict__ linv, float* m_global, int l) {
  extern __shared__ float smem[];
  const int w = 2 * l;
  const size_t ll = (size_t)l * l;
  float* mm = m_global ? m_global : smem;
  float* rown = m_global ? smem : smem + 2 * ll;  // l + 1 floats
  float* mult = rown + (l + 1);                    // l floats

  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    const int i = (int)(e / l);
    const int c = (int)(e % l);
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += part[(size_t)p * ll + e];
    mm[(size_t)i * w + c] = s;
    mm[(size_t)i * w + l + c] = (i == c) ? 1.f : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // Step j touches columns [j, l + j] only: left of j the rows below are
  // already eliminated, and right of l + j the augmented half is still 0.
  for (int j = 0; j < l; ++j) {
    const float* pivot_row = mm + (size_t)j * w;
    const float d = rsqrtf(pivot_row[j]);
    for (int cc = threadIdx.x; cc <= l; cc += blockDim.x)
      rown[cc] = pivot_row[j + cc] * d;
    for (int i = j + 1 + threadIdx.x; i < l; i += blockDim.x)
      mult[i] = mm[(size_t)i * w + j] * d;
    __syncthreads();
    for (int i = j + 1 + warp; i < l; i += nwarps) {
      float* row = mm + (size_t)i * w + j;
      const float f = mult[i];
      // column j itself is never read again (R keeps the upper triangle)
      for (int cc = 1 + lane; cc <= l; cc += 32)
        row[cc] = fmaf(-f, rown[cc], row[cc]);
    }
    for (int cc = threadIdx.x; cc <= l; cc += blockDim.x)
      mm[(size_t)j * w + j + cc] = rown[cc];
    __syncthreads();
  }

  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    const int i = (int)(e / l);
    const int c = (int)(e % l);
    r[e] = c >= i ? mm[(size_t)i * w + c] : 0.f;
    linv[e] = c <= i ? mm[(size_t)i * w + l + c] : 0.f;
  }
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_cholqr1_f32 needs for an m x l panel.
size_t rsvd_cholqr1_workspace_floats(int m, int l) {
  if (m <= 0 || l <= 0) return 0;
  return make_plan(m, l).total_floats;
}

// Launches (a)-(c) on `stream`; returns cudaGetLastError() (0 = launched).
int rsvd_cholqr1_f32(const float* y, float* q, float* r, float* work, int m,
                     int l, void* stream) {
  if (m <= 0 || l <= 0) return 0;
  const Plan p = make_plan(m, l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      eliminate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  float* part = work;
  float* linv = work + p.linv_off;
  float* m_global = p.m_in_smem ? nullptr : work + p.m_off;
  panel::launch_gram_partials(y, part, m, l, p.gram, s);
  eliminate<<<1, kElimThreads, p.smem_bytes, s>>>(part, p.gram.nsplit, r,
                                                  linv, m_global, l);
  // Q = Y (L^{-1})^T; (L^{-1})^T is upper-triangular
  panel::launch_apply_right<true>(y, linv, q, m, l, /*upper=*/true, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
