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
//   (a) gram_partials: a grid of 64 x 64 tiles of G times row splits.
//       Each block accumulates Y^T Y over its rows into its own l x l
//       partial in the workspace.  No atomics: the split depends only on
//       (m, l), so the result is deterministic.
//   (b) eliminate: ONE block sums the partials in split order into
//       M = [G | I] (l x 2l; dynamic shared memory when l <= 128, else
//       the workspace) and runs the l steps of the augmented elimination
//       of the TPU kernel's `step`: the pivot's rsqrt, the normalized
//       pivot row, a rank-1 update of the rows below.  The left half ends
//       as R and the right half as L^{-1}.
//   (c) apply_q: a grid of 64 x 64 tiles of Q = Y (L^{-1})^T, with tiles
//       of Y and L^{-1} staged in shared memory.
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

namespace {

constexpr int kTile = 64;      // output tile edge of (a) and (c)
constexpr int kTk = 16;        // depth of one staged slice
constexpr int kThreads = 256;  // (a) and (c): 16 x 16 threads, 4 x 4 each
constexpr int kElimThreads = 1024;
constexpr int kSmemRowsMax = 128;  // M in shared memory up to this l

struct Plan {
  int tiles;
  int nsplit;
  int rows_per_split;
  size_t part_floats;
  size_t linv_off;
  size_t m_off;
  size_t total_floats;
  bool m_in_smem;
  size_t smem_bytes;
};

Plan make_plan(int m, int l) {
  Plan p;
  p.tiles = (l + kTile - 1) / kTile;
  const int target = 256 / (p.tiles * p.tiles);
  const int chunks = (m + kTk - 1) / kTk;
  int nsplit = target < 1 ? 1 : target;
  if (nsplit > chunks) nsplit = chunks;
  const int chunks_per_split = (chunks + nsplit - 1) / nsplit;
  p.rows_per_split = chunks_per_split * kTk;
  p.nsplit = (m + p.rows_per_split - 1) / p.rows_per_split;
  const size_t ll = (size_t)l * l;
  p.part_floats = (size_t)p.nsplit * ll;
  p.linv_off = p.part_floats;
  p.m_off = p.linv_off + ll;
  p.m_in_smem = l <= kSmemRowsMax;
  p.total_floats = p.m_off + (p.m_in_smem ? 0 : 2 * ll);
  // rown (l + 1 floats) and mult (l floats), plus M when it fits
  p.smem_bytes = sizeof(float) *
                 ((size_t)(2 * l + 1) + (p.m_in_smem ? 2 * ll : 0));
  return p;
}

// (a) partial Grams: part[s] = Y[rows of split s]^T Y[rows of split s]
__global__ void __launch_bounds__(kThreads)
gram_partials(const float* __restrict__ y, float* __restrict__ part, int m,
              int l, int rows_per_split) {
  __shared__ float as[kTk][kTile];  // as[k][i] = Y[r0 + k][i0 + i]
  __shared__ float bs[kTk][kTile];  // bs[k][j] = Y[r0 + k][j0 + j]
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > m) r_end = m;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += kTk) {
    for (int e = threadIdx.x; e < kTk * kTile; e += kThreads) {
      const int k = e / kTile;
      const int c = e % kTile;
      const long long r = r0 + k;
      const bool row_ok = r < r_end;
      as[k][c] = (row_ok && i0 + c < l) ? y[r * l + i0 + c] : 0.f;
      bs[k][c] = (row_ok && j0 + c < l) ? y[r * l + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTk; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = as[k][ty + 16 * u];
        b[u] = bs[k][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * l * l;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u;
      const int j = j0 + tx + 16 * v;
      if (i < l && j < l) out[(size_t)i * l + j] = acc[u][v];
    }
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

// (c) Q = Y (L^{-1})^T: Q[r][i] = sum_{c <= i} Y[r][c] L^{-1}[i][c]
__global__ void __launch_bounds__(kThreads)
apply_q(const float* __restrict__ y, const float* __restrict__ linv,
        float* __restrict__ q, int m, int l) {
  __shared__ float as[kTk][kTile + 1];  // as[k][r] = Y[r0 + r][k0 + k]
  __shared__ float bs[kTk][kTile + 1];  // bs[k][i] = L^{-1}[i0 + i][k0 + k]
  const long long r0 = (long long)blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  // L^{-1} is lower-triangular: columns past this tile's last row are 0
  const int k_end = (i0 + kTile < l) ? i0 + kTile : l;
  for (int k0 = 0; k0 < k_end; k0 += kTk) {
    for (int e = threadIdx.x; e < kTk * kTile; e += kThreads) {
      const int rr = e / kTk;
      const int k = e % kTk;
      const long long row = r0 + rr;
      const int col = k0 + k;
      as[k][rr] = (row < m && col < l) ? y[row * l + col] : 0.f;
      bs[k][rr] = (i0 + rr < l && col < l) ? linv[(size_t)(i0 + rr) * l + col]
                                           : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTk; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = as[k][ty + 16 * u];
        b[u] = bs[k][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const long long row = r0 + ty + 16 * u;
      const int i = i0 + tx + 16 * v;
      if (row < m && i < l) q[row * l + i] = acc[u][v];
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
  gram_partials<<<dim3(p.tiles, p.tiles, p.nsplit), kThreads, 0, s>>>(
      y, part, m, l, p.rows_per_split);
  eliminate<<<1, kElimThreads, p.smem_bytes, s>>>(part, p.nsplit, r, linv,
                                                  m_global, l);
  const unsigned row_tiles = (unsigned)((m + kTile - 1) / kTile);
  apply_q<<<dim3(row_tiles, p.tiles), kThreads, 0, s>>>(y, linv, q, m, l);
  return (int)cudaGetLastError();
}

const char* rsvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
