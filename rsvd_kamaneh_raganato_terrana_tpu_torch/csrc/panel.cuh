// Tall-skinny panel kernels shared by K1 (cholqr1.cu) and K2 (polar.cu).
//
// Both TPU kernels keep the panel Y (m x l f32) resident in VMEM and work
// on it twice: once for the Gram G = Y^T Y, once for an apply Y M with an
// l x l matrix M.  Y does not fit one SM here (1.25 MiB at 4096 x 80), so
// the two passes are grid launches over device memory:
//   gram_partials: a grid of 64 x 64 tiles of G times row splits.  Each
//     block accumulates Y^T Y over its rows into its own l x l partial in
//     a workspace; the caller's one-block kernel sums the partials in
//     split order.  No atomics: the split depends only on (m, l), so the
//     result is deterministic, and G is bitwise symmetric (tile (i, j)
//     and tile (j, i) run the same products in the same order).
//   apply_right: a grid of 64 x 64 tiles of OUT = Y op(M), op(M) = M or
//     M^T, with tiles of Y and M staged in shared memory.
// All arithmetic is plain fp32 FMA: no TF32, no tensor cores.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace panel {

constexpr int kTile = 64;      // output tile edge
constexpr int kTk = 16;        // depth of one staged slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct GramPlan {
  int tiles;           // tiles of G along each edge
  int nsplit;          // row splits = partial Grams
  int rows_per_split;
};

// About 256 blocks in all, so that every SM has work at l <= 64.
inline GramPlan make_gram_plan(int m, int l) {
  GramPlan p;
  p.tiles = (l + kTile - 1) / kTile;
  const int target = 256 / (p.tiles * p.tiles);
  const int chunks = (m + kTk - 1) / kTk;
  int nsplit = target < 1 ? 1 : target;
  if (nsplit > chunks) nsplit = chunks;
  const int chunks_per_split = (chunks + nsplit - 1) / nsplit;
  p.rows_per_split = chunks_per_split * kTk;
  p.nsplit = (m + p.rows_per_split - 1) / p.rows_per_split;
  return p;
}

// part[s] = Y[rows of split s]^T Y[rows of split s]
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

// OUT = Y op(M):  OUT[r][i] = sum_c Y[r][c] op(M)[c][i], with
// op(M)[c][i] = M[i][c] when kTransM, else M[c][i].  `upper` says op(M)
// is upper-triangular (op(M)[c][i] = 0 for c > i), so a tile of columns
// stops its sum at its own last column.
template <bool kTransM>
__global__ void __launch_bounds__(kThreads)
apply_right(const float* __restrict__ y, const float* __restrict__ mat,
            float* __restrict__ out, int m, int l, bool upper) {
  __shared__ float as[kTk][kTile + 1];  // as[k][r] = Y[r0 + r][k0 + k]
  __shared__ float bs[kTk][kTile + 1];  // bs[k][i] = op(M)[k0 + k][i0 + i]
  const long long r0 = (long long)blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  const int k_end = (upper && i0 + kTile < l) ? i0 + kTile : l;
  for (int k0 = 0; k0 < k_end; k0 += kTk) {
    for (int e = threadIdx.x; e < kTk * kTile; e += kThreads) {
      const int rr = e / kTk;
      const int k = e % kTk;
      const long long row = r0 + rr;
      const int col = k0 + k;
      as[k][rr] = (row < m && col < l) ? y[row * l + col] : 0.f;
      const int i = i0 + rr;
      float b = 0.f;
      if (i < l && col < l)
        b = kTransM ? mat[(size_t)i * l + col] : mat[(size_t)col * l + i];
      bs[k][rr] = b;
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
      if (row < m && i < l) out[row * l + i] = acc[u][v];
    }
}

inline void launch_gram_partials(const float* y, float* part, int m, int l,
                                 const GramPlan& p, cudaStream_t s) {
  gram_partials<<<dim3(p.tiles, p.tiles, p.nsplit), kThreads, 0, s>>>(
      y, part, m, l, p.rows_per_split);
}

template <bool kTransM>
inline void launch_apply_right(const float* y, const float* mat, float* out,
                               int m, int l, bool upper, cudaStream_t s) {
  const unsigned row_tiles = (unsigned)((m + kTile - 1) / kTile);
  const unsigned col_tiles = (unsigned)((l + kTile - 1) / kTile);
  apply_right<kTransM><<<dim3(row_tiles, col_tiles), kThreads, 0, s>>>(
      y, mat, out, m, l, upper);
}

}  // namespace panel

// Every kernel library exports this, for the wrapper's error message.
extern "C" const char* rsvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
