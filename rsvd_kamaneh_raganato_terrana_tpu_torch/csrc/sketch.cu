// Kernel K4: the rSVD sketch Y = A Omega with the Gaussian test matrix
// Omega drawn inside the kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel in
//   rsvd_kamaneh_raganato_terrana_tpu/linalg/pallas_kernels.py
//   fused_sketch_matmul / _sketch_kernel / _gaussian_tile.
// Given A (m x n, row-major f32), l and a seed it returns Y (m x l f32).
// Omega (n x l) never exists in device memory: each of its entries is a
// pure function of (seed, row * l_pad + col), l_pad = max(128, l rounded
// up to 128) -- the TPU kernel's index, kept so that both draw the same
// Omega.  The draw is the TPU kernel's, in uint32 arithmetic that wraps
// as JAX's does: a murmur3 finalizer of the index xor the mixed seed
// gives h0, a second one of h0 xor a salt gives h1, their top 24 bits
// give u1, u2 in (0, 1), and z = sqrt(-2 log u1) cos(2 pi u2) in f32
// (logf, cosf, sqrtf without fast math, as torch's log, cos and sqrt run
// on the card).
//
// Design.  A grid of 128 x 128 tiles of Y times splits of the
// contraction.  Each block stages a 128 x 16 slice of A and draws the
// matching 16 x 128 slab of Omega (only its first l columns) into shared
// memory, then accumulates 8 x 8 outputs per thread in plain fp32 FMA:
// no TF32, no tensor cores, so the hash-drawn Omega multiplies at full
// f32.  Ragged m, n and l are masked in the kernel; A is never padded in
// device memory.  With more than one split, each split writes its own
// partial Y into the workspace and a second launch sums them in split
// order: deterministic, no atomics.
//
// What bounds it.  At 4096^2, l = 80: 2 m n l = 2.68 GFLOP, 40.1 us of
// the card's fp32 rate, against 20.4 us for A's 64 MiB read and Y's
// write: operations.  The kernel also spends (m / 128) n l = 10.5 M
// Box-Muller draws (every row tile draws the same Omega slab again, as
// the TPU kernel does) and runs the 48 pad columns of its 128-wide tile,
// so it does ~1.6x the bound's multiply-adds plus ~1 G instructions of
// hashing and transcendentals.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "panel.cuh"

namespace {

using rsvd_hash::mix;

constexpr int kTileM = 128;
constexpr int kTileL = 128;
constexpr int kTk = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMinSplitDepth = 256;
constexpr int kTargetBlocks = 264;  // two blocks for each of the 132 SMs
constexpr uint32_t kSalt = 0x68BC21EBu;
constexpr float kTwoPi = (float)6.283185307179586;  // 2 pi rounded to f32

// top 24 bits -> (0, 1), floored at 1e-12 so that log is finite
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return fmaxf(__fmul_rn((float)(int)(bits >> 8), 1.0f / 16777216.0f),
               1e-12f);
}

__device__ __forceinline__ float omega_at(uint32_t row, uint32_t col,
                                          uint32_t l_pad, uint32_t seed_mix) {
  const uint32_t h0 = mix((row * l_pad + col) ^ seed_mix);
  const uint32_t h1 = mix(h0 ^ kSalt);
  const float u1 = unit_float(h0);
  const float u2 = unit_float(h1);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(kTwoPi, u2)));
}

struct Plan {
  int row_tiles;
  int col_tiles;
  int nsplit;
  int k_per_split;  // a multiple of kTk
};

Plan make_plan(int m, int n, int l) {
  Plan p;
  p.row_tiles = (m + kTileM - 1) / kTileM;
  p.col_tiles = (l + kTileL - 1) / kTileL;
  const int tiles = p.row_tiles * p.col_tiles;
  int want = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (n + kMinSplitDepth - 1) / kMinSplitDepth;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int per = (n + want - 1) / want;
  p.k_per_split = (per + kTk - 1) / kTk * kTk;
  p.nsplit = (n + p.k_per_split - 1) / p.k_per_split;
  return p;
}

// out[z] = A[:, split z] Omega[split z, :] for the block's 128 x 128 tile
__global__ void __launch_bounds__(kThreads)
sketch_tiles(const float* __restrict__ a, float* __restrict__ out, int m,
             int n, int l, uint32_t l_pad, uint32_t seed_mix,
             int k_per_split) {
  __shared__ float as[kTk][kTileM + 1];  // as[k][r] = A[r0 + r][k0 + k]
  __shared__ float ws[kTk][kTileL];      // ws[k][c] = Omega[k0 + k][c0 + c]
  const long long r0 = (long long)blockIdx.x * kTileM;
  const int c0 = blockIdx.y * kTileL;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(n, k_begin + k_per_split);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][8] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kTk) {
    for (int e = threadIdx.x; e < kTk * kTileM; e += kThreads) {
      const int rr = e / kTk;
      const int k = e % kTk;
      const long long row = r0 + rr;
      const int col = k0 + k;
      as[k][rr] = (row < m && col < k_end) ? a[row * n + col] : 0.f;
    }
    for (int e = threadIdx.x; e < kTk * kTileL; e += kThreads) {
      const int k = e / kTileL;
      const int c = e % kTileL;
      const int krow = k0 + k;
      ws[k][c] = (krow < k_end && c0 + c < l)
                     ? omega_at((uint32_t)krow, (uint32_t)(c0 + c), l_pad,
                                seed_mix)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTk; ++k) {
      float av[8], wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        av[u] = as[k][ty + 16 * u];
        wv[u] = ws[k][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], wv[v], acc[u][v]);
    }
    __syncthreads();
  }
  float* dst = out + (size_t)blockIdx.z * m * l;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const long long row = r0 + ty + 16 * u;
      const int col = c0 + tx + 16 * v;
      if (row < m && col < l) dst[row * l + col] = acc[u][v];
    }
}

// y = sum of the nsplit partials, in split order
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ y, size_t count, int nsplit) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nsplit; ++z) s += part[(size_t)z * count + e];
    y[e] = s;
  }
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_sketch_f32 needs (the split partials;
// 0 when the contraction is not split).
size_t rsvd_sketch_workspace_floats(int m, int n, int l) {
  if (m <= 0 || n <= 0 || l <= 0) return 0;
  const Plan p = make_plan(m, n, l);
  return p.nsplit > 1 ? (size_t)p.nsplit * m * l : 0;
}

// Launches Y = A Omega(seed) on `stream`; returns cudaGetLastError()
// (0 = launched).  `seed` is the seed's two's-complement uint32.
int rsvd_sketch_f32(const float* a, float* y, float* work, int m, int n,
                    int l, uint32_t seed, void* stream) {
  if (m <= 0 || n <= 0 || l <= 0) return 0;
  const Plan p = make_plan(m, n, l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t l_pad = l <= 128 ? 128u : (uint32_t)((l + 127) / 128 * 128);
  float* out = p.nsplit > 1 ? work : y;
  sketch_tiles<<<dim3(p.row_tiles, p.col_tiles, p.nsplit), kThreads, 0, s>>>(
      a, out, m, n, l, l_pad, mix(seed), p.k_per_split);
  if (p.nsplit > 1) {
    const size_t count = (size_t)m * l;
    size_t blocks = (count + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    sum_splits<<<(unsigned)blocks, 256, 0, s>>>(work, y, count, p.nsplit);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
