// Tall-skinny panel kernels shared by K1 (cholqr1.cu) and K2 (polar.cu).
//
// Both TPU kernels keep the panel Y (m x l f32) resident in VMEM and work
// on it twice: once for the Gram G = Y^T Y, once for an apply Y M with an
// l x l matrix M.  Y does not fit one SM here (1.25 MiB at 4096 x 80), so
// the two passes are grid launches over device memory.
//
// l <= kMaxNarrow (the paths' l = 80 and anything up to 128):
//   gram_cluster: one l-wide tile of G per block (NC = ceil(l / 16) a
//     template argument: 256 threads, NC x NC outputs each), row splits
//     sized to one wave of the H100's 132 SMs (kWaveBlocks blocks).  The
//     blocks of a thread-block cluster of kGramCluster add their partials
//     through distributed shared memory, each block a band of rows, in
//     rank order, so the launch writes one partial per cluster (16 at
//     4096 x 80, not 64 or 128).  The caller's l x l stage sums those in
//     part order, again one band of rows per block of its own cluster
//     (band_sum).
//   apply_rows: the l x l operand op(M) staged in shared memory once per
//     block; a block walks tiles of kApplyRows rows x all l columns.  An
//     upper-triangular op(M) skips each 16-deep slice of the sum for the
//     16-column groups left of it.
// l > kMaxNarrow keeps the tiled path: gram_partials (64 x 64 tiles of G
// times row splits, one partial per split) and apply_right (64 x 64 tiles
// of the output).
// Every sum runs in an order fixed by (m, l): no atomics, so the result is
// deterministic, and G is bitwise symmetric (entry (i, j) and entry (j, i)
// are the same products added in the same order).  All arithmetic is plain
// fp32 FMA: no TF32, no tensor cores.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace panel {

namespace cg = cooperative_groups;

constexpr int kTile = 64;      // tiled path: output tile edge
constexpr int kTk = 16;        // tiled path: depth of one staged slice
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxNarrow = 128;   // widest l of the one-tile path
constexpr int kGramRows = 32;     // rows of Y staged at a time
constexpr int kGramCluster = 8;   // Gram blocks whose partials add in DSMEM
constexpr int kWaveBlocks = 128;  // one wave of 132 SMs, kGramCluster | it
constexpr int kApplyRows = 32;    // rows of one apply tile
constexpr int kApplyBlocksMax = 264;  // two blocks per SM of the H100
constexpr size_t kSmemMax = 232448;   // bytes of shared memory a block may use
constexpr int kMaxDevices = 64;

// the split cluster barrier: arrive publishes this block's shared-memory
// writes (and its remote ones), wait returns once every block of the
// cluster has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// 4 bytes from global `src` into shared `dst`, asynchronously; zero-filled
// when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// waits for this thread's cp.async copies, then for the block's
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

struct GramPlan {
  bool narrow;         // l <= kMaxNarrow: gram_cluster, else gram_partials
  int nc;              // narrow: 16-column groups of the tile
  int blocks;          // narrow: blocks launched, a multiple of kGramCluster
  int tiles;           // tiled: tiles of G along each edge
  int rows_per_split;
  int nparts;          // partial Grams in the workspace
};

inline GramPlan make_gram_plan(int m, int l) {
  GramPlan p = {};
  p.narrow = l <= kMaxNarrow;
  if (p.narrow) {
    p.nc = (l + 15) / 16;
    const int chunks = (m + kGramRows - 1) / kGramRows;
    const int want = chunks < kWaveBlocks ? chunks : kWaveBlocks;
    p.rows_per_split = (chunks + want - 1) / want * kGramRows;
    const int splits = (m + p.rows_per_split - 1) / p.rows_per_split;
    p.blocks = (splits + kGramCluster - 1) / kGramCluster * kGramCluster;
    p.nparts = p.blocks / kGramCluster;
  } else {
    // about 256 blocks in all
    p.tiles = (l + kTile - 1) / kTile;
    const int target = 256 / (p.tiles * p.tiles);
    const int chunks = (m + kTk - 1) / kTk;
    int nsplit = target < 1 ? 1 : target;
    if (nsplit > chunks) nsplit = chunks;
    p.rows_per_split = (chunks + nsplit - 1) / nsplit * kTk;
    p.nparts = (m + p.rows_per_split - 1) / p.rows_per_split;
  }
  return p;
}

inline size_t gram_smem_bytes(int l, int nc) {
  return sizeof(float) * ((size_t)kGramRows * 16 * nc + (size_t)l * l);
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory = kSmemMax) once
// per process and device; `done` is the caller's flag per device.
template <typename Kernel>
inline cudaError_t allow_smem_once(Kernel kernel, bool (&done)[kMaxDevices],
                                   bool nonportable_cluster = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemMax);
  if (err == cudaSuccess && nonportable_cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Launches `kernel` and returns the launch's own status (never an error
// left behind by an earlier call); `cluster` > 0 groups the blocks along x
// into thread-block clusters of that many.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t s, int cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// part[cluster] = sum over the cluster's row splits of Y^T Y.  Dynamic
// shared memory: the staged rows of Y (kGramRows x 16 NC) and this block's
// l x l partial.
template <int NC>
__global__ void __launch_bounds__(kThreads)
gram_cluster(const float* __restrict__ y, float* __restrict__ part, int m,
             int l, int rows_per_split) {
  constexpr int kW = 16 * NC;
  extern __shared__ float smem[];
  float* ys = smem;                       // ys[r * kW + c] = Y[r0 + r][c]
  float* gp = smem + kGramRows * kW;      // this block's partial, l x l
  cg::cluster_group cluster = cg::this_cluster();
  const long long r_begin = (long long)blockIdx.x * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > m) r_end = m;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[NC][NC] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += kGramRows) {
    // every load of the chunk in flight at once
    for (int e = threadIdx.x; e < kGramRows * kW; e += kThreads) {
      const int rr = e / kW;
      const int c = e % kW;
      const long long r = r0 + rr;
      const bool ok = r < r_end && c < l;
      cp_async4(ys + e, ok ? y + r * l + c : y, ok);
    }
    cp_async_wait_all();
#pragma unroll 4
    for (int k = 0; k < kGramRows; ++k) {
      float a[NC], b[NC];
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        a[u] = ys[k * kW + ty + 16 * u];
        b[u] = ys[k * kW + tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < NC; ++u)
#pragma unroll
        for (int v = 0; v < NC; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < NC; ++u)
#pragma unroll
    for (int v = 0; v < NC; ++v) {
      const int i = ty + 16 * u;
      const int j = tx + 16 * v;
      if (i < l && j < l) gp[i * l + j] = acc[u][v];
    }
  cluster.sync();
  // this block's band of rows, summed over the cluster's partials in rank
  // order
  const int band = (l + kGramCluster - 1) / kGramCluster;
  const int lo = (int)cluster.block_rank() * band;
  const int hi = lo + band < l ? lo + band : l;
  float* out = part + (size_t)(blockIdx.x / kGramCluster) * l * l;
  for (int e = lo * l + threadIdx.x; e < hi * l; e += kThreads) {
    float v[kGramCluster];
#pragma unroll
    for (int p = 0; p < kGramCluster; ++p)
      v[p] = cluster.map_shared_rank(gp, p)[e];
    float s = v[0];
#pragma unroll
    for (int p = 1; p < kGramCluster; ++p) s += v[p];
    out[e] = s;
  }
  cluster.sync();  // no block leaves while a peer may still read its partial
}

// Rows [lo, hi) of G = the sum of `nparts` <= kMaxParts l x l partials in
// part order, stored at row stride `ld` into the shared-memory matrix `dst`
// of cluster ranks [r_first, r_last).  The calling block's threads share
// the work, every partial of an entry loaded at once; the caller publishes
// the remote stores with a cluster barrier.
constexpr int kMaxParts = kWaveBlocks / kGramCluster;

__device__ __forceinline__ void band_sum(const float* __restrict__ part,
                                         int nparts, int l, int lo, int hi,
                                         float* dst, int ld, int r_first,
                                         int r_last) {
  constexpr int kPer = 2;   // entries a thread loads at once
  cg::cluster_group cluster = cg::this_cluster();
  const size_t ll = (size_t)l * l;
  const int n = (hi - lo) * l;
  const float* base = part + (size_t)lo * l;
  for (int e0 = threadIdx.x; e0 < n; e0 += kPer * blockDim.x) {
    float v[kPer][kMaxParts];
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int e = e0 + h * blockDim.x;
#pragma unroll
      for (int p = 0; p < kMaxParts; ++p)
        v[h][p] = (e < n && p < nparts) ? base[(size_t)p * ll + e] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int e = e0 + h * blockDim.x;
      if (e >= n) break;
      float s = v[h][0];
#pragma unroll
      for (int p = 1; p < kMaxParts; ++p)
        if (p < nparts) s += v[h][p];
      const int i = lo + e / l;
      const int c = e % l;
      for (int r = r_first; r < r_last; ++r)
        cluster.map_shared_rank(dst, r)[i * ld + c] = s;
    }
  }
}

// OUT = Y op(M), op(M) = M^T when kTransM, else M; kUpper says op(M) is
// upper-triangular (op(M)[c][i] = 0 for c > i).  Dynamic shared memory:
// op(M) as ms[c * kW + i] and one tile of Y as ys[r * kLdY + c].
template <int NC, bool kTransM, bool kUpper>
__global__ void __launch_bounds__(kThreads)
apply_rows(const float* __restrict__ y, const float* __restrict__ mat,
           float* __restrict__ out, int m, int l) {
  constexpr int kW = 16 * NC;
  constexpr int kLdY = kW + 1;   // two rows a warp, in different banks
  constexpr int kRu = kApplyRows / 16;
  extern __shared__ float smem[];
  float* ms = smem;
  float* ys = smem + kW * kW;
  // op(M) and the first tile of Y, every load in flight at once
  for (int e = threadIdx.x; e < kW * kW; e += kThreads) {
    const int i = e / kW;   // M[i][c], read along its rows
    const int c = e % kW;
    const bool ok = i < l && c < l;
    cp_async4(ms + (kTransM ? c * kW + i : e),
              ok ? mat + (size_t)i * l + c : mat, ok);
  }
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long tiles = (m + kApplyRows - 1) / kApplyRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kApplyRows;
    __syncthreads();  // the last tile's ys read
    for (int e = threadIdx.x; e < kApplyRows * l; e += kThreads) {
      const int r = e / l;
      const int c = e % l;
      const bool ok = row0 + r < m;
      cp_async4(ys + r * kLdY + c, ok ? y + row0 * l + e : y, ok);
    }
    cp_async_wait_all();
    float acc[kRu][NC] = {};
    for (int k0 = 0; k0 < l; k0 += 16) {
      const int k_end = k0 + 16 < l ? k0 + 16 : l;
      for (int k = k0; k < k_end; ++k) {
        float a[kRu];
#pragma unroll
        for (int u = 0; u < kRu; ++u) a[u] = ys[(ty + 16 * u) * kLdY + k];
#pragma unroll
        for (int v = 0; v < NC; ++v) {
          // columns 16 v .. 16 v + 15 < k0 <= k meet zeros of op(M)
          if (kUpper && 16 * v + 15 < k0) continue;
          const float b = ms[k * kW + tx + 16 * v];
#pragma unroll
          for (int u = 0; u < kRu; ++u) acc[u][v] = fmaf(a[u], b, acc[u][v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRu; ++u)
#pragma unroll
      for (int v = 0; v < NC; ++v) {
        const long long row = row0 + ty + 16 * u;
        const int i = tx + 16 * v;
        if (row < m && i < l) out[row * l + i] = acc[u][v];
      }
  }
}

// Tiled path, l > kMaxNarrow: part[s] = Y[rows of split s]^T Y[rows of
// split s], one 64 x 64 tile of G per block.
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

// Tiled path, l > kMaxNarrow: 64 x 64 tiles of OUT = Y op(M), with tiles
// of Y and op(M) staged in shared memory; an upper-triangular op(M) stops
// each tile's sum at its last column.
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

// static: every library that includes this file keeps its own flags, since
// each loads its own copy of the kernels (an inline function's static
// would be one object across the libraries of a process)
template <int NC>
static cudaError_t launch_gram_narrow(const float* y, float* part, int m,
                                      int l, const GramPlan& p,
                                      cudaStream_t s) {
  static bool done[kMaxDevices];
  auto kernel = gram_cluster<NC>;
  cudaError_t err = allow_smem_once(kernel, done);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(p.blocks), kThreads, gram_smem_bytes(l, NC), s,
                kGramCluster, y, part, m, l, p.rows_per_split);
}

// The Gram pass: p.nparts partial Grams into `part`.
inline cudaError_t launch_gram(const float* y, float* part, int m, int l,
                               const GramPlan& p, cudaStream_t s) {
  if (!p.narrow) {
    return launch(gram_partials, dim3(p.tiles, p.tiles, p.nparts), kThreads,
                  0, s, 0, y, part, m, l, p.rows_per_split);
  }
  switch (p.nc) {
    case 1: return launch_gram_narrow<1>(y, part, m, l, p, s);
    case 2: return launch_gram_narrow<2>(y, part, m, l, p, s);
    case 3: return launch_gram_narrow<3>(y, part, m, l, p, s);
    case 4: return launch_gram_narrow<4>(y, part, m, l, p, s);
    case 5: return launch_gram_narrow<5>(y, part, m, l, p, s);
    case 6: return launch_gram_narrow<6>(y, part, m, l, p, s);
    case 7: return launch_gram_narrow<7>(y, part, m, l, p, s);
    default: return launch_gram_narrow<8>(y, part, m, l, p, s);
  }
}

template <int NC, bool kTransM, bool kUpper>
static cudaError_t launch_apply_narrow(const float* y, const float* mat,
                                       float* out, int m, int l,
                                       cudaStream_t s) {
  static bool done[kMaxDevices];
  auto kernel = apply_rows<NC, kTransM, kUpper>;
  cudaError_t err = allow_smem_once(kernel, done);
  if (err != cudaSuccess) return err;
  constexpr int kW = 16 * NC;
  const size_t smem =
      sizeof(float) * ((size_t)kW * kW + (size_t)kApplyRows * (kW + 1));
  const long long tiles = (m + kApplyRows - 1) / kApplyRows;
  const int blocks = (int)(tiles < kApplyBlocksMax ? tiles : kApplyBlocksMax);
  return launch(kernel, dim3(blocks), kThreads, smem, s, 0, y, mat, out, m, l);
}

// The apply pass OUT = Y op(M); `upper` (K1's (L^-1)^T) requires kTransM.
template <bool kTransM, bool kUpper>
inline cudaError_t launch_apply(const float* y, const float* mat, float* out,
                                int m, int l, cudaStream_t s) {
  if (l > kMaxNarrow) {
    const unsigned row_tiles = (unsigned)((m + kTile - 1) / kTile);
    const unsigned col_tiles = (unsigned)((l + kTile - 1) / kTile);
    return launch(apply_right<kTransM>, dim3(row_tiles, col_tiles), kThreads,
                  0, s, 0, y, mat, out, m, l, kUpper);
  }
  switch ((l + 15) / 16) {
    case 1:
      return launch_apply_narrow<1, kTransM, kUpper>(y, mat, out, m, l, s);
    case 2:
      return launch_apply_narrow<2, kTransM, kUpper>(y, mat, out, m, l, s);
    case 3:
      return launch_apply_narrow<3, kTransM, kUpper>(y, mat, out, m, l, s);
    case 4:
      return launch_apply_narrow<4, kTransM, kUpper>(y, mat, out, m, l, s);
    case 5:
      return launch_apply_narrow<5, kTransM, kUpper>(y, mat, out, m, l, s);
    case 6:
      return launch_apply_narrow<6, kTransM, kUpper>(y, mat, out, m, l, s);
    case 7:
      return launch_apply_narrow<7, kTransM, kUpper>(y, mat, out, m, l, s);
    default:
      return launch_apply_narrow<8, kTransM, kUpper>(y, mat, out, m, l, s);
  }
}

}  // namespace panel

// Every kernel library exports this, for the wrapper's error message.
extern "C" const char* rsvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
