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
// What bounds it.  At 4096^2, l = 80: 2 m n l = 2.68 GFLOP, 40.1 us of
// the card's fp32 rate, against 20.4 us for A's 64 MiB read and Y's
// write: operations.  Each Box-Muller draw costs ~100 instructions (two
// murmur3 finalizers, an accurate logf, cosf and sqrtf), so a plain tiling
// that draws every entry once per 128-row tile of Y (32 n l draws at m =
// 4096) spends about as many instruction slots on draws as on
// multiply-adds.
//
// Design.
//   - Tiles of Y are kTileM = 256 rows by 16 NC columns, NC = 1..8 a
//     template argument: 256 threads, each 16 rows x NC columns, plain
//     fp32 FMA (no TF32: the hash-drawn Omega multiplies at full f32).
//     l <= 128 is one tile of width l rounded up to 16 (80 at l = 80, no
//     padded column); a larger l is 128-wide tiles and one narrower tile,
//     a second launch, so fewer than 16 columns are padded.
//   - A block walks a slab of the contraction (k_per_split rows of Omega)
//     in chunks of kKw rows.  A thread-block cluster of kMaxCluster
//     blocks, neighbouring row tiles of one slab, shares each chunk: every
//     block draws its share of the rows into its own shared memory and,
//     after a cluster barrier, copies the rest from its peers through
//     distributed shared memory, one float4 round trip per chunk.  Each
//     Omega entry is drawn once per cluster: (m / (kMaxCluster kTileM)) n l
//     draws, 8 n l at m = 4096.  Chunks are double-buffered: chunk j + 1
//     is drawn and the cluster barrier armed before chunk j's
//     multiply-adds, and waited on after them.  Larger clusters draw less
//     but hold their blocks in lock step and fit the card less well; on
//     the H100, clusters of 2 blocks of 256 rows measured fastest.
//   - A streams through a ring of kStages stages of kTileM x kKa floats,
//     loaded with 16-byte cp.async (4-byte when n % 4 != 0), so the next
//     stages arrive while the current one is multiplied; each thread reads
//     its rows as float4 along k (conflict-free: rows padded to kKa + 4).
//   - Splits of the contraction supply the parallelism: as many as fill
//     the card with one wave of clusters (cudaOccupancyMaxActiveClusters,
//     asked once), at least kMinSplitDepth deep; 8 splits of 512 at
//     4096^2 x 80, 128 blocks.  Each split writes its own partial Y into
//     the workspace and a second launch sums them in split order:
//     deterministic, no atomics.
//   - A 3xTF32 variant of the same kernel (kTc: each operand split into
//     two TF32 terms, three mma.sync products per pair) is built for one
//     tile width and only measured beside this one (its time, recovered-
//     Omega ulps and Y error); the package never calls it.
// Ragged m, n and l are masked in the kernel (cp.async zero-fills); A is
// never padded in device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "panel.cuh"

namespace cg = cooperative_groups;

namespace {

using rsvd_hash::mix;

constexpr int kTx = 16;          // threads along the columns of a tile
constexpr int kTy = 16;          // threads along its rows
constexpr int kRu = 16;          // rows of a thread: ty + kTy u, u < kRu
constexpr int kThreads = kTx * kTy;
constexpr int kTileM = kTy * kRu;
constexpr int kKa = 32;          // depth of one A stage
constexpr int kStages = 3;       // the A ring
constexpr int kLdA = kKa + 4;    // padded row of a stage, in floats
constexpr int kKw = 64;          // depth of one Omega chunk
constexpr int kSpc = kKw / kKa;  // A stages per Omega chunk
static_assert(kKw * 16 / 4 % kThreads == 0,
              "a chunk's float4 spread evenly over the threads");
constexpr int kMaxCluster = 2;   // blocks of a cluster, at most
constexpr int kMinSplitDepth = 256;
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

// `bytes` of 16 (or 4) copied from src, the rest of the 16 (4) zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the split cluster barrier: arrive publishes this block's shared-memory
// writes, wait returns once every block of the cluster has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 3xTF32 (measured only, never the default): x = hi + lo with hi and lo
// TF32 (cvt.rna), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi on the
// tensor cores (mma.sync m16n8k8, f32 accumulate).  A warp owns 32 rows
// of the tile (two m16 tiles) by all 16 NC columns (2 NC n8 tiles); its
// 16 NC accumulators per thread reuse acc[16][NC] as a flat array.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// accumulator i of n8 tile nt of m16 tile mt in acc[16][NC]
template <int NC>
__device__ __forceinline__ float& acc_at(float (&acc)[kRu][NC], int mt,
                                         int nt, int i) {
  const int f = (mt * 2 * NC + nt) * 4 + i;
  return acc[f / NC][f % NC];
}

// one kKa-deep stage: at is the tile's A stage, wt the matching kKa rows
// of the Omega chunk (16 NC wide)
template <int NC>
__device__ __forceinline__ void mma_stage(const float* at, const float* wt,
                                          float (&acc)[kRu][NC], int tid) {
  constexpr int kBn = 16 * NC;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
#pragma unroll
  for (int k8 = 0; k8 < kKa; k8 += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* ar = at + (32 * warp + 16 * mt + g) * kLdA + k8 + t;
      const float x[4] = {ar[0], ar[8 * kLdA], ar[4], ar[8 * kLdA + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], ah[mt][i], al[mt][i]);
    }
#pragma unroll
    for (int nt = 0; nt < 2 * NC; ++nt) {
      const float* br = wt + (k8 + t) * kBn + 8 * nt + g;
      uint32_t bh[2], bl[2];
      split_tf32(br[0], bh[0], bl[0]);
      split_tf32(br[4 * kBn], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = acc_at<NC>(acc, mt, nt, i);
        mma_tf32(c, al[mt], bh);
        mma_tf32(c, ah[mt], bl);
        mma_tf32(c, ah[mt], bh);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_at<NC>(acc, mt, nt, i) = c[i];
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void mma_store(float (&acc)[kRu][NC], float* dst,
                                          int m, int l, int r0, int c0,
                                          int tid) {
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NC; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 32 * warp + 16 * mt + g + 8 * (i / 2);
        const int col = c0 + 8 * nt + 2 * t + i % 2;
        if (row < m && col < l)
          dst[(size_t)row * l + col] = acc_at<NC>(acc, mt, nt, i);
      }
}

template <int NC>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kStages * kTileM * kLdA + 2 * kKw * 16 * NC);
}

// out[y] = A[:, split y] Omega[split y, c0 : c0 + 16 NC] for the block's
// 256-row tile, c0 = c_base + 128 blockIdx.z; one block per SM (even NC = 1
// holds 118 KB of shared memory).  kTc: the 3xTF32 tensor-core variant.
template <int NC, bool kVec, bool kTc>
__global__ void __launch_bounds__(kThreads, 1)
sketch_cluster(const float* __restrict__ a, float* __restrict__ out, int m,
               int n, int l, int c_base, uint32_t l_pad, uint32_t seed_mix,
               int k_per_split) {
  constexpr int kBn = 16 * NC;
  constexpr int kNc = kBn / kTx;  // columns of a thread: tx + kTx v, v < kNc
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                            // [kStages][kTileM][kLdA]
  float* ws = smem + kStages * kTileM * kLdA;  // [2][kKw][kBn]
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int r0 = blockIdx.x * kTileM;
  const int c0 = c_base + blockIdx.z * 128;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(n, k_begin + k_per_split);
  const int nstages = (k_end - k_begin + kKa - 1) / kKa;
  const int nchunks = (k_end - k_begin + kKw - 1) / kKw;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const int own_rows = kKw / (int)csize;  // rows of a chunk each block draws

  // this block's rows of Omega chunk j, into buffer j % 2
  auto draw = [&](int j) {
    float* w = ws + (j & 1) * kKw * kBn + rank * own_rows * kBn;
    const int kb = k_begin + j * kKw + rank * own_rows;
    for (int e = tid; e < own_rows * kBn; e += kThreads) {
      const int krow = kb + e / kBn;
      const int col = c0 + e % kBn;
      w[e] = (krow < k_end && col < l)
                 ? omega_at((uint32_t)krow, (uint32_t)col, l_pad, seed_mix)
                 : 0.f;
    }
  };
  // the peers' rows of chunk j, from their shared memory into ours: each
  // thread starts its kGather float4 loads before any store, so a chunk
  // costs one round trip through the cluster
  auto gather = [&](int j) {
    constexpr int kGather = kKw * kBn / 4 / kThreads;
    float4* w = reinterpret_cast<float4*>(ws + (j & 1) * kKw * kBn);
    const int per_rank = own_rows * kBn / 4;
    float4 got[kGather];
#pragma unroll
    for (int i = 0; i < kGather; ++i) {
      const int f = tid + i * kThreads;
      const unsigned src = f / per_rank;
      if (src != rank) got[i] = cluster.map_shared_rank(w, src)[f];
    }
#pragma unroll
    for (int i = 0; i < kGather; ++i) {
      const int f = tid + i * kThreads;
      if (f / per_rank != (int)rank) w[f] = got[i];
    }
  };
  // stage s of A (kKa columns from k_begin + s kKa) into ring slot s % kStages
  auto load_a = [&](int s) {
    float* dst = as + (s % kStages) * kTileM * kLdA;
    const int kb = k_begin + s * kKa;
    if (kVec) {
      for (int e = tid; e < kTileM * kKa / 4; e += kThreads) {
        const int rr = e / (kKa / 4);
        const int k = kb + e % (kKa / 4) * 4;
        const int row = r0 + rr;
        const int bytes = (row < m && k < k_end) ? 4 * min(4, k_end - k) : 0;
        cp_async16(dst + rr * kLdA + (k - kb),
                   bytes ? a + (size_t)row * n + k : a, bytes);
      }
    } else {
      for (int e = tid; e < kTileM * kKa; e += kThreads) {
        const int rr = e / kKa;
        const int k = kb + e % kKa;
        const int row = r0 + rr;
        const int bytes = (row < m && k < k_end) ? 4 : 0;
        cp_async4(dst + rr * kLdA + (k - kb),
                  bytes ? a + (size_t)row * n + k : a, bytes);
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load_a(s);
    cp_async_commit();
  }
  draw(0);
  cluster_arrive();
  cluster_wait();
  gather(0);

  float acc[kRu][kNc] = {};
  for (int s = 0; s < nstages; ++s) {
    const int j = s / kSpc;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s and chunk j are in; slot s - 1 is free
    if (s + kStages - 1 < nstages) load_a(s + kStages - 1);
    cp_async_commit();
    const bool next = s % kSpc == 0 && j + 1 < nchunks;
    if (next) {
      draw(j + 1);
      cluster_arrive();
    }
    const float* at = as + (s % kStages) * kTileM * kLdA;
    const float* wt = ws + (j & 1) * kKw * kBn + (s % kSpc) * kKa * kBn;
    if constexpr (kTc) {
      mma_stage<NC>(at, wt, acc, tid);
    } else {
#pragma unroll
    for (int k4 = 0; k4 < kKa; k4 += 4) {
      float4 av[kRu];
#pragma unroll
      for (int u = 0; u < kRu; ++u)
        av[u] = *reinterpret_cast<const float4*>(at + (ty + kTy * u) * kLdA +
                                                 k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[kNc];
#pragma unroll
        for (int v = 0; v < kNc; ++v)
          wv[v] = wt[(k4 + kk) * kBn + tx + kTx * v];
#pragma unroll
        for (int u = 0; u < kRu; ++u) {
          const float x = kk == 0   ? av[u].x
                          : kk == 1 ? av[u].y
                          : kk == 2 ? av[u].z
                                    : av[u].w;
#pragma unroll
          for (int v = 0; v < kNc; ++v) acc[u][v] = fmaf(x, wv[v], acc[u][v]);
        }
      }
    }
    }
    if (s % kSpc == kSpc - 1 && j + 1 < nchunks) {
      cluster_wait();
      gather(j + 1);
    }
  }

  if constexpr (kTc) {
    if (r0 < m)
      mma_store<NC>(acc, out + (size_t)blockIdx.y * m * l, m, l, r0, c0, tid);
  } else if (r0 < m) {
    float* dst = out + (size_t)blockIdx.y * m * l;
#pragma unroll
    for (int u = 0; u < kRu; ++u) {
      const int row = r0 + ty + kTy * u;
      if (row >= m) continue;
#pragma unroll
      for (int v = 0; v < kNc; ++v) {
        const int col = c0 + tx + kTx * v;
        if (col < l) dst[(size_t)row * l + col] = acc[u][v];
      }
    }
  }
  cluster.sync();  // no block leaves while a peer may still read its chunks
}

struct Plan {
  int row_tiles;    // kTileM-row tiles of Y
  int cluster;      // blocks of a cluster along the rows: 1 or 2
  int grid_x;       // row_tiles rounded up to a multiple of cluster
  int full_tiles;   // 128-wide column tiles
  int rem_nc;       // NC of the narrower last column tile, 0 if none
  int nsplit;
  int k_per_split;  // a multiple of kKw
};

// Clusters of sketch_cluster<NC, true> (cluster blocks each) that the card
// holds at once, asked of the runtime once per process
template <int NC>
int active_clusters(int cluster) {
  static int cached[kMaxCluster + 1] = {};
  if (cached[cluster] == 0) {
    auto kernel = sketch_cluster<NC, true, false>;
    constexpr size_t smem = smem_bytes<NC>();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) != cudaSuccess)
      (void)cudaGetLastError();  // clear it: the launch reports real faults
    cached[cluster] = count > 0 ? count : 1;
  }
  return cached[cluster];
}

int active_clusters_nc(int nc, int cluster) {
  switch (nc) {
    case 1: return active_clusters<1>(cluster);
    case 2: return active_clusters<2>(cluster);
    case 3: return active_clusters<3>(cluster);
    case 4: return active_clusters<4>(cluster);
    case 5: return active_clusters<5>(cluster);
    case 6: return active_clusters<6>(cluster);
    case 7: return active_clusters<7>(cluster);
    default: return active_clusters<8>(cluster);
  }
}

Plan make_plan(int m, int n, int l) {
  Plan p;
  p.row_tiles = (m + kTileM - 1) / kTileM;
  p.cluster = 1;
  while (2 * p.cluster <= kMaxCluster && 2 * p.cluster <= p.row_tiles)
    p.cluster *= 2;
  p.grid_x = (p.row_tiles + p.cluster - 1) / p.cluster * p.cluster;
  p.full_tiles = l / 128;
  p.rem_nc = (l % 128 + 15) / 16;
  // as many splits as fill the card in one wave of clusters (the wider
  // launch's), at least kMinSplitDepth deep
  const int wide_nc = p.full_tiles > 0 ? 8 : p.rem_nc;
  const int per_split =
      p.grid_x / p.cluster * (p.full_tiles > 0 ? p.full_tiles : 1);
  int want = active_clusters_nc(wide_nc, p.cluster) / per_split;
  const int most = (n + kMinSplitDepth - 1) / kMinSplitDepth;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int per = (n + want - 1) / want;
  p.k_per_split = (per + kKw - 1) / kKw * kKw;
  p.nsplit = (n + p.k_per_split - 1) / p.k_per_split;
  return p;
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// y = sum of the nsplit partials, in split order; T = float4 when the
// partials' length is a multiple of 4
template <typename T>
__global__ void sum_splits(const T* __restrict__ part, T* __restrict__ y,
                           size_t count, int nsplit) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    T s = part[e];
    for (int z = 1; z < nsplit; ++z) s = add(s, part[(size_t)z * count + e]);
    y[e] = s;
  }
}

template <typename T>
void launch_sum(const float* work, float* y, size_t floats, int nsplit,
                cudaStream_t stream) {
  const size_t count = floats * sizeof(float) / sizeof(T);
  size_t blocks = (count + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits<T><<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const T*>(work), reinterpret_cast<T*>(y), count,
      nsplit);
}

struct Args {
  const float* a;
  float* out;
  int m, n, l;
  uint32_t l_pad, seed_mix;
  cudaStream_t stream;
};

template <int NC, bool kVec, bool kTc = false>
cudaError_t launch(const Plan& p, const Args& g, int col_tiles, int c_base) {
  auto kernel = sketch_cluster<NC, kVec, kTc>;
  constexpr size_t smem = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid_x, p.nsplit, col_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, g.a, g.out, g.m, g.n, g.l, c_base,
                            g.l_pad, g.seed_mix, p.k_per_split);
}

template <bool kVec>
cudaError_t launch_nc(int nc, const Plan& p, const Args& g, int col_tiles,
                      int c_base) {
  switch (nc) {
    case 1: return launch<1, kVec>(p, g, col_tiles, c_base);
    case 2: return launch<2, kVec>(p, g, col_tiles, c_base);
    case 3: return launch<3, kVec>(p, g, col_tiles, c_base);
    case 4: return launch<4, kVec>(p, g, col_tiles, c_base);
    case 5: return launch<5, kVec>(p, g, col_tiles, c_base);
    case 6: return launch<6, kVec>(p, g, col_tiles, c_base);
    case 7: return launch<7, kVec>(p, g, col_tiles, c_base);
    default: return launch<8, kVec>(p, g, col_tiles, c_base);
  }
}

cudaError_t launch_tiles(int nc, bool vec, const Plan& p, const Args& g,
                         int col_tiles, int c_base) {
  return vec ? launch_nc<true>(nc, p, g, col_tiles, c_base)
             : launch_nc<false>(nc, p, g, col_tiles, c_base);
}

// Y = A Omega(seed): the plan's launches, then the split sum.  tc: the
// 3xTF32 variant, built for one tile width only (l = 65..80, 16-byte A
// loads: the shapes it is measured at); elsewhere it refuses.
int sketch(const float* a, float* y, float* work, int m, int n, int l,
           uint32_t seed, void* stream, bool tc) {
  if (m <= 0 || n <= 0 || l <= 0) return 0;
  const Plan p = make_plan(m, n, l);
  Args g;
  g.a = a;
  g.out = p.nsplit > 1 ? work : y;
  g.m = m;
  g.n = n;
  g.l = l;
  g.l_pad = l <= 128 ? 128u : (uint32_t)((l + 127) / 128 * 128);
  g.seed_mix = mix(seed);
  g.stream = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  cudaError_t err = cudaSuccess;
  if (tc) {
    if (p.full_tiles > 0 || p.rem_nc != 5 || !vec)
      return (int)cudaErrorInvalidValue;
    err = launch<5, true, true>(p, g, 1, 0);
  } else {
    if (p.full_tiles > 0) err = launch_tiles(8, vec, p, g, p.full_tiles, 0);
    if (err == cudaSuccess && p.rem_nc > 0)
      err = launch_tiles(p.rem_nc, vec, p, g, 1, 128 * p.full_tiles);
  }
  if (err != cudaSuccess) return (int)err;
  if (p.nsplit > 1) {
    const size_t floats = (size_t)m * l;
    if (floats % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0)
      launch_sum<float4>(work, y, floats, p.nsplit, g.stream);
    else
      launch_sum<float>(work, y, floats, p.nsplit, g.stream);
  }
  return (int)cudaGetLastError();
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

// The launch plan at (m, n, l), for logs: out[0..6] = blocks of a
// cluster, contraction splits, rows of Omega per split, blocks launched,
// columns of the tiles, padded ones among them, Omega draws per call
// (each entry once per cluster).
void rsvd_sketch_plan(int m, int n, int l, long long* out) {
  for (int i = 0; i < 7; ++i) out[i] = 0;
  if (m <= 0 || n <= 0 || l <= 0) return;
  const Plan p = make_plan(m, n, l);
  const int col_tiles = p.full_tiles + (p.rem_nc > 0);
  const long long width = 128LL * p.full_tiles + 16LL * p.rem_nc;
  out[0] = p.cluster;
  out[1] = p.nsplit;
  out[2] = p.k_per_split;
  out[3] = (long long)p.grid_x * p.nsplit * col_tiles;
  out[4] = width;
  out[5] = width - l;
  out[6] = (long long)(p.grid_x / p.cluster) * n * l;
}

// Launches Y = A Omega(seed) on `stream`; returns the first CUDA error (0 =
// launched).  `seed` is the seed's two's-complement uint32.
int rsvd_sketch_f32(const float* a, float* y, float* work, int m, int n,
                    int l, uint32_t seed, void* stream) {
  return sketch(a, y, work, m, n, l, seed, stream, false);
}

// The same Y through the 3xTF32 tensor-core variant, measured against
// rsvd_sketch_f32 and never called by the package; l = 65..80 and n % 4
// == 0 with a 16-byte aligned A only, else cudaErrorInvalidValue.
int rsvd_sketch_f32_3xtf32(const float* a, float* y, float* work, int m,
                           int n, int l, uint32_t seed, void* stream) {
  return sketch(a, y, work, m, n, l, seed, stream, true);
}

}  // extern "C"
