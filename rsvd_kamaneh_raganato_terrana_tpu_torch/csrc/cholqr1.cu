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
//   (a) the Gram pass (panel.cuh): l <= 128 is one l-wide tile of G per
//       block over row splits sized to one wave of SMs, the partials of
//       each 8-block cluster added through distributed shared memory;
//   (b) eliminate_cluster, l <= 128: a cluster of kSumCluster blocks.
//       Each block sums a band of rows of G from the Gram's partials in
//       part order and stores it into the shared memory of rank 0; after
//       one cluster barrier the other ranks leave and rank 0 (16 warps)
//       runs the l steps of the augmented elimination of the TPU kernel's
//       `step` on M = [G | I] (l x 2l) held in REGISTERS: row i belongs
//       to warp i mod 16, its columns c = lane + 32 t to the lanes.  At
//       step j the warp that owns row j + 1 updates it with the
//       normalized row j from a shared buffer (the multiplier M[j+1][j]
//       by shuffle from the lane that holds column j), normalizes it (the
//       pivot by shuffle, its rsqrt) and writes it to the other buffer;
//       then every warp updates its rows below j + 1 the same way.
//       Buffers alternate with the parity of j, so a step costs ONE block
//       barrier.  The left half ends as R and the right half as L^{-1},
//       written from registers.  l > 128 keeps the one-block elimination
//       over M in the workspace (eliminate_wide), two barriers a step.
//   (c) the apply pass (panel.cuh): Q = Y (L^{-1})^T with (L^{-1})^T
//       staged in shared memory once per block; its upper triangle lets
//       each 16-column group stop its sum at its last column.
// All arithmetic is plain fp32 FMA: no TF32, no tensor cores, matching
// Precision.HIGHEST in the Pallas kernel.  A non-positive pivot (rank-
// deficient Y) gives inf/NaN with no clamp, which is the cholqr1 contract.
// Every sum runs in an order fixed by (m, l): no atomics, deterministic.
//
// What bounds it.  At the main path's 4096 x 80 the work is ~53 MFLOP in
// (a) and (c) and ~0.5 MFLOP in (b): 0.8 us at the card's fp32 rate.  The
// bound is latency: the l dependent steps of (b) on one SM, each a chain
// of shared loads, two shuffles, an rsqrt and a block barrier, with ~180
// shared-memory and shuffle instructions a step through one SM's pipe;
// and three launches.  Measured on the H100, 16 warps beat 8 and 32, and
// a barrier-free variant (each warp on its own, pivot rows in a flagged
// ring) was slower.

#include <cuda_runtime.h>

#include <cstddef>

#include "panel.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kElimThreads = 512;
constexpr int kElimWarps = kElimThreads / 32;   // a power of 2
constexpr int kWideThreads = 1024;   // eliminate_wide
constexpr int kSumCluster = 8;     // blocks that share the split sum
// a pivot-row buffer: 32 kCols <= 256 columns, then d at its last float
constexpr int kBufStride = 2 * panel::kMaxNarrow + 4;

struct Plan {
  panel::GramPlan gram;
  size_t part_floats;
  size_t linv_off;
  size_t m_off;          // eliminate_wide: M (l x 2l) in the workspace
  size_t total_floats;
  size_t smem_bytes;     // of the elimination
};

Plan make_plan(int m, int l) {
  Plan p;
  p.gram = panel::make_gram_plan(m, l);
  const size_t ll = (size_t)l * l;
  p.part_floats = (size_t)p.gram.nparts * ll;
  p.linv_off = p.part_floats;
  p.m_off = p.linv_off + ll;
  const bool narrow = l <= panel::kMaxNarrow;
  p.total_floats = p.m_off + (narrow ? 0 : 2 * ll);
  // narrow: G (l x l) and the two pivot-row buffers; wide: rown and mult
  p.smem_bytes = sizeof(float) * (narrow ? ll + 2 * kBufStride
                                         : (size_t)(2 * l + 1));
  return p;
}

// (b), l <= 128: kCols = ceil(l / 16) columns a lane (2 l columns over 32
// lanes), kRows rows a warp (l <= 16 kCols rows over kElimWarps warps).
template <int kCols>
__global__ void __launch_bounds__(kElimThreads, 1)
eliminate_cluster(const float* __restrict__ part, int nparts,
                  float* __restrict__ r, float* __restrict__ linv, int l) {
  constexpr int kRows = (16 * kCols + kElimWarps - 1) / kElimWarps;
  extern __shared__ float smem[];
  float* g = smem;                       // l x l, rank 0's is summed into
  float* buf = smem + l * l;             // two [pivot row | pad | d] buffers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int band = (l + kSumCluster - 1) / kSumCluster;
  const int lo = rank * band < l ? rank * band : l;
  const int hi = lo + band < l ? lo + band : l;
  panel::cluster_arrive_relaxed();       // every block has started
  panel::cluster_wait();
  panel::band_sum(part, nparts, l, lo, hi, g, l, 0, 1);
  panel::cluster_barrier();
  if (rank != 0) return;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = 2 * l;
  float x[kRows][kCols];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = warp + kElimWarps * q;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      float v = 0.f;
      if (i < l) {
        if (c < l) v = g[i * l + c];
        else if (c < w) v = (c - l == i) ? 1.f : 0.f;
      }
      x[q][t] = v;
    }
  }
  // row 0, normalized, into buffer 0
  if (warp == 0) {
    const float d = rsqrtf(__shfl_sync(0xffffffffu, x[0][0], 0));
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      x[0][t] *= d;
      buf[lane + 32 * t] = x[0][t];
    }
    if (lane == 0) buf[kBufStride - 1] = d;
  }
  __syncthreads();

  // Column j lies in register slot j >> 5 of every lane: the steps run in
  // chunks of 32 that share one slot, known at compile time.  At step j
  // the warp that owns row j + 1 updates it, normalizes it and writes it
  // to the other buffer first; then every warp updates its rows below
  // j + 1, all of them at once (a row at or above j + 1 takes the
  // multiplier 0, which leaves it as it is).
#pragma unroll
  for (int tj = 0; tj < (kCols + 1) / 2; ++tj) {
    const int j_end = 32 * tj + 32 < l ? 32 * tj + 32 : l;
    for (int j = 32 * tj; j < j_end; ++j) {
      const float* rb = buf + (j & 1) * kBufStride;
      float* nb = buf + ((j + 1) & 1) * kBufStride;
      const float d = rb[kBufStride - 1];
      float rn[kCols];
#pragma unroll
      for (int t = 0; t < kCols; ++t) rn[t] = rb[lane + 32 * t];
      if (warp == ((j + 1) & (kElimWarps - 1)) && j + 1 < l) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (warp + kElimWarps * q != j + 1) continue;
          const float f = __shfl_sync(0xffffffffu, x[q][tj], j & 31) * d;
#pragma unroll
          for (int t = 0; t < kCols; ++t) x[q][t] = fmaf(-f, rn[t], x[q][t]);
          float piv = x[q][tj];
          if ((j & 31) == 31) piv = x[q][tj + 1 < kCols ? tj + 1 : tj];
          const float dn = rsqrtf(__shfl_sync(0xffffffffu, piv, (j + 1) & 31));
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            x[q][t] *= dn;
            nb[lane + 32 * t] = x[q][t];
          }
          if (lane == 0) nb[kBufStride - 1] = dn;
        }
      }
      // the whole row: left of column j + 1 the row is eliminated (never
      // read again; R keeps the upper triangle), and right of l + j the
      // pivot row is exactly 0, so those columns keep their values
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = warp + kElimWarps * q;
        const float m = __shfl_sync(0xffffffffu, x[q][tj], j & 31);
        const float f = (i > j + 1 && i < l) ? m * d : 0.f;
#pragma unroll
        for (int t = 0; t < kCols; ++t) x[q][t] = fmaf(-f, rn[t], x[q][t]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = warp + kElimWarps * q;
    if (i >= l) continue;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      if (c < l) r[(size_t)i * l + c] = c >= i ? x[q][t] : 0.f;
      else if (c < w) linv[(size_t)i * l + c - l] = c - l <= i ? x[q][t] : 0.f;
    }
  }
}

// (b), l > 128: ONE block sums the partials in part order into M = [G | I]
// (l x 2l) in the workspace and runs the l elimination steps there.
__global__ void __launch_bounds__(kWideThreads)
eliminate_wide(const float* __restrict__ part, int nparts,
               float* __restrict__ r, float* __restrict__ linv,
               float* __restrict__ mm, int l) {
  extern __shared__ float smem[];
  const int w = 2 * l;
  const size_t ll = (size_t)l * l;
  float* rown = smem;         // l + 1 floats
  float* mult = smem + l + 1;  // l floats

  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    const int i = (int)(e / l);
    const int c = (int)(e % l);
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += part[(size_t)p * ll + e];
    mm[(size_t)i * w + c] = s;
    mm[(size_t)i * w + l + c] = (i == c) ? 1.f : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < l; ++j) {
    const float* pivot_row = mm + (size_t)j * w;
    const float d = rsqrtf(pivot_row[j]);
    for (int cc = threadIdx.x; cc <= l; cc += blockDim.x)
      rown[cc] = pivot_row[j + cc] * d;
    for (int i = j + 1 + threadIdx.x; i < l; i += blockDim.x)
      mult[i] = mm[(size_t)i * w + j] * d;
    __syncthreads();
    for (int i = j + 1 + warp; i < l; i += kWideThreads / 32) {
      float* row = mm + (size_t)i * w + j;
      const float f = mult[i];
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

template <int kCols>
cudaError_t launch_eliminate_narrow(const Plan& p, const float* part,
                                    float* r, float* linv, int l,
                                    cudaStream_t s) {
  static bool done[panel::kMaxDevices];
  auto kernel = eliminate_cluster<kCols>;
  cudaError_t err = panel::allow_smem_once(kernel, done);
  if (err != cudaSuccess) return err;
  return panel::launch(kernel, dim3(kSumCluster), kElimThreads, p.smem_bytes,
                       s, kSumCluster, part, p.gram.nparts, r, linv, l);
}

cudaError_t launch_eliminate(const Plan& p, const float* part, float* r,
                             float* linv, float* work, int l,
                             cudaStream_t s) {
  if (l > panel::kMaxNarrow) {
    static bool done[panel::kMaxDevices];
    cudaError_t err = panel::allow_smem_once(eliminate_wide, done);
    if (err != cudaSuccess) return err;
    return panel::launch(eliminate_wide, dim3(1), kWideThreads, p.smem_bytes,
                         s, 0, part, p.gram.nparts, r, linv, work + p.m_off,
                         l);
  }
  switch ((l + 15) / 16) {
    case 1: return launch_eliminate_narrow<1>(p, part, r, linv, l, s);
    case 2: return launch_eliminate_narrow<2>(p, part, r, linv, l, s);
    case 3: return launch_eliminate_narrow<3>(p, part, r, linv, l, s);
    case 4: return launch_eliminate_narrow<4>(p, part, r, linv, l, s);
    case 5: return launch_eliminate_narrow<5>(p, part, r, linv, l, s);
    case 6: return launch_eliminate_narrow<6>(p, part, r, linv, l, s);
    case 7: return launch_eliminate_narrow<7>(p, part, r, linv, l, s);
    default: return launch_eliminate_narrow<8>(p, part, r, linv, l, s);
  }
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_cholqr1_f32 needs for an m x l panel.
size_t rsvd_cholqr1_workspace_floats(int m, int l) {
  if (m <= 0 || l <= 0) return 0;
  return make_plan(m, l).total_floats;
}

// K1's plan at (m, l): out = {narrow path (1) or wide (0), Gram blocks,
// rows per split, partial Grams, elimination shared-memory bytes}.
void rsvd_cholqr1_plan(int m, int l, long long* out) {
  const Plan p = make_plan(m, l);
  out[0] = p.gram.narrow;
  out[1] = p.gram.narrow
               ? p.gram.blocks
               : (long long)p.gram.tiles * p.gram.tiles * p.gram.nparts;
  out[2] = p.gram.rows_per_split;
  out[3] = p.gram.nparts;
  out[4] = (long long)p.smem_bytes;
}

// Launches (a)-(c) on `stream`; returns the first CUDA error (0 = all
// three launched).
int rsvd_cholqr1_f32(const float* y, float* q, float* r, float* work, int m,
                     int l, void* stream) {
  if (m <= 0 || l <= 0) return 0;
  const Plan p = make_plan(m, l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = work;
  float* linv = work + p.linv_off;
  cudaError_t err = panel::launch_gram(y, part, m, l, p.gram, s);
  if (err == cudaSuccess) err = launch_eliminate(p, part, r, linv, work, l, s);
  // Q = Y (L^{-1})^T; (L^{-1})^T is upper-triangular
  if (err == cudaSuccess)
    err = panel::launch_apply<true, true>(y, linv, q, m, l, s);
  return (int)err;
}

}  // extern "C"
