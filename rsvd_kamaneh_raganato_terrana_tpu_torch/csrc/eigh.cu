// Kernel K3: eigendecomposition of a small symmetric f32 matrix by
// fixed-sweep two-sided Jacobi, for Hopper (sm_90a).
//
// Replaces the TPU kernel in
//   rsvd_kamaneh_raganato_terrana_tpu/linalg/pallas_kernels.py
//   eigh_small / _eigh_kernel.
// Given G (n x n, row-major f32, symmetric, indefinite allowed) it
// returns the eigenvalues in ascending order and V (n x n, eigenvectors
// in columns), as torch.linalg.eigh does.
//
// Arithmetic (the same as the TPU kernel's, and as the plain version
// linalg/kernels.py::eigh_small_reference):
//   - an odd n is padded to an even n_pad = n + 1 with one decoupled pad
//     eigenvalue -(||G||_F + 1), strictly below every real one;
//   - sweeps * (n_pad - 1) rounds; each rotates the n_pad / 2 mirror
//     pairs (i, n_pad - 1 - i) of the logical order at once (J = I c +
//     anti s, G <- J^T G J, V <- V J), then applies the circle
//     permutation Pi of the Brent-Luk tournament;
//   - the ascending stable sort drops the pad eigenpair.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction) and rsqrtf is the function torch.rsqrt calls on the
// card, so the kernel repeats the plain version's arithmetic operation
// for operation; only the pad value's norm is summed in another order,
// and the pad eigenpair never mixes with the others.
//
// What bounds it.  At the rSVD tail's n = 80 the work is 632 rounds of
// ~57.6 kflop, 36.4 MFLOP, 0.54 us of the card's fp32 rate.  The bound is
// latency: 632 dependent rounds on one SM while the rest of the card
// idles.  Within a round the shared-memory pipe is the busiest unit: G
// and V are read and written once each (~100 KB at n = 80), plus each
// work item's rotations and slots.
//
// Design: two block barriers per round, {G blocks and V columns}
// barrier {next (c, s)} barrier.
//   - Pi is an index map, not a shuffle: after r rounds of a sweep,
//     logical index a lives in physical row and column slot(a, r), so
//     nothing moves.  A whole number of sweeps brings the map back to the
//     identity.  The slot map is advanced without a division.
//   - Entry (x, y) of J^T G J depends only on the four entries of G at
//     rows {x, x'} and columns {y, y'} (x' = n_pad - 1 - x).  So one pass
//     over the 2 x 2 blocks of G, one block (pair p, pair q) per work
//     item, forms the two column-rotated values of each row (G J, the
//     plain version's x) and then the row rotation, and stores the four
//     entries in place: the blocks are disjoint, so the column and row
//     halves of a round need no barrier between them.
//   - V's column update reads only V and the round's (c, s), so it runs
//     in the same pass as G's blocks, and the rotation phase that follows
//     is only the (c, s) chain (a division, a square root, a division, a
//     reciprocal square root) of n_pad threads.
//   - Work items are spread evenly over all threads, two at a time with
//     both loaded before either is stored, and a warp's lanes walk
//     consecutive logical indices: q for G blocks (consecutive column
//     slots up to one wrap of the circle map), the row for V, which is
//     stored transposed (V^T, a row per column slot) so that those rows
//     are consecutive too.  Each pair's (c_p, s_p, c_p', s_p') is one
//     float4 and its two slots one int2, so a G block reads its rotations
//     and slots in four loads.
// G and V live in dynamic shared memory while 2 n_pad^2 floats fit the
// block's 227 KB (n_pad <= 168), else in a device workspace that the
// wrapper allocates.  The eigenvalues' ranks (the sort) are counted in
// the block, so the whole eigendecomposition is one launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "panel.cuh"

namespace {

constexpr int kThreads = 768;  // the shortest round of 512 to 1024 on the H100
// the __syncthreads of one round of jacobi_eigh's loop, reported to logs
constexpr int kBarriersPerRound = 2;
// the opt-in shared memory of one sm_90 block
constexpr size_t kSmemMax = 232448;
constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON, 2^-23

struct Plan {
  int n_pad;
  bool in_smem;
  size_t smem_bytes;
  size_t work_floats;
};

Plan make_plan(int n) {
  Plan p;
  p.n_pad = n + (n & 1);
  const size_t nn = (size_t)p.n_pad * p.n_pad;
  // the pairs' (c, s) float4 and slot int2, lam (float), src (int), one
  // float per warp for the norm
  const size_t small = 5 * (size_t)p.n_pad + kThreads / 32 + 1;
  p.in_smem = sizeof(float) * (2 * nn + small) <= kSmemMax;
  p.smem_bytes = sizeof(float) * ((p.in_smem ? 2 * nn : 0) + small);
  p.work_floats = p.in_smem ? 0 : 2 * nn;
  return p;
}

// Physical slot of logical index a after r rounds (0 <= r < n - 1) of the
// circle permutation (perm[0] = 0, perm[1] = n - 1, perm[a] = a - 1
// otherwise): 0 stays, the others rotate by one place per round.
__device__ __forceinline__ int slot(int a, int r, int n) {
  if (a == 0) return 0;
  const int k = a - 1 - r;
  return 1 + (k < 0 ? k + n - 1 : k);
}

// x c + y s, each product rounded, then the sum
__device__ __forceinline__ float rot2(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// A walk over the items e = tid, tid + T, ... < rows * cols of a rows x
// cols grid, as (row, col) = (e / cols, e % cols) without a division.
struct Walk {
  int row, col, drow, dcol;
  __device__ Walk(int tid, int nthreads, int cols)
      : row(tid / cols), col(tid % cols), drow(nthreads / cols),
        dcol(nthreads % cols) {}
  __device__ void next(int cols) {
    col += dcol;
    row += drow;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// G and V^T in shared memory (kSmem, int offsets, so every access is a
// shared-memory instruction) or in the device workspace
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
jacobi_eigh(const float* __restrict__ g_in, float* __restrict__ lam_out,
            float* __restrict__ v_out, float* __restrict__ work, int n,
            int n_pad, int steps) {
  using Idx = typename std::conditional<kSmem, int, size_t>::type;
  extern __shared__ __align__(16) float smem[];
  const Idx nn = (Idx)n_pad * n_pad;
  const int half = n_pad / 2;
  float* gm = kSmem ? smem : work;
  float* vt = gm + nn;  // vt[slot][x] = V[x][slot]
  float4* rec = reinterpret_cast<float4*>(kSmem ? smem + 2 * nn : smem);
  int2* pos = reinterpret_cast<int2*>(rec + half);
  float* lam = reinterpret_cast<float*>(pos + half);
  int* src = reinterpret_cast<int*>(lam + n_pad);
  float* red = reinterpret_cast<float*>(src + n_pad);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  float ss = 0.f;
  for (Idx e = tid; e < nn; e += nthreads) {
    const int i = (int)(e / n_pad);
    const int j = (int)(e % n_pad);
    const float x = (i < n && j < n) ? g_in[(size_t)i * n + j] : 0.f;
    gm[e] = x;
    vt[e] = (i == j) ? 1.f : 0.f;
    ss = fmaf(x, x, ss);
  }
  if (n_pad != n) {
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < (nthreads + 31) / 32; ++w) t += red[w];
      gm[nn - 1] = -(sqrtf(t) + 1.f);  // the one pad entry, (n, n)
    }
  }
  __syncthreads();

  const float eps2 = kEps * kEps;  // 2^-46, exact
  // (c_i, s_i) of logical index i against its mirror at round r of the
  // sweep: pair p = min(i, i') keeps (c_p, s_p, c_p', s_p') and (slot p,
  // slot p')
  auto rotations = [&](int r) {
    for (int i = tid; i < n_pad; i += nthreads) {
      const int mirror = n_pad - 1 - i;
      const int a = slot(i, r, n_pad);
      const int am = slot(mirror, r, n_pad);
      const float d = gm[(Idx)a * n_pad + a];
      const float rd = gm[(Idx)am * n_pad + am];
      const float off = gm[(Idx)a * n_pad + am];
      const bool rot =
          __fmul_rn(off, off) > __fmul_rn(eps2, fabsf(__fmul_rn(d, rd)));
      const float gs = rot ? off : 1.f;
      const float tau = __fdiv_rn(__fsub_rn(rd, d), __fmul_rn(2.f, gs));
      const float sgn = tau >= 0.f ? 1.f : -1.f;
      const float root = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)));
      const float t = rot ? __fdiv_rn(sgn, __fadd_rn(fabsf(tau), root)) : 0.f;
      const float c = rsqrtf(__fadd_rn(1.f, __fmul_rn(t, t)));
      const float s = __fmul_rn(t, c);
      const int p = i < mirror ? i : mirror;
      float* rp = reinterpret_cast<float*>(rec + p);
      int* pp = reinterpret_cast<int*>(pos + p);
      const int side = i < mirror ? 0 : 1;
      rp[2 * side] = c;
      rp[2 * side + 1] = s;
      pp[side] = a;
    }
  };

  // Each thread takes its items two at a time, both loaded before either
  // is stored (items are disjoint; an odd last item is done twice, which
  // stores the same values twice).
  const Walk g_start(tid, nthreads, half);   // (p, q) blocks of G
  const Walk v_start(tid, nthreads, n_pad);  // (q, x) pairs of V^T
  int r = 0;                                 // round within the sweep
  if (steps > 0) rotations(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    // G <- J^T G J on the 2 x 2 blocks {x, x'} x {y, y'}: X = G J by
    // columns, X[x][y] = G[x][y] c_y + G[x][y'] s_y', then J^T X by rows,
    // G[x][y] = X[x][y] c_x + X[x'][y] s_x'
    for (Walk w = g_start; w.row < half;) {
      const Walk w0 = w;
      w.next(half);
      const Walk w1 = w.row < half ? w : w0;
      if (w.row < half) w.next(half);
      float4 cp[2], cq[2];
      float* gx[2];
      float* gxm[2];
      int2 sq[2];
      float g[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Walk& it = h ? w1 : w0;
        cp[h] = rec[it.row];
        cq[h] = rec[it.col];
        const int2 sp = pos[it.row];
        sq[h] = pos[it.col];
        gx[h] = gm + (Idx)sp.x * n_pad;
        gxm[h] = gm + (Idx)sp.y * n_pad;
        g[h][0] = gx[h][sq[h].x];
        g[h][1] = gx[h][sq[h].y];
        g[h][2] = gxm[h][sq[h].x];
        g[h][3] = gxm[h][sq[h].y];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 p = cp[h], q = cq[h];
        const float x00 = rot2(g[h][0], q.x, g[h][1], q.w);
        const float x01 = rot2(g[h][1], q.z, g[h][0], q.y);
        const float x10 = rot2(g[h][2], q.x, g[h][3], q.w);
        const float x11 = rot2(g[h][3], q.z, g[h][2], q.y);
        gx[h][sq[h].x] = rot2(x00, p.x, x10, p.w);
        gx[h][sq[h].y] = rot2(x01, p.x, x11, p.w);
        gxm[h][sq[h].x] = rot2(x10, p.z, x00, p.y);
        gxm[h][sq[h].y] = rot2(x11, p.z, x01, p.y);
      }
    }
    // V <- V J in the same pass: it reads only V and the round's (c, s)
    for (Walk w = v_start; w.row < half;) {
      const Walk w0 = w;
      w.next(n_pad);
      const Walk w1 = w.row < half ? w : w0;
      if (w.row < half) w.next(n_pad);
      float4 cq[2];
      float* vy[2];
      float* vym[2];
      float v[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Walk& it = h ? w1 : w0;
        cq[h] = rec[it.row];
        const int2 sq = pos[it.row];
        vy[h] = vt + (Idx)sq.x * n_pad + it.col;
        vym[h] = vt + (Idx)sq.y * n_pad + it.col;
        v[h][0] = *vy[h];
        v[h][1] = *vym[h];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *vy[h] = rot2(v[h][0], cq[h].x, v[h][1], cq[h].w);
        *vym[h] = rot2(v[h][1], cq[h].z, v[h][0], cq[h].y);
      }
    }
    __syncthreads();
    r = r + 1 == n_pad - 1 ? 0 : r + 1;  // Pi: the next round's index map
    if (step + 1 < steps) rotations(r);
    __syncthreads();
  }

  // eigenvalues in logical order; the ascending stable sort by ranks
  for (int a = tid; a < n_pad; a += nthreads) {
    const int p = slot(a, r, n_pad);
    lam[a] = gm[(Idx)p * n_pad + p];
    src[a] = 0;
  }
  __syncthreads();
  const int drop = n_pad - n;
  for (int a = tid; a < n_pad; a += nthreads) {
    const float la = lam[a];
    int rank = 0;
    for (int b = 0; b < n_pad; ++b) {
      const float lb = lam[b];
      rank += (lb < la) || (lb == la && b < a);
    }
    const int o = rank - drop;  // the pad eigenvalue ranks first
    if (o >= 0 && o < n) {
      lam_out[o] = la;
      src[o] = slot(a, r, n_pad);
    }
  }
  __syncthreads();
  for (size_t e = tid; e < (size_t)n * n; e += nthreads) {
    const int x = (int)(e / n);
    const int o = (int)(e % n);
    v_out[e] = vt[(Idx)src[o] * n_pad + x];
  }
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_eigh_small_f32 needs for an n x n G
// (0 while G and V fit in shared memory).
size_t rsvd_eigh_workspace_floats(int n) {
  if (n <= 0) return 0;
  return make_plan(n).work_floats;
}

// Block barriers in each Jacobi round, for logs.
int rsvd_eigh_barriers_per_round(void) { return kBarriersPerRound; }

// Launches the one-block eigensolver on `stream`; returns
// cudaGetLastError() (0 = launched).
int rsvd_eigh_small_f32(const float* g, float* lam, float* v, float* work,
                        int n, int sweeps, void* stream) {
  if (n <= 0) return 0;
  const Plan p = make_plan(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = p.in_smem
      ? cudaFuncSetAttribute(jacobi_eigh<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem_bytes)
      : cudaFuncSetAttribute(jacobi_eigh<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int steps = sweeps * (p.n_pad - 1);
  if (p.in_smem)
    jacobi_eigh<true><<<1, kThreads, p.smem_bytes, s>>>(g, lam, v, nullptr,
                                                        n, p.n_pad, steps);
  else
    jacobi_eigh<false><<<1, kThreads, p.smem_bytes, s>>>(g, lam, v, work, n,
                                                         p.n_pad, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
