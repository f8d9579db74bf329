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
// The TPU kernel builds J and Pi as dense n_pad x n_pad matrices and
// spends four MXU products per round on them.  Here a round touches only
// the rotated entries, about 9 n_pad^2 flops for G and V:
//   (a) one thread per logical index i computes (c_i, s_i) with the TPU
//       kernel's formulas (the `do` test, tau, t, c = rsqrt(1 + t^2));
//   (b) the two columns of every pair, in G and in V;
//   (c) the two rows of every pair, in G.
// Pi is an index map, not a shuffle: after r rounds of a sweep, logical
// index a lives in physical row and column slot(a, r), so nothing moves.
// A whole number of sweeps brings the map back to the identity.  Step
// (a) writes the round's slots into a table in shared memory, and (b)
// and (c) walk rows with whole warps, so no work item divides.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction) and rsqrtf is the function torch.rsqrt calls on the
// card, so the kernel repeats the plain version's arithmetic operation
// for operation; only the pad value's norm is summed in another order,
// and the pad eigenpair never mixes with the others.
//
// G and V live in dynamic shared memory while 2 n_pad^2 floats fit the
// block's 227 KB (n_pad <= 168), else in a device workspace that the
// wrapper allocates.  The eigenvalues' ranks (the sort) are counted in
// the block, so the whole eigendecomposition is one launch.
//
// What bounds it.  At the rSVD tail's n = 80 the work is 632 rounds of
// ~57.6 kflop, 36.4 MFLOP, 0.54 us of the card's fp32 rate.  The bound is
// latency: 632 dependent rounds of three block barriers each, on one SM
// while the rest of the card idles.  Spreading a round over a cluster, or
// fewer barriers per round, is left to a later change.

#include <cuda_runtime.h>

#include <cstddef>

#include "panel.cuh"

namespace {

constexpr int kThreads = 512;
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
  // c, s, lam (floats), src and pos (ints), one float per warp for the
  // norm
  const size_t small = 5 * (size_t)p.n_pad + kThreads / 32;
  p.in_smem = sizeof(float) * (2 * nn + small) <= kSmemMax;
  p.smem_bytes = sizeof(float) * ((p.in_smem ? 2 * nn : 0) + small);
  p.work_floats = p.in_smem ? 0 : 2 * nn;
  return p;
}

// Physical slot of logical index a after r rounds of the circle
// permutation (perm[0] = 0, perm[1] = n - 1, perm[a] = a - 1 otherwise):
// 0 stays, the others rotate by one place per round.
__device__ __forceinline__ int slot(int a, int r, int n) {
  if (a == 0) return 0;
  int k = (a - 1 - r) % (n - 1);
  if (k < 0) k += n - 1;
  return 1 + k;
}

__global__ void __launch_bounds__(kThreads)
jacobi_eigh(const float* __restrict__ g_in, float* __restrict__ lam_out,
            float* __restrict__ v_out, float* work, int n, int n_pad,
            int steps) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n_pad * n_pad;
  float* gm = work ? work : smem;
  float* vm = work ? work + nn : smem + nn;
  float* cs = work ? smem : smem + 2 * nn;
  float* sn = cs + n_pad;
  float* lam = sn + n_pad;
  int* src = reinterpret_cast<int*>(lam + n_pad);
  int* pos = src + n_pad;  // the round's slot of each logical index
  float* red = reinterpret_cast<float*>(pos + n_pad);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  float ss = 0.f;
  for (size_t e = tid; e < nn; e += nthreads) {
    const int i = (int)(e / n_pad);
    const int j = (int)(e % n_pad);
    const float x = (i < n && j < n) ? g_in[(size_t)i * n + j] : 0.f;
    gm[e] = x;
    vm[e] = (i == j) ? 1.f : 0.f;
    ss = fmaf(x, x, ss);
  }
  if (n_pad != n) {
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < nthreads / 32; ++w) t += red[w];
      gm[nn - 1] = -(sqrtf(t) + 1.f);  // the one pad entry, (n, n)
    }
  }
  __syncthreads();

  const int half = n_pad / 2;
  const float eps2 = kEps * kEps;  // 2^-46, exact
  int r = 0;                       // round within the sweep
  for (int step = 0; step < steps; ++step) {
    // (a) rotation (c_i, s_i) of logical index i against its mirror
    for (int i = tid; i < n_pad; i += nthreads) {
      const int a = slot(i, r, n_pad);
      const int b = slot(n_pad - 1 - i, r, n_pad);
      pos[i] = a;
      const float d = gm[(size_t)a * n_pad + a];
      const float rd = gm[(size_t)b * n_pad + b];
      const float off = gm[(size_t)a * n_pad + b];
      const bool rot =
          __fmul_rn(off, off) > __fmul_rn(eps2, fabsf(__fmul_rn(d, rd)));
      const float gs = rot ? off : 1.f;
      const float tau = __fdiv_rn(__fsub_rn(rd, d), __fmul_rn(2.f, gs));
      const float sgn = tau >= 0.f ? 1.f : -1.f;
      const float root = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)));
      const float t = rot ? __fdiv_rn(sgn, __fadd_rn(fabsf(tau), root)) : 0.f;
      const float c = rsqrtf(__fadd_rn(1.f, __fmul_rn(t, t)));
      cs[i] = c;
      sn[i] = __fmul_rn(t, c);
    }
    __syncthreads();
    // (b) columns j and q = n_pad - 1 - j of G and V, every row:
    //     X[:, j] = G[:, j] c_j + G[:, q] s_q; a warp per row, a lane per
    //     pair
    for (int x = warp; x < n_pad; x += nwarps) {
      float* grow = gm + (size_t)x * n_pad;
      float* vrow = vm + (size_t)x * n_pad;
      for (int j = lane; j < half; j += 32) {
        const int q = n_pad - 1 - j;
        const int pj = pos[j], pq = pos[q];
        const float cj = cs[j], cq = cs[q], sj = sn[j], sq = sn[q];
        const float gj = grow[pj], gq = grow[pq];
        grow[pj] = __fadd_rn(__fmul_rn(gj, cj), __fmul_rn(gq, sq));
        grow[pq] = __fadd_rn(__fmul_rn(gq, cq), __fmul_rn(gj, sj));
        const float vj = vrow[pj], vq = vrow[pq];
        vrow[pj] = __fadd_rn(__fmul_rn(vj, cj), __fmul_rn(vq, sq));
        vrow[pq] = __fadd_rn(__fmul_rn(vq, cq), __fmul_rn(vj, sj));
      }
    }
    __syncthreads();
    // (c) rows j and q of G, every column: Y[j, :] = c_j X[j, :] + s_q X[q, :];
    //     a warp per pair, a lane per column
    for (int j = warp; j < half; j += nwarps) {
      const int q = n_pad - 1 - j;
      float* rj = gm + (size_t)pos[j] * n_pad;
      float* rq = gm + (size_t)pos[q] * n_pad;
      const float cj = cs[j], cq = cs[q], sj = sn[j], sq = sn[q];
      for (int y = lane; y < n_pad; y += 32) {
        const float xj = rj[y], xq = rq[y];
        rj[y] = __fadd_rn(__fmul_rn(cj, xj), __fmul_rn(sq, xq));
        rq[y] = __fadd_rn(__fmul_rn(cq, xq), __fmul_rn(sj, xj));
      }
    }
    __syncthreads();
    if (++r == n_pad - 1) r = 0;  // Pi: the next round's index map
  }

  // eigenvalues in logical order; the ascending stable sort by ranks
  for (int a = tid; a < n_pad; a += nthreads) {
    const int p = slot(a, r, n_pad);
    lam[a] = gm[(size_t)p * n_pad + p];
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
    v_out[e] = vm[(size_t)x * n_pad + src[o]];
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

// Launches the one-block eigensolver on `stream`; returns
// cudaGetLastError() (0 = launched).
int rsvd_eigh_small_f32(const float* g, float* lam, float* v, float* work,
                        int n, int sweeps, void* stream) {
  if (n <= 0) return 0;
  const Plan p = make_plan(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int steps = sweeps * (p.n_pad - 1);
  jacobi_eigh<<<1, kThreads, p.smem_bytes, s>>>(
      g, lam, v, p.in_smem ? nullptr : work, n, p.n_pad, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
