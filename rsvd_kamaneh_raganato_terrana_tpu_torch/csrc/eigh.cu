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
// card, so both routes below repeat the plain version's arithmetic
// operation for operation; only the pad value's norm is summed in another
// order, and the pad eigenpair never mixes with the others.
//
// What bounds it.  A round is ~9 n_pad^2 flops (n_pad / 2 pairs over G's
// columns, G's rows and V's columns): 36.4 MFLOP in all at n = 80, 0.54 us
// of the card's fp32 rate.  The bound is latency: 8 (n_pad - 1) dependent
// rounds, each a chain of a division, a square root, a division and a
// reciprocal square root, a pass over G and V, and a barrier.
//
// Two routes, one launch each, no host sync; rsvd_eigh_plan says which.
//
// (1) jacobi_eigh: one block of 768 threads, kept where it wins (n_pad <=
// 40).  Two block barriers per round, {G blocks and V columns} barrier
// {next (c, s)} barrier.
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
//     is only the (c, s) chain of n_pad threads.
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
// wrapper allocates (kept only above the cluster route's reach).
//
// (2) eigh_cluster: one thread-block cluster of C blocks (16, or 8 where
// the card holds no 16-block cluster) of 128 to 512 threads (the fewest
// that run a round's chains in one pass), G and V spread over the blocks'
// shared memory, so that each SM streams 1/C of a round's data.
//   - V's rows are the original coordinates and never move (V <- V J
//     only mixes columns), so block c keeps a fixed band of V's rows with
//     every column, columns through the slot map.  Its update is local.
//   - Block c owns a run of tournament pairs [p_lo, p_hi) and keeps both
//     rows of each, every column, columns through the slot map.  A pair's
//     2 x 2 blocks are then local, and so are its pivots G[a][a],
//     G[a'][a'] and G[a][a'].  Pi moves rows instead: the logical
//     positions 1 .. n_pad - 1 form a ring that turns by one place a
//     round (position 0 stays), and a block's pairs cover one or two arcs
//     of it.  Each arc is a ring buffer of its length + 2 rows, indexed
//     by (offset in the arc - round), so a row that stays in the arc
//     stays where it is; the row that leaves the arc's end goes to the
//     neighbouring block, which stores it in the free row before its
//     arc's start.  Two spare rows, not one: a neighbour may run one
//     round ahead, and the row it sends lands where this block's leaving
//     row was two rounds ago.
//   - The next round's pivots are pushed instead of this round's (c, s):
//     before the update each block computes, for each of its rows, the
//     two entries of J^T G J that the row's next pair pivots on (from this
//     round's (c, s) and the rows as they are), and sends them to every
//     block.  So every block holds the whole next round's pivots and runs
//     all n_pad chains itself (the same operations on the same values, so
//     every block gets the same bits), and the pivots travel while the
//     update runs.  The last round's pivots are the final diagonal, so the
//     ranks (the sort) are counted in every block.
//   - Pushes are st.async remote stores counted on the receiving block's
//     mbarrier (dsmem.cuh): the pivots and the moving rows each on two
//     mbarriers alternating with the round's parity; a wait that never
//     ends traps.  A round: wait for the rows that entered, push the next
//     pivots, barrier, G and V update in place, barrier, push the leaving
//     rows (threads past the chain's), wait for the next pivots, the
//     chains (and the block's row offsets, by the last threads), barrier.
//   - A round costs ~0.94 us at n = 80, ~1.15 us at n = 144 and ~1.5 us
//     at n = 240 on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase 2):
//     the update, the chain of IEEE divisions and square roots, and the
//     pivots' computation each take a part; the exchanges wait little.
// A block of the cluster holds about 2 n_pad^2 / C floats, so G and V stay
// on-chip up to n_pad ~ 670 at C = 16; above that the workspace route.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "dsmem.cuh"
#include "panel.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 768;  // the shortest round of 512 to 1024 on the H100
// the __syncthreads of one round of jacobi_eigh's loop, reported to logs
constexpr int kBarriersPerRound = 2;
constexpr int kClusterThreads = 512;   // eigh_cluster's widest block
// eigh_cluster's __syncthreads a round (its mbarrier waits besides)
constexpr int kClusterBarriersPerRound = 3;
constexpr int kWideCluster = 16;       // needs NonPortableClusterSizeAllowed
constexpr int kPortableCluster = 8;
// the widest n_pad that the default plan gives the one-block route: on an
// H100 80GB HBM3 at 700 W the 16-block cluster is slower at n = 32 and
// faster from n = 48 on (chip_smoke.py, phase 2's route sweep)
constexpr int kOneBlockMaxPad = 40;
// the opt-in shared memory of one sm_90 block
constexpr size_t kSmemMax = 232448;
constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON, 2^-23

enum Route { kOneBlock = 0, kCluster = 1, kWorkspace = 2 };

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
__host__ __device__ __forceinline__ int slot(int a, int r, int n) {
  if (a == 0) return 0;
  const int k = a - 1 - r;
  return 1 + (k < 0 ? k + n - 1 : k);
}

// x c + y s, each product rounded, then the sum
__device__ __forceinline__ float rot2(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// The (c, s) of logical index i against its mirror from the round's
// pivots: d = G[i][i], rd = G[i'][i'], off = G[i][i'].
__device__ __forceinline__ float2 rotation(int i, int mirror, float d,
                                           float rd, float off) {
  const float eps2 = kEps * kEps;  // 2^-46, exact
  const bool rot =
      __fmul_rn(off, off) > __fmul_rn(eps2, fabsf(__fmul_rn(d, rd)));
  const float gs = rot ? off : 1.f;
  const float tau = __fdiv_rn(__fsub_rn(rd, d), __fmul_rn(2.f, gs));
  // tau = 0: +1 at the pair's lower index, -1 at its mirror, so the
  // pair's (s, -s) stays a rotation (the plain version's tie rule)
  const float sgn = tau > 0.f   ? 1.f
                    : tau < 0.f ? -1.f
                    : (i < mirror ? 1.f : -1.f);
  const float root = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)));
  const float t = rot ? __fdiv_rn(sgn, __fadd_rn(fabsf(tau), root)) : 0.f;
  const float c = rsqrtf(__fadd_rn(1.f, __fmul_rn(t, t)));
  return make_float2(c, __fmul_rn(t, c));
}

// Rows x, x' of one 2 x 2 block of J^T G J in place: (g0, g1) = G[x][y],
// G[x][y'], (g2, g3) = G[x'][y], G[x'][y']; p = the row pair's
// (c_x, s_x, c_x', s_x'), q = the column pair's.  X = G J by columns,
// X[x][y] = G[x][y] c_y + G[x][y'] s_y', then J^T X by rows,
// G[x][y] = X[x][y] c_x + X[x'][y] s_x'.
__device__ __forceinline__ void rotate_block(const float (&g)[4],
                                             float4 p, float4 q,
                                             float (&out)[4]) {
  const float x00 = rot2(g[0], q.x, g[1], q.w);
  const float x01 = rot2(g[1], q.z, g[0], q.y);
  const float x10 = rot2(g[2], q.x, g[3], q.w);
  const float x11 = rot2(g[3], q.z, g[2], q.y);
  out[0] = rot2(x00, p.x, x10, p.w);
  out[1] = rot2(x01, p.x, x11, p.w);
  out[2] = rot2(x10, p.z, x00, p.y);
  out[3] = rot2(x11, p.z, x01, p.y);
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

// ||G||_F^2 of the n x n input, summed by the block (fmaf over a thread's
// entries, then a warp butterfly, then warps in order, as jacobi_eigh
// sums it); every thread gets -(||G||_F + 1), the pad eigenvalue.  `red`
// holds one float per warp.
__device__ float pad_value(const float* __restrict__ g_in, size_t nn,
                           float* red) {
  float ss = 0.f;
  for (size_t e = threadIdx.x; e < nn; e += blockDim.x)
    ss = fmaf(g_in[e], g_in[e], ss);
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) t += red[w];
  __syncthreads();
  return -(sqrtf(t) + 1.f);
}

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

  // (c_i, s_i) of logical index i against its mirror at round r of the
  // sweep: pair p = min(i, i') keeps (c_p, s_p, c_p', s_p') and (slot p,
  // slot p')
  auto rotations = [&](int r) {
    for (int i = tid; i < n_pad; i += nthreads) {
      const int mirror = n_pad - 1 - i;
      const int a = slot(i, r, n_pad);
      const int am = slot(mirror, r, n_pad);
      const float2 cs = rotation(i, mirror, gm[(Idx)a * n_pad + a],
                                 gm[(Idx)am * n_pad + am],
                                 gm[(Idx)a * n_pad + am]);
      const int p = i < mirror ? i : mirror;
      float* rp = reinterpret_cast<float*>(rec + p);
      int* pp = reinterpret_cast<int*>(pos + p);
      const int side = i < mirror ? 0 : 1;
      rp[2 * side] = cs.x;
      rp[2 * side + 1] = cs.y;
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
    // G <- J^T G J on the 2 x 2 blocks {x, x'} x {y, y'}
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
        float o[4];
        rotate_block(g[h], cp[h], cq[h], o);
        gx[h][sq[h].x] = o[0];
        gx[h][sq[h].y] = o[1];
        gxm[h][sq[h].x] = o[2];
        gxm[h][sq[h].y] = o[3];
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

// ---------------------------------------------------------------------
// The cluster route.

// What block c of a C-block cluster owns at n_pad: pairs [p_lo, p_lo +
// np); the ring arcs their rows (positions >= 1) cover, as the ring index
// (position - 1) of the arc's first position and its length; each arc's
// first buffer row (buffer row 0 holds position 0, in block 0); V's rows
// [x_lo, x_lo + nx).  The pairs and V's rows are split as evenly as can
// be, the first blocks taking one more.
struct Own {
  int p_lo, np, narcs;
  int start[2], len[2], base[2];
  int x_lo, nx;
};

__host__ __device__ inline Own own(int c, int C, int n_pad) {
  Own o = {};
  const int half = n_pad / 2;
  const int pb = half / C, pe = half % C;
  o.np = pb + (c < pe ? 1 : 0);
  o.p_lo = c * pb + (c < pe ? c : pe);
  const int p_hi = o.p_lo + o.np;
  if (c == 0) {
    // bottoms n_pad - p_hi .. n_pad - 1, then tops 1 .. p_hi - 1
    o.narcs = 1;
    o.start[0] = n_pad - p_hi - 1;
    o.len[0] = 2 * p_hi - 1;
  } else if (c == C - 1) {
    // tops p_lo .. half - 1, then bottoms half .. n_pad - 1 - p_lo
    o.narcs = 1;
    o.start[0] = o.p_lo - 1;
    o.len[0] = 2 * o.np;
  } else {
    o.narcs = 2;
    o.start[0] = o.p_lo - 1;   // tops, flowing to block c + 1
    o.len[0] = o.np;
    o.start[1] = n_pad - p_hi - 1;   // bottoms, flowing to block c - 1
    o.len[1] = o.np;
  }
  o.base[0] = 1;
  o.base[1] = 1 + o.len[0] + 2;
  const int vb = n_pad / C, ve = n_pad % C;
  o.nx = vb + (c < ve ? 1 : 0);
  o.x_lo = c * vb + (c < ve ? c : ve);
  return o;
}

// buffer rows of G that block `o` needs
__host__ __device__ inline int own_rows(const Own& o) {
  return o.base[o.narcs - 1] + o.len[o.narcs - 1] + 2;
}

// Shared-memory layout of eigh_cluster, in floats from the start: G's
// buffer rows and V's rows (stride ld, a multiple of 4), the pairs' (c, s)
// float4, two buffers of n_pad pivots (float2), the pairs' slots (int2),
// the block's row offsets (int2), four mbarriers, lam, src and the norm's
// per-warp sums.
struct ClusterShape {
  int C, n_pad, ld, rows, vrows, pmax;
  int g_off, v_off, rec_off, piv_off, pos_off, rowp_off, bar_off, lam_off,
      src_off, red_off, total;
};

__host__ __device__ inline ClusterShape cluster_shape(int n_pad, int C) {
  ClusterShape s = {};
  s.C = C;
  s.n_pad = n_pad;
  s.ld = (n_pad + 3) / 4 * 4;
  for (int c = 0; c < C; ++c) {
    const Own o = own(c, C, n_pad);
    if (own_rows(o) > s.rows) s.rows = own_rows(o);
    if (o.nx > s.vrows) s.vrows = o.nx;
    if (o.np > s.pmax) s.pmax = o.np;
  }
  const int half = n_pad / 2;
  s.g_off = 0;
  s.v_off = s.g_off + s.rows * s.ld;
  s.rec_off = s.v_off + s.vrows * s.ld;
  s.piv_off = s.rec_off + 4 * half;
  s.pos_off = s.piv_off + 2 * 2 * n_pad;   // two buffers of pivots
  s.rowp_off = s.pos_off + 2 * half;
  s.bar_off = s.rowp_off + 2 * s.pmax;   // even: 8-byte aligned
  s.lam_off = s.bar_off + 8;   // four mbarriers
  s.src_off = s.lam_off + n_pad;
  s.red_off = s.src_off + n_pad;
  s.total = s.red_off + kClusterThreads / 32;
  return s;
}

// Offset (floats, from G's buffer) of the row at logical position a, for
// a position that block `o` owns, with arc k turned ph[k] = (rounds done)
// mod (len[k] + 2) times; no division, and no array indexed at run time
// (that would put `o` in local memory).
__device__ __forceinline__ int row_at(const Own& o, const int (&ph)[2],
                                      int a, int M, int ld) {
  if (a == 0) return 0;
  int off = a - 1 - o.start[0];
  if (off < 0) off += M;
  const bool second = o.narcs > 1 && off >= o.len[0];
  if (second) {
    off = a - 1 - o.start[1];
    if (off < 0) off += M;
  }
  const int ring = (second ? o.len[1] : o.len[0]) + 2;
  int b = off - (second ? ph[1] : ph[0]);
  if (b < 0) b += ring;
  return ((second ? o.base[1] : o.base[0]) + b) * ld;
}

template <int C>
__global__ void __launch_bounds__(kClusterThreads, 1)
eigh_cluster(const float* __restrict__ g_in, float* __restrict__ lam_out,
             float* __restrict__ v_out, int n, int steps, ClusterShape sh) {
  extern __shared__ __align__(16) float smem[];
  const int n_pad = sh.n_pad, ld = sh.ld;
  const int half = n_pad / 2, M = n_pad - 1;
  float* grow = smem + sh.g_off;
  float* vrow = smem + sh.v_off;
  float4* rec = reinterpret_cast<float4*>(smem + sh.rec_off);
  float2* piv = reinterpret_cast<float2*>(smem + sh.piv_off);
  int2* pos = reinterpret_cast<int2*>(smem + sh.pos_off);
  int2* rowp = reinterpret_cast<int2*>(smem + sh.rowp_off);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + sh.bar_off);
  float* lam = smem + sh.lam_off;
  int* src = reinterpret_cast<int*>(smem + sh.src_off);
  float* red = smem + sh.red_off;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rank = (int)cg::this_cluster().block_rank();
  const Own me = own(rank, C, n_pad);
  const int nrows = 2 * me.np;   // this block's rows of G

  // where each arc's leaving row goes: the neighbour's rank, the first
  // buffer row of its arc and that arc's ring length; the turns of this
  // block's arcs (rounds done) and of the neighbours' (rounds done + 1),
  // each modulo its ring length
  int to_rank[2] = {}, to_base[2] = {}, to_ring[2] = {1, 1};
  int ph[2] = {0, 0}, to_ph[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < me.narcs) {
      const bool up = rank == 0 || (rank < C - 1 && k == 0);  // tops' flow
      to_rank[k] = up ? rank + 1 : rank - 1;
      const Own nb = own(to_rank[k], C, n_pad);
      const bool first = up || to_rank[k] == 0;   // the neighbour's arc 0
      to_base[k] = first ? nb.base[0] : nb.base[1];
      to_ring[k] = (first ? nb.len[0] : nb.len[1]) + 2;
      to_ph[k] = 1 % to_ring[k];
    }
  }
  // mbarriers: the pivots of round s at bar0 + 8 (s & 1), the rows that
  // enter at round s at bar0 + 16 + 8 (s & 1); the bytes each expects
  const unsigned bar0 = dsmem::smem_addr(bars);
  const unsigned expect_piv = (unsigned)(sizeof(float2) * (n_pad - nrows));
  const unsigned expect_rows = (unsigned)(sizeof(float) * ld * me.narcs);
  if (tid == 0) {
    for (int b = 0; b < 4; ++b) dsmem::mbar_init(bar0 + 8u * b);
    dsmem::mbar_init_fence();
  }

  // this block's rows of G (logical = physical at round 0), its rows of V,
  // and every pivot of round 0, from the input
  const float pad = n_pad != n ? pad_value(g_in, (size_t)n * n, red) : 0.f;
  auto g_at = [&](int i, int j) {
    if (i < n && j < n) return g_in[(size_t)i * n + j];
    return (i == n && j == n) ? pad : 0.f;
  };
  for (int e = tid; e < nrows * ld; e += nthreads) {
    const int j = e / ld, col = e % ld;
    const int p = me.p_lo + (j >> 1);
    const int a = (j & 1) ? n_pad - 1 - p : p;
    grow[row_at(me, ph, a, M, ld) + col] = g_at(a, col);
  }
  for (int e = tid; e < me.nx * ld; e += nthreads) {
    const int x = me.x_lo + e / ld;
    vrow[e] = x == e % ld ? 1.f : 0.f;
  }
  for (int a = tid; a < n_pad; a += nthreads)
    piv[a] = make_float2(g_at(a, a), g_at(a, n_pad - 1 - a));

  // every pair's (c, s) and slots at round r from the round's pivots pv;
  // this block's row offsets
  auto chain = [&](const float2* pv, int r) {
    for (int i = tid; i < n_pad; i += nthreads) {
      const int mirror = n_pad - 1 - i;
      const float2 cs =
          rotation(i, mirror, pv[i].x, pv[mirror].x, pv[i].y);
      const int p = i < mirror ? i : mirror;
      float* rp = reinterpret_cast<float*>(rec + p);
      int* pp = reinterpret_cast<int*>(pos + p);
      const int side = i < mirror ? 0 : 1;
      rp[2 * side] = cs.x;
      rp[2 * side + 1] = cs.y;
      pp[side] = slot(i, r, n_pad);
    }
    // by the last threads, which run no chain where n_pad + np fit
    const int lp = nthreads - 1 - tid;
    if (lp < me.np) {
      const int p = me.p_lo + lp;
      rowp[lp] = make_int2(row_at(me, ph, p, M, ld),
                           row_at(me, ph, n_pad - 1 - p, M, ld));
    }
  };
  __syncthreads();
  chain(piv, 0);
  panel::cluster_barrier();   // every block has started and set up

  // the G blocks (pair p, pair q) and V pairs (row x, pair q): a thread
  // keeps one q (its (c, s) and slots loaded once) and walks the block's
  // row pairs and V rows with the threads of the same q
  const int ngrp = half <= nthreads ? nthreads / half : 1;
  const int grp = half <= nthreads ? tid / half : 0;
  const int q0 = half <= nthreads ? tid % half : tid;
  const int qstep = half <= nthreads ? half : nthreads;
  int r = 0;   // round within the sweep
  for (int t = 0; t < steps; ++t) {
    const int s = t + 1;
    const unsigned pbar = bar0 + 8u * (s & 1);
    const unsigned rbar = bar0 + 16u + 8u * (s & 1);
    // the rows that entered this round, pushed at the end of the last
    if (t > 0) dsmem::mbar_wait(bar0 + 16u + 8u * (t & 1), ((t - 1) >> 1) & 1);

    // Round s's pivots first: for each row u of this block, the two
    // entries of J^T G J that u's next pair pivots on, computed from this
    // round's (c, s) before the update, to every block.  u's next
    // position is a = next(u); the entries are u's diagonal (block (p, p)
    // of u's pair p) and column slot(a', r + 1) = slot(perm[a'], r), in
    // the block of perm[a']'s pair q.
    if (tid == 0) dsmem::mbar_expect(pbar, expect_piv);
    const int rn = r + 1 == M ? 0 : r + 1;
    float2* pn = piv + (s & 1) * n_pad;
    for (int e = tid; e < nrows * C; e += nthreads) {
      const int j = e / C, d = e % C;
      const int lp = j >> 1;
      const bool bottom = j & 1;
      const int p = me.p_lo + lp;
      const int u = bottom ? n_pad - 1 - p : p;
      const int a = u == 0 ? 0 : (u == n_pad - 1 ? 1 : u + 1);
      const int am = n_pad - 1 - a;
      const int b = am == 0 ? 0 : (am == 1 ? n_pad - 1 : am - 1);
      const int q = b < n_pad - 1 - b ? b : n_pad - 1 - b;
      const bool right = b != q;   // the column is the pair's second slot
      const int2 rp = rowp[lp];
      const float4 cp = rec[p];
      const int2 sp = pos[p];
      const int2 sq = pos[q];
      const float gd[4] = {grow[rp.x + sp.x], grow[rp.x + sp.y],
                           grow[rp.y + sp.x], grow[rp.y + sp.y]};
      const float go[4] = {grow[rp.x + sq.x], grow[rp.x + sq.y],
                           grow[rp.y + sq.x], grow[rp.y + sq.y]};
      float od[4], oo[4];
      rotate_block(gd, cp, cp, od);
      rotate_block(go, cp, rec[q], oo);
      const float2 v = make_float2(
          bottom ? od[3] : od[0],
          bottom ? (right ? oo[3] : oo[2]) : (right ? oo[1] : oo[0]));
      if (d == rank) {
        pn[a] = v;
      } else {
        dsmem::st_async2(dsmem::map_rank(dsmem::smem_addr(pn + a), d), v,
                         dsmem::map_rank(pbar, d));
      }
    }
    __syncthreads();   // the pivots' reads before the update in place

    if (grp < ngrp) {
      for (int q = q0; q < half; q += qstep) {
        const float4 cq = rec[q];
        const int2 sq = pos[q];
        // G, two row pairs at a time, both loaded before either is stored
        for (int lp = grp; lp < me.np; lp += 2 * ngrp) {
          const int lp1 = lp + ngrp < me.np ? lp + ngrp : lp;
          float* gx[2];
          float* gxm[2];
          float4 cp[2];
          float g[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = h ? lp1 : lp;
            const int2 rp = rowp[l];
            cp[h] = rec[me.p_lo + l];
            gx[h] = grow + rp.x;
            gxm[h] = grow + rp.y;
            g[h][0] = gx[h][sq.x];
            g[h][1] = gx[h][sq.y];
            g[h][2] = gxm[h][sq.x];
            g[h][3] = gxm[h][sq.y];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float o[4];
            rotate_block(g[h], cp[h], cq, o);
            gx[h][sq.x] = o[0];
            gx[h][sq.y] = o[1];
            gxm[h][sq.x] = o[2];
            gxm[h][sq.y] = o[3];
          }
        }
        // V's rows, two at a time
        for (int x = grp; x < me.nx; x += 2 * ngrp) {
          const int x1 = x + ngrp < me.nx ? x + ngrp : x;
          float* vr[2] = {vrow + x * ld, vrow + x1 * ld};
          float v[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h][0] = vr[h][sq.x];
            v[h][1] = vr[h][sq.y];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            vr[h][sq.x] = rot2(v[h][0], cq.x, v[h][1], cq.w);
            vr[h][sq.y] = rot2(v[h][1], cq.z, v[h][0], cq.y);
          }
        }
      }
    }
    __syncthreads();

    // Pi: each arc's leaving row to its neighbour, for round s (none
    // after the last round)
    if (s < steps) {
      if (tid == 0) dsmem::mbar_expect(rbar, expect_rows);
      const int ld4 = ld / 4;
      // each arc's leaving row and where it goes, from the unrolled
      // per-arc values (no array indexed at run time)
      int from[2], to[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        from[k] = me.len[k] - 1 - ph[k];
        if (from[k] < 0) from[k] += me.len[k] + 2;
        from[k] = (me.base[k] + from[k]) * ld;
        to[k] = (to_base[k] + (to_ph[k] ? to_ring[k] - to_ph[k] : 0)) * ld;
      }
      // by the threads past the chain's n_pad where they suffice
      const int first = n_pad + me.narcs * ld4 <= nthreads ? n_pad : 0;
      for (int e = tid - first; e >= 0 && e < me.narcs * ld4; e += nthreads) {
        const bool second = e >= ld4;
        const int f = 4 * (second ? e - ld4 : e);
        const float4 v = *reinterpret_cast<const float4*>(
            grow + (second ? from[1] : from[0]) + f);
        const unsigned dst =
            dsmem::smem_addr(grow + (second ? to[1] : to[0]) + f);
        const int dr = second ? to_rank[1] : to_rank[0];
        dsmem::st_async4(dsmem::map_rank(dst, dr), v,
                         dsmem::map_rank(rbar, dr));
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ph[k] = ph[k] + 1 == me.len[k] + 2 ? 0 : ph[k] + 1;
      to_ph[k] = to_ph[k] + 1 == to_ring[k] ? 0 : to_ph[k] + 1;
    }
    r = rn;
    dsmem::mbar_wait(pbar, ((s - 1) >> 1) & 1);   // round s's pivots
    if (s < steps) chain(pn, r);
    __syncthreads();
  }

  // the final diagonal in logical order; the ascending stable sort by
  // ranks, counted in every block; each block writes its rows of V
  const float2* pv = piv + (steps & 1) * n_pad;
  for (int a = tid; a < n_pad; a += nthreads) {
    lam[a] = pv[a].x;
    src[a] = 0;
  }
  __syncthreads();
  const int drop = n_pad - n;
  for (int a = tid; a < n_pad; a += nthreads) {
    const float la = lam[a];
    int rk = 0;
    for (int b = 0; b < n_pad; ++b) {
      const float lb = lam[b];
      rk += (lb < la) || (lb == la && b < a);
    }
    const int o = rk - drop;  // the pad eigenvalue ranks first
    if (o >= 0 && o < n) {
      if (rank == 0) lam_out[o] = la;
      src[o] = slot(a, r, n_pad);
    }
  }
  __syncthreads();
  const int x_hi = me.x_lo + me.nx < n ? me.x_lo + me.nx : n;
  if (me.x_lo < x_hi)
    for (int e = tid; e < (x_hi - me.x_lo) * n; e += nthreads) {
      const int xl = e / n, o = e % n;
      v_out[(size_t)(me.x_lo + xl) * n + o] = vrow[xl * ld + src[o]];
    }
  panel::cluster_barrier();   // no block leaves while a peer may push
}

// ---------------------------------------------------------------------
// Route selection.

// the route rsvd_eigh_set_route forces (-1: the plan picks) and its
// cluster size
int g_route = -1;
int g_route_cluster = 0;

struct Choice {
  Route route;
  int cluster;        // kCluster: blocks of the cluster
  int threads;        // threads a block
  Plan one;           // the one-block plan (kOneBlock, kWorkspace)
  ClusterShape shape; // kCluster
  size_t smem_bytes;
};

// eigh_cluster's block: the fewest threads (128, 256 or 512) that run a
// round's n_pad chains in one pass; the barriers and the mbarrier waits of
// a round cost more with more threads, which the update does not repay
// below (chip_smoke.py's phase 2 times each)
int cluster_threads(int n_pad) {
  return n_pad <= 128 ? 128 : (n_pad <= 256 ? 256 : kClusterThreads);
}

bool cluster_fits(int n_pad, int C, ClusterShape* shape) {
  if ((C != 2 && C != 4 && C != 8 && C != 16) || C > n_pad / 2) return false;
  *shape = cluster_shape(n_pad, C);
  return sizeof(float) * (size_t)shape->total <= kSmemMax;
}

template <int C>
cudaError_t launch_cluster(int threads, const ClusterShape& sh, size_t smem,
                           cudaStream_t s, const float* g, float* lam,
                           float* v, int n, int steps) {
  auto kernel = eigh_cluster<C>;
  static bool done[panel::kMaxDevices];
  cudaError_t err = panel::allow_smem_once(kernel, done, true);
  if (err != cudaSuccess) return err;
  return panel::launch(kernel, dim3(C), threads, smem, s, C, g, lam, v, n,
                       steps, sh);
}

// whether the card runs a cluster of kWideCluster blocks of eigh_cluster
// at `smem` bytes a block; kept per device and shared-memory size class
bool wide_cluster_runs(size_t smem) {
  // the widest block, which any narrower one fits where it fits
  auto kernel = eigh_cluster<kWideCluster>;
  static bool done[panel::kMaxDevices];
  if (panel::allow_smem_once(kernel, done, true) != cudaSuccess)
    return false;
  static signed char known[panel::kMaxDevices][((kSmemMax + 4095) >> 12) + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= panel::kMaxDevices)
    return false;
  signed char& fits = known[dev][(smem + 4095) >> 12];
  if (fits == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kWideCluster, 1, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    const size_t cls = (smem + 4095) >> 12 << 12;
    cfg.dynamicSmemBytes = cls < kSmemMax ? cls : kSmemMax;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kWideCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    const bool ok = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) ==
                        cudaSuccess &&
                    count > 0;
    cudaGetLastError();   // a refused query leaves no error behind
    fits = ok ? 1 : -1;
  }
  return fits > 0;
}

Choice choose(int n) {
  Choice ch = {};
  ch.one = make_plan(n);
  const int n_pad = ch.one.n_pad;
  ClusterShape shape;
  bool cluster = false;
  if (g_route == kCluster) {
    // forced: a cluster that does not fit is refused at launch
    ch.cluster = g_route_cluster;
    cluster = true;
    if (!cluster_fits(n_pad, ch.cluster, &shape)) shape = ClusterShape{};
  } else if (g_route < 0 && (n_pad > kOneBlockMaxPad || !ch.one.in_smem)) {
    if (cluster_fits(n_pad, kWideCluster, &shape) &&
        wide_cluster_runs(sizeof(float) * (size_t)shape.total)) {
      ch.cluster = kWideCluster;
      cluster = true;
    } else if (cluster_fits(n_pad, kPortableCluster, &shape)) {
      ch.cluster = kPortableCluster;
      cluster = true;
    }
  }
  if (cluster) {
    ch.route = kCluster;
    ch.threads = cluster_threads(n_pad);
    ch.shape = shape;
    ch.smem_bytes = sizeof(float) * (size_t)shape.total;
  } else {
    ch.route = ch.one.in_smem ? kOneBlock : kWorkspace;
    ch.cluster = 1;
    ch.threads = kThreads;
    ch.smem_bytes = ch.one.smem_bytes;
  }
  return ch;
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_eigh_small_f32 needs for an n x n G
// (0 unless the plan takes the workspace route).
size_t rsvd_eigh_workspace_floats(int n) {
  if (n <= 0) return 0;
  const Choice ch = choose(n);
  return ch.route == kWorkspace ? ch.one.work_floats : 0;
}

// K3's plan at n: out = {route (0 one block in shared memory, 1 cluster,
// 2 one block with a device workspace), blocks (the cluster's, or 1),
// threads a block, dynamic shared memory a block (bytes), block barriers
// a round, tournament pairs a block owns at most, n_pad}.
void rsvd_eigh_plan(int n, long long* out) {
  const Choice ch = choose(n > 0 ? n : 1);
  const bool cl = ch.route == kCluster;
  out[0] = ch.route;
  out[1] = ch.cluster;
  out[2] = ch.threads;
  out[3] = (long long)ch.smem_bytes;
  out[4] = cl ? kClusterBarriersPerRound : kBarriersPerRound;
  out[5] = cl ? ch.shape.pmax : ch.one.n_pad / 2;
  out[6] = ch.one.n_pad;
}

// Forces a route for measuring the design: route -1 lets the plan pick,
// 0 takes the one-block kernel (in shared memory where G and V fit, else
// with the workspace), 1 the cluster of `cluster` blocks (2 to 16; one
// that does not fit n is refused at launch).  Returns 0, or -1 for a
// value it does not take (nothing changes then).  The package never calls
// it.
int rsvd_eigh_set_route(int route, int cluster) {
  if (route < -1 || route > kCluster) return -1;
  const bool cl = route == kCluster;
  if (cl && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return -1;
  g_route = route;
  g_route_cluster = cl ? cluster : 0;
  return 0;
}

// Launches the eigensolver on `stream`; returns the launch's own status
// (0 = launched).
int rsvd_eigh_small_f32(const float* g, float* lam, float* v, float* work,
                        int n, int sweeps, void* stream) {
  if (n <= 0) return 0;
  const Choice ch = choose(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = ch.one.n_pad;
  const int steps = sweeps * (n_pad - 1);
  if (ch.route == kCluster) {
    if (ch.shape.C == 0) return (int)cudaErrorInvalidValue;
    const int t = ch.threads;
    switch (ch.cluster) {
      case 2: return (int)launch_cluster<2>(t, ch.shape, ch.smem_bytes, s, g,
                                            lam, v, n, steps);
      case 4: return (int)launch_cluster<4>(t, ch.shape, ch.smem_bytes, s, g,
                                            lam, v, n, steps);
      case 8: return (int)launch_cluster<8>(t, ch.shape, ch.smem_bytes, s, g,
                                            lam, v, n, steps);
      default: return (int)launch_cluster<16>(t, ch.shape, ch.smem_bytes, s,
                                              g, lam, v, n, steps);
    }
  }
  const bool in_smem = ch.route == kOneBlock;
  cudaError_t err = in_smem
      ? cudaFuncSetAttribute(jacobi_eigh<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ch.smem_bytes)
      : cudaFuncSetAttribute(jacobi_eigh<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ch.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (in_smem)
    jacobi_eigh<true><<<1, kThreads, ch.smem_bytes, s>>>(g, lam, v, nullptr,
                                                         n, n_pad, steps);
  else
    jacobi_eigh<false><<<1, kThreads, ch.smem_bytes, s>>>(g, lam, v, work, n,
                                                          n_pad, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
