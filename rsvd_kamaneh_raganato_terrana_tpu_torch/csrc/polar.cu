// Kernel K2: Newton-Schulz polar orthonormalization of a tall-skinny f32
// panel, for Hopper (sm_90a).
//
// Replaces the TPU kernel in
//   rsvd_kamaneh_raganato_terrana_tpu/linalg/polar.py
//   polar_qr_fused / _polar_kernel.
// Given Y (m x l, row-major f32) and the schedule's per-step coefficients
// (a_k, b_k, c_k), k = 1..iters, it computes
//   G = Y^T Y,  alpha = max_i sum_j |G_ij| + 1e-30,  G~ = G (1 / alpha),
//   W_1 = a_1 I + b_1 G~ + c_1 G~^2,  H_1 = sym(W_1^T G~ W_1),
//   W_k = W_{k-1} (a_k I + b_k H + c_k H^2),  H_k = sym(W_k^T G~ W_k),
//   W_s = W_iters / sqrt(alpha),
// and returns Q = Y W_s (m x l) and R = W_s G (l x l, symmetric, not
// triangular); sym(H) = (H + H^T) / 2.  With `stage` >= 0 it stops early
// and writes one l x l intermediate to R instead (0: G, 1: G~, 2: W_1,
// 2 + k: H_k), and Q is not written.  This is the stage probe of
// benchmarks/diagnostics/polar_tpu_debug2.py (make_probe) for the
// current row-sum algorithm.
//
// Design.  The TPU kernel keeps Y resident in VMEM; here Y (1.25 MiB at
// 4096 x 80) does not fit an SM, so the work is three launches on one
// stream, with the Gram and the apply shared with K1 (panel.cuh):
//   (a) the Gram pass: l-wide tiles over one wave of row splits, the
//       partials of each 8-block cluster added through distributed shared
//       memory (16 partials at 4096 x 80);
//   (b) ns_cluster: the whole l x l iteration on ONE thread-block cluster
//       of 16 blocks (8 where the card holds no 16-block cluster; the
//       result is bitwise the same).  Each block keeps a full copy of the
//       six l x l matrices (G, G~ and four that rotate; 158 KB at l = 80)
//       in its shared memory and owns a band of rows.  G's band is summed
//       from the Gram's partials in part order.  Each product C = op(A) B
//       computes the block's band of C: 8 warps split the sum over k, two
//       k at a time, each lane holding band x 3 outputs in registers
//       (columns lane + 32 v; A's pairs broadcast as float2, G~ and H read
//       as A^T since they are bitwise symmetric), and the 8 partial bands
//       are added in warp order.  The block then pushes its band into
//       every peer's copy of C as float4 asynchronous remote stores
//       (st.async) that count their bytes on the peer's mbarrier, all
//       issued before it waits on its own: one wait per product, 33 in
//       all at 8 steps, and no cluster barrier.  The polynomial
//       a I + b H + c H^2 is applied as H^2's band is summed.  The other
//       elementwise steps (the alpha row sums, G~, sym and the final
//       scale) run redundantly on each block's full copy, so they need no
//       wait.  A product never writes a slot that a block one product
//       behind still reads (the slots rotate; sym is out of place).  At
//       the end each block writes its band of W_s and of R = W_s G to
//       device memory.
//       Where six copies do not fit (l > 88) the iteration runs in ONE
//       block (ns_iterate, 1024 threads, 2 x 2 outputs each), the
//       matrices that do not fit shared memory in the workspace.
//   (c) the apply pass: Q = Y W_s with W_s staged in shared memory once
//       per block.
// The TPU kernel pads l to 128 for its tiles and restores an identity on
// the pad block of G~; nothing is padded here.
//
// Numerics.  Every product is plain fp32 FMA: no TF32, no tensor cores,
// matching Precision.HIGHEST (a single bf16 pass makes the schedule
// diverge, polar.py:84-92).  The elementwise steps use __fmul_rn and
// __fadd_rn so that they round as the plain version does.  No clamp and
// no shift: a rank-deficient Y is out of domain (NaN or garbage), as the
// polar contract says.  Every sum runs in an order fixed by (m, l) and the
// cluster size: no atomics, deterministic.
//
// What bounds it.  At the main path's 4096 x 80 the work is ~105 MFLOP
// in (a) and (c) and 33 products of 2 l^3 in (b): ~2.1 us at the card's
// 67 TFLOP/s fp32, above the ~0.8 us of its 2.65 MB of traffic.  (b) is
// a chain of 33 dependent products on one cluster: each costs a band
// product, a push of l^2 floats into every block (distributed shared
// memory's rate) and the wait for the slowest peer.

#include <cuda_runtime.h>

#include <cstddef>

#include "panel.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kIterThreads = 1024;  // ns_iterate, the one-block path
constexpr int kNsThreads = 256;     // ns_cluster
constexpr int kNsWarps = kNsThreads / 32;
constexpr int kNsCols = 3;          // columns a lane: l <= 96
constexpr int kMaxBand = 12;        // rows a block owns, at most
constexpr int kMaxIters = 16;
constexpr int kSlots = 6;           // l x l matrices the iteration keeps
constexpr int kRed = 64;            // floats of reduction scratch
constexpr int kWideCluster = 16;    // needs NonPortableClusterSizeAllowed
constexpr int kPortableCluster = 8;

// the cluster size: 0 picks 16 where the card runs such a cluster, else 8;
// rsvd_polar_set_cluster fixes another, for measuring the design
int g_cluster = 0;

struct Schedule {
  float abc[kMaxIters][3];
};

struct Plan {
  panel::GramPlan gram;
  bool clustered;         // ns_cluster, else ns_iterate
  int cluster;            // ns_cluster: blocks of the cluster
  int band;               // ns_cluster: rows a block owns (even)
  int ld;                 // ns_cluster: row stride of the shared copies
  size_t ws_off;          // W_s (l x l), read by the apply
  size_t slots_off;       // ns_iterate: matrices that do not fit
  int slots_in_smem;
  size_t total_floats;
  size_t smem_bytes;
};

Plan make_plan(int m, int l, int cluster) {
  Plan p = {};
  p.gram = panel::make_gram_plan(m, l);
  const size_t ll = (size_t)l * l;
  p.ws_off = (size_t)p.gram.nparts * ll;
  p.slots_off = p.ws_off + ll;
  p.cluster = cluster;
  const int rows = (l + cluster - 1) / cluster;
  p.band = (rows + 1) / 2 * 2;
  // a multiple of 4 (float4 pushes) but not of 8: a column's entries
  // (symmetrize, the alpha row sums) fall into 8 banks, not 2
  p.ld = (l + 7) / 8 * 8 + 4;
  const size_t cluster_smem =
      sizeof(float) * ((size_t)kSlots * l * p.ld +
                       (size_t)kNsWarps * p.band * p.ld + kRed) +
      2 * sizeof(unsigned long long);   // the two mbarriers
  p.clustered = l <= 32 * kNsCols && p.band <= kMaxBand &&
                cluster_smem <= panel::kSmemMax;
  if (p.clustered) {
    p.slots_in_smem = kSlots;
    p.total_floats = p.slots_off;
    p.smem_bytes = cluster_smem;
  } else {
    const size_t fit =
        (panel::kSmemMax - kRed * sizeof(float)) / (ll * sizeof(float));
    p.slots_in_smem = fit > (size_t)kSlots ? kSlots : (int)fit;
    p.total_floats = p.slots_off + (size_t)(kSlots - p.slots_in_smem) * ll;
    p.smem_bytes = sizeof(float) * (kRed + (size_t)p.slots_in_smem * ll);
  }
  return p;
}

// max that keeps a NaN, as jnp.max does
__device__ float max_nan(float x, float y) {
  return (y > x || y != y) ? y : x;
}

// The elementwise steps on l x l matrices at row stride ld, by the whole
// block, each ending with a block barrier (store_rows excepted).  Warps
// take rows, lanes columns; kC > 0 (l <= 32 kC) unrolls the kC column
// chunks of a row so that their loads are issued together, kC = 0 takes
// any l.  The one-block path (ns_iterate) uses kC = 0 and the in-place
// poly and symmetrize.

// out = a I + b h + c h2; out may alias h2.
__device__ void poly(float* out, const float* h, const float* h2, float a,
                     float b, float c, int l, int ld) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < l; i += blockDim.x >> 5)
    for (int j = lane; j < l; j += 32) {
      const size_t x = (size_t)i * ld + j;
      const float diag = i == j ? a : 0.f;
      out[x] = __fadd_rn(__fadd_rn(diag, __fmul_rn(b, h[x])),
                         __fmul_rn(c, h2[x]));
    }
  __syncthreads();
}

// h = (h + h^T) / 2 in place.
__device__ void symmetrize(float* h, int l, int ld) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < l; i += blockDim.x >> 5)
    for (int j = i + 1 + lane; j < l; j += 32) {
      const size_t x = (size_t)i * ld + j;
      const size_t xt = (size_t)j * ld + i;
      const float v = __fmul_rn(0.5f, __fadd_rn(h[x], h[xt]));
      h[x] = v;
      h[xt] = v;
    }
  __syncthreads();
}

// out = (h + h^T) / 2, out of place: entry (i, j) and entry (j, i) are
// the same rounded sum, so out is bitwise symmetric.  Warps take rows,
// lanes columns; a row's loads are issued before its stores (out and h are
// different slots, but the compiler cannot tell).  The column reads h[j][i]
// fall into 8 banks, not 2, since ld = 4 mod 8.
__device__ void symmetrized(float* out, const float* h, int l, int ld) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < l; i += blockDim.x >> 5) {
    float a[kNsCols], b[kNsCols];
#pragma unroll
    for (int v = 0; v < kNsCols; ++v) {
      const int j = lane + 32 * v < l ? lane + 32 * v : l - 1;
      a[v] = h[(size_t)i * ld + j];
      b[v] = h[(size_t)j * ld + i];
    }
#pragma unroll
    for (int v = 0; v < kNsCols; ++v)
      if (lane + 32 * v < l)
        out[(size_t)i * ld + lane + 32 * v] =
            __fmul_rn(0.5f, __fadd_rn(a[v], b[v]));
  }
  __syncthreads();
}

// out = x s over rows [lo, hi) (x at stride ldx, out at stride ldo); out
// may alias x.  kC > 0 loads a row's kC chunks before it stores any.
template <int kC>
__device__ void scale_rows(float* out, int ldo, const float* x, int ldx,
                           float s, int l, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int i = lo + (int)(threadIdx.x >> 5); i < hi; i += blockDim.x >> 5) {
    if constexpr (kC > 0) {
      float v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int j = lane + 32 * c < l ? lane + 32 * c : l - 1;
        v[c] = x[(size_t)i * ldx + j];
      }
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (lane + 32 * c < l)
          out[(size_t)i * ldo + lane + 32 * c] = __fmul_rn(v[c], s);
    } else {
      for (int j = lane; j < l; j += 32)
        out[(size_t)i * ldo + j] = __fmul_rn(x[(size_t)i * ldx + j], s);
    }
  }
}

// out = x s; out may alias x.
template <int kC>
__device__ void scale_by(float* out, const float* x, float s, int l,
                         int ld) {
  scale_rows<kC>(out, ld, x, ld, s, l, 0, l);
  __syncthreads();
}

// alpha = the largest row sum of |G| (a lambda_max bound) + 1e-30, no
// shift.  A warp sums 4 rows at a time (lanes over columns, then a fixed
// butterfly per row); `red` holds kRed floats.
template <int kC>
__device__ float alpha_of(const float* g, int l, int ld, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float mx = 0.f;
  for (int i0 = 4 * warp; i0 < l; i0 += 4 * nwarps) {
    float rs[4] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q < l ? i0 + q : l - 1;
      if constexpr (kC > 0) {
#pragma unroll
        for (int v = 0; v < kC; ++v)
          if (lane + 32 * v < l)
            rs[q] += fabsf(g[(size_t)i * ld + lane + 32 * v]);
      } else {
        for (int j = lane; j < l; j += 32)
          rs[q] += fabsf(g[(size_t)i * ld + j]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], off);
#pragma unroll
    for (int q = 0; q < 4; ++q) mx = max_nan(mx, rs[q]);
  }
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[32] = __fadd_rn(mx, 1e-30f);
  }
  __syncthreads();
  return red[32];
}

// dst (l x l, stride l, device memory) = rows [lo, hi) of x (stride ld)
template <int kC>
__device__ void store_rows(float* dst, const float* x, int l, int ld, int lo,
                           int hi) {
  scale_rows<kC>(dst, l, x, ld, 1.f, l, lo, hi);
}

// The polynomial a I + b H + c X that a product X = H H (or G~ G~) feeds
// into, applied as the product's band is summed (each term rounded alone,
// as the plain version rounds it).
struct Poly {
  const float* h;
  float a, b, c;
};

__device__ __forceinline__ float poly_at(const Poly& p, int i, int j,
                                         size_t x, float v) {
  const float diag = i == j ? p.a : 0.f;
  return __fadd_rn(__fadd_rn(diag, __fmul_rn(p.b, p.h[x])),
                   __fmul_rn(p.c, v));
}

// Pushing a band to the cluster's blocks: asynchronous remote stores
// (st.async) that count their bytes on the receiving block's mbarrier, so
// a block waits for exactly the data it needs instead of for the whole
// cluster.  Two mbarriers alternate with the parity of the product.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// waits for the mbarrier's phase of this parity; a wait that never ends
// (a fault) stops the kernel instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long n = 0;; ++n) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (n > (1LL << 26)) __trap();
  }
}

// The pushes of a cluster's products: the block's rank, its mbarriers and
// how many products it has pushed.
struct Pusher {
  int rank;
  unsigned bars;      // shared address of two mbarriers
  unsigned expect;    // bytes the peers push into this block per product
  int phase;
};

// The block's band, rows [lo, hi), of C = op(A) B (op(A) = A^T when
// kTransA), all l x l at stride ld in shared memory, zero past column l.
// Warp w sums its slice of k, two at a time (A's pairs read as float2),
// into TR x kNsCols registers a lane (columns lane + 32 v); `red`
// (kNsWarps x TR x ld, zero past column l) gathers the warps' bands, added
// in warp order.  kPoly: the band of a I + b H + c C instead.  kGlobal:
// the band goes to `gout` (stride l, device memory).  Else it is pushed as
// float4 into C of every block of the cluster (`push`), and the block
// waits until its peers' bands of C have arrived.
template <int TR, bool kTransA, bool kPoly, bool kGlobal>
__device__ void band_mm(float* c, const float* a, const float* b,
                        float* red, int l, int ld, int lo, int hi,
                        const Poly& poly, float* gout, Pusher& push) {
  const unsigned bar = push.bars + 8u * (push.phase & 1);
  if (!kGlobal && threadIdx.x == 0) mbar_expect(bar, push.expect);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[TR][kNsCols] = {};
  if (lo < hi) {   // block-uniform
    // Loads are not masked: rows past hi and columns past l read other
    // (finite or not) shared memory of the block, and only feed outputs
    // that are never stored.  Pairs of k: an odd l's last k comes after.
    const int pairs = l / 2;
    const int ppw = (pairs + kNsWarps - 1) / kNsWarps;
    const int p0 = warp * ppw;
    const int p1 = p0 + ppw < pairs ? p0 + ppw : pairs;
    const float* bl = b + lane;
    for (int pk = p0; pk < p1; ++pk) {
      const int k = 2 * pk;
      float av[TR][2], bv[2][kNsCols];
      if constexpr (kTransA) {
        // A[k][lo + u], A[k + 1][lo + u]: pairs along u (lo and TR even)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* ar = a + (size_t)(k + kk) * ld + lo;
#pragma unroll
          for (int u = 0; u < TR; u += 2) {
            const float2 v = *reinterpret_cast<const float2*>(ar + u);
            av[u][kk] = v.x;
            av[u + 1][kk] = v.y;
          }
        }
      } else {
        // A[lo + u][k], A[lo + u][k + 1]: pairs along k (k and ld even)
#pragma unroll
        for (int u = 0; u < TR; ++u) {
          const float2 v = *reinterpret_cast<const float2*>(
              a + (size_t)(lo + u) * ld + k);
          av[u][0] = v.x;
          av[u][1] = v.y;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int v = 0; v < kNsCols; ++v)
          bv[kk][v] = bl[(size_t)(k + kk) * ld + 32 * v];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int u = 0; u < TR; ++u)
#pragma unroll
          for (int v = 0; v < kNsCols; ++v)
            acc[u][v] = fmaf(av[u][kk], bv[kk][v], acc[u][v]);
    }
    if ((l & 1) && warp == kNsWarps - 1) {
      const int k = l - 1;
#pragma unroll
      for (int u = 0; u < TR; ++u) {
        const float av = kTransA ? a[(size_t)k * ld + lo + u]
                                 : a[(size_t)(lo + u) * ld + k];
#pragma unroll
        for (int v = 0; v < kNsCols; ++v)
          acc[u][v] = fmaf(av, bl[(size_t)k * ld + 32 * v], acc[u][v]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < TR; ++u)
#pragma unroll
    for (int v = 0; v < kNsCols; ++v) {
      const int col = lane + 32 * v;
      if (lo + u < hi && col < l)
        red[(warp * TR + u) * ld + col] = acc[u][v];
    }
  __syncthreads();
  if constexpr (kGlobal) {
    for (int e = threadIdx.x; e < (hi - lo) * l; e += blockDim.x) {
      const int u = e / l;
      const int col = e % l;
      float s = red[u * ld + col];
#pragma unroll
      for (int w = 1; w < kNsWarps; ++w) s += red[(w * TR + u) * ld + col];
      gout[(size_t)(lo + u) * l + col] = s;
    }
  } else {
    const int csize = (int)cg::this_cluster().num_blocks();
    const int ld4 = ld / 4;
    const int n4 = (hi - lo) * ld4;   // the band, pad columns included
    const float4* red4 = reinterpret_cast<const float4*>(red);
    float4* band4 = reinterpret_cast<float4*>(c + (size_t)lo * ld);
    for (int e = threadIdx.x; e < n4; e += blockDim.x) {
      float4 s = red4[e];
#pragma unroll
      for (int w = 1; w < kNsWarps; ++w) {
        const float4 x = red4[w * TR * ld4 + e];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      if constexpr (kPoly) {
        const int i = lo + e / ld4;
        const int j = 4 * (e % ld4);
        if (j < l) {   // pad columns stay zero
          const size_t x = (size_t)i * ld + j;
          s.x = poly_at(poly, i, j, x, s.x);
          s.y = poly_at(poly, i, j + 1, x + 1, s.y);
          s.z = poly_at(poly, i, j + 2, x + 2, s.z);
          s.w = poly_at(poly, i, j + 3, x + 3, s.w);
        }
      }
      band4[e] = s;
      const unsigned dst = smem_addr(band4 + e);
      for (int r = 0; r < csize; ++r)
        if (r != push.rank) st_async4(map_rank(dst, r), s, map_rank(bar, r));
    }
    __syncthreads();   // this block's own band, written here
    mbar_wait(bar, (push.phase >> 1) & 1);   // the peers' bands
    ++push.phase;
  }
}

// (b) on one cluster, l <= 96: see the file's head.  TR = band rows.
template <int TR>
__global__ void __launch_bounds__(kNsThreads, 1)
ns_cluster(const float* __restrict__ part, int nparts, float* __restrict__ r,
           float* __restrict__ ws_out, int l, Schedule sch, int iters,
           int stage) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = (l + 7) / 8 * 8 + 4;
  const size_t sl = (size_t)l * ld;
  // slots 0-3 rotate (see below); G~ and G stay
  float* gt = smem + 4 * sl;
  float* g = smem + 5 * sl;
  float* red = smem + kSlots * sl;                 // kNsWarps x TR x ld
  float* scal = red + (size_t)kNsWarps * TR * ld;  // kRed floats
  Pusher push;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lo = rank * TR < l ? rank * TR : l;
  const int hi = lo + TR < l ? lo + TR : l;
  push.rank = rank;
  push.bars = smem_addr(scal + kRed);
  push.expect = (unsigned)((l - (hi - lo)) * ld * sizeof(float));
  push.phase = 0;
  if (threadIdx.x == 0) {
    mbar_init(push.bars);
    mbar_init(push.bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // pad columns stay zero: the pushes copy whole rows of a band
  for (size_t e = threadIdx.x; e < kSlots * sl + (size_t)kNsWarps * TR * ld;
       e += blockDim.x)
    smem[e] = 0.f;
  panel::cluster_barrier();   // every block has started and zeroed
  panel::band_sum(part, nparts, l, lo, hi, g, ld, 0,
                  (int)cluster.num_blocks());
  panel::cluster_barrier();
  if (stage == 0) return store_rows<kNsCols>(r, g, l, ld, lo, hi);

  const float alpha = alpha_of<kNsCols>(g, l, ld, scal);
  scale_by<kNsCols>(gt, g, 1.f / alpha, l, ld);
  if (stage == 1) return store_rows<kNsCols>(r, gt, l, ld, lo, hi);

  // G~ and H are bitwise symmetric, so products with them on the left
  // read them as A^T (pairs along a row of A^T, one base address per k).
  // The four matrices of the loop rotate through four slots so that no
  // product writes a slot that a block one product behind still reads:
  // a product's output is never the slot its predecessor's elementwise
  // step reads (sym reads H~ = hr), nor an operand of its own.  The slots
  // are held as offsets from the shared array, so that every access
  // stays a shared-memory one.
  const Poly none = {};
  int w = 3 * (int)sl;                            // W_1
  band_mm<TR, true, true, false>(smem + w, gt, gt, red, l, ld, lo, hi,
                                 Poly{gt, sch.abc[0][0], sch.abc[0][1],
                                      sch.abc[0][2]}, nullptr, push);
  if (stage == 2) return store_rows<kNsCols>(r, smem + w, l, ld, lo, hi);
  int t = 2 * (int)sl;                            // G~ W
  band_mm<TR, true, false, false>(smem + t, gt, smem + w, red, l, ld, lo, hi,
                                  none, nullptr, push);
  int hr = 0;                                     // W^T G~ W
  band_mm<TR, true, false, false>(smem + hr, smem + w, smem + t, red, l, ld,
                                  lo, hi, none, nullptr, push);
  int h = (int)sl;
  symmetrized(smem + h, smem + hr, l, ld);
  if (stage == 3) return store_rows<kNsCols>(r, smem + h, l, ld, lo, hi);

  for (int k = 1; k < iters; ++k) {
    const int p = t;                              // a I + b H + c H^2
    band_mm<TR, true, true, false>(smem + p, smem + h, smem + h, red, l, ld,
                                   lo, hi,
                                   Poly{smem + h, sch.abc[k][0],
                                        sch.abc[k][1], sch.abc[k][2]},
                                   nullptr, push);
    const int w2 = hr;                            // W P
    band_mm<TR, false, false, false>(smem + w2, smem + w, smem + p, red, l,
                                     ld, lo, hi, none, nullptr, push);
    t = w;                                        // G~ W
    band_mm<TR, true, false, false>(smem + t, gt, smem + w2, red, l, ld, lo,
                                    hi, none, nullptr, push);
    hr = h;                                       // W^T G~ W
    band_mm<TR, true, false, false>(smem + hr, smem + w2, smem + t, red, l,
                                    ld, lo, hi, none, nullptr, push);
    h = p;
    symmetrized(smem + h, smem + hr, l, ld);
    w = w2;
    if (stage == 3 + k) return store_rows<kNsCols>(r, smem + h, l, ld, lo, hi);
  }

  scale_by<kNsCols>(smem + w, smem + w, 1.f / sqrtf(alpha), l, ld);
  store_rows<kNsCols>(ws_out, smem + w, l, ld, lo, hi);
  band_mm<TR, false, false, true>(nullptr, smem + w, g, red, l, ld, lo, hi,
                                  none, r, push);                // W_s G
}

// The one-block path: C = op(A) B for l x l row-major matrices, op(A) =
// A^T when kTransA.  Each thread owns a 2 x 2 block of C; every sum runs
// over k in order.  C must not alias A or B.  Ends with a block barrier.
template <bool kTransA>
__device__ void block_mm(float* c, const float* a, const float* b, int l) {
  const int h = (l + 1) / 2;
  for (int t = threadIdx.x; t < h * h; t += blockDim.x) {
    const int i = 2 * (t / h);
    const int j = 2 * (t % h);
    const bool i1 = i + 1 < l;
    const bool j1 = j + 1 < l;
    float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
    for (int k = 0; k < l; ++k) {
      const float a0 = kTransA ? a[(size_t)k * l + i] : a[(size_t)i * l + k];
      float a1 = 0.f;
      if (i1)
        a1 = kTransA ? a[(size_t)k * l + i + 1] : a[(size_t)(i + 1) * l + k];
      const float* brow = b + (size_t)k * l;
      const float b0 = brow[j];
      const float b1 = j1 ? brow[j + 1] : 0.f;
      c00 = fmaf(a0, b0, c00);
      c01 = fmaf(a0, b1, c01);
      c10 = fmaf(a1, b0, c10);
      c11 = fmaf(a1, b1, c11);
    }
    c[(size_t)i * l + j] = c00;
    if (j1) c[(size_t)i * l + j + 1] = c01;
    if (i1) {
      c[(size_t)(i + 1) * l + j] = c10;
      if (j1) c[(size_t)(i + 1) * l + j + 1] = c11;
    }
  }
  __syncthreads();
}

// (b) in one block, where six copies do not fit a cluster's blocks: G from
// the partials, the whole iteration, W_s and R.
__global__ void __launch_bounds__(kIterThreads)
ns_iterate(const float* __restrict__ part, int nparts, float* r,
           float* ws_out, float* slots_global, int slots_in_smem, int l,
           Schedule sch, int iters, int stage) {
  extern __shared__ float smem[];
  float* red = smem;
  const size_t ll = (size_t)l * l;
  float* slot[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    slot[s] = s < slots_in_smem
                  ? smem + kRed + (size_t)s * ll
                  : slots_global + (size_t)(s - slots_in_smem) * ll;
  // the most used first, so that they are the ones in shared memory
  float* h = slot[0];
  float* t1 = slot[1];
  float* t2 = slot[2];
  float* w = slot[3];
  float* gt = slot[4];
  float* g = slot[5];

  for (size_t e = threadIdx.x; e < ll; e += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += part[(size_t)p * ll + e];
    g[e] = s;
  }
  __syncthreads();
  if (stage == 0) return store_rows<0>(r, g, l, l, 0, l);

  const float alpha = alpha_of<0>(g, l, l, red);
  scale_by<0>(gt, g, 1.f / alpha, l, l);
  if (stage == 1) return store_rows<0>(r, gt, l, l, 0, l);

  block_mm<false>(t1, gt, gt, l);                       // G~^2
  poly(w, gt, t1, sch.abc[0][0], sch.abc[0][1], sch.abc[0][2], l, l);
  if (stage == 2) return store_rows<0>(r, w, l, l, 0, l);
  block_mm<false>(t2, gt, w, l);                        // G~ W
  block_mm<true>(h, w, t2, l);                          // W^T G~ W
  symmetrize(h, l, l);
  if (stage == 3) return store_rows<0>(r, h, l, l, 0, l);

  for (int k = 1; k < iters; ++k) {
    block_mm<false>(t1, h, h, l);                       // H^2
    poly(t1, h, t1, sch.abc[k][0], sch.abc[k][1], sch.abc[k][2], l, l);
    block_mm<false>(t2, w, t1, l);                      // W P
    float* swap = w;
    w = t2;
    t2 = swap;
    block_mm<false>(t1, gt, w, l);                      // G~ W
    block_mm<true>(h, w, t1, l);                        // W^T G~ W
    symmetrize(h, l, l);
    if (stage == 3 + k) return store_rows<0>(r, h, l, l, 0, l);
  }

  scale_by<0>(w, w, 1.f / sqrtf(alpha), l, l);
  store_rows<0>(ws_out, w, l, l, 0, l);
  block_mm<false>(r, w, g, l);                          // R = W_s G
}

struct Args {
  const float* part;
  int nparts;
  float* r;
  float* ws;
  int l;
  Schedule sch;
  int iters;
  int stage;
};

// the flags of allow_smem_once for ns_cluster<TR>
template <int TR>
bool (&ns_cluster_ready())[panel::kMaxDevices] {
  static bool done[panel::kMaxDevices];
  return done;
}

// whether the card holds a cluster of kWideCluster blocks of ns_cluster<TR>
// at `smem` bytes a block
template <int TR>
bool wide_cluster_fits(size_t smem) {
  auto kernel = ns_cluster<TR>;
  if (panel::allow_smem_once(kernel, ns_cluster_ready<TR>(), true) !=
      cudaSuccess)
    return false;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kWideCluster, 1, 1);
  cfg.blockDim = dim3(kNsThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess &&
         n > 0;
}

// The plan at (m, l) with the cluster size g_cluster asks for; the answer
// to "does a 16-block cluster fit" is kept per device and l.
Plan resolve_plan(int m, int l) {
  if (g_cluster != 0) return make_plan(m, l, g_cluster);
  const Plan wide = make_plan(m, l, kWideCluster);
  if (!wide.clustered) return make_plan(m, l, kPortableCluster);
  static signed char known[panel::kMaxDevices][32 * kNsCols + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= panel::kMaxDevices)
    return make_plan(m, l, kPortableCluster);
  signed char& fits = known[dev][l];
  if (fits == 0) {
    bool ok;
    switch (wide.band) {
      case 2: ok = wide_cluster_fits<2>(wide.smem_bytes); break;
      case 4: ok = wide_cluster_fits<4>(wide.smem_bytes); break;
      default: ok = wide_cluster_fits<6>(wide.smem_bytes); break;
    }
    fits = ok ? 1 : -1;
  }
  return fits > 0 ? wide : make_plan(m, l, kPortableCluster);
}

template <int TR>
cudaError_t launch_cluster_tr(const Plan& p, const Args& a, cudaStream_t s) {
  auto kernel = ns_cluster<TR>;
  cudaError_t err =
      panel::allow_smem_once(kernel, ns_cluster_ready<TR>(), true);
  if (err != cudaSuccess) return err;
  return panel::launch(kernel, dim3(p.cluster), kNsThreads, p.smem_bytes, s,
                       p.cluster, a.part, a.nparts, a.r, a.ws, a.l, a.sch,
                       a.iters, a.stage);
}

cudaError_t launch_iteration(const Plan& p, const Args& a, float* work,
                             cudaStream_t s) {
  if (!p.clustered) {
    static bool done[panel::kMaxDevices];
    cudaError_t err = panel::allow_smem_once(ns_iterate, done);
    if (err != cudaSuccess) return err;
    return panel::launch(ns_iterate, dim3(1), kIterThreads, p.smem_bytes, s, 0,
                         a.part, a.nparts, a.r, a.ws, work + p.slots_off,
                         p.slots_in_smem, a.l, a.sch, a.iters, a.stage);
  }
  switch (p.band) {
    case 2: return launch_cluster_tr<2>(p, a, s);
    case 4: return launch_cluster_tr<4>(p, a, s);
    case 6: return launch_cluster_tr<6>(p, a, s);
    case 8: return launch_cluster_tr<8>(p, a, s);
    case 10: return launch_cluster_tr<10>(p, a, s);
    default: return launch_cluster_tr<12>(p, a, s);
  }
}

}  // namespace

extern "C" {

// Floats of device workspace rsvd_polar_f32 needs for an m x l panel.
size_t rsvd_polar_workspace_floats(int m, int l) {
  if (m <= 0 || l <= 0) return 0;
  size_t most = 0;
  const int sizes[] = {2, 4, kPortableCluster, kWideCluster};
  for (int cluster : sizes) {
    const size_t n = make_plan(m, l, cluster).total_floats;
    if (n > most) most = n;
  }
  return most;
}

// Sets the blocks of ns_cluster's cluster (2, 4, 8 or 16, or 0 for the
// default: 16 where the card runs such a cluster, else 8) and returns the
// previous value; any other value changes nothing.  For measuring the
// design; the package never calls it.
int rsvd_polar_set_cluster(int cluster) {
  const int prev = g_cluster;
  if (cluster == 0 || cluster == 2 || cluster == 4 || cluster == 8 ||
      cluster == 16)
    g_cluster = cluster;
  return prev;
}

// K2's plan at (m, l): out = {cluster path (1) or one block (0), blocks of
// the cluster, rows a block owns, Gram blocks, partial Grams, shared-memory
// bytes of the iteration}.
void rsvd_polar_plan(int m, int l, long long* out) {
  const Plan p = resolve_plan(m, l);
  out[0] = p.clustered;
  out[1] = p.clustered ? p.cluster : 1;
  out[2] = p.clustered ? p.band : l;
  out[3] = p.gram.narrow
               ? p.gram.blocks
               : (long long)p.gram.tiles * p.gram.tiles * p.gram.nparts;
  out[4] = p.gram.nparts;
  out[5] = (long long)p.smem_bytes;
}

// Launches (a)-(c) on `stream` (only (a) and (b) when stage >= 0);
// `coeffs` holds 3 * iters floats on the host.  Returns the first CUDA
// error (0 = launched).
int rsvd_polar_f32(const float* y, float* q, float* r, float* work, int m,
                   int l, const float* coeffs, int iters, int stage,
                   void* stream) {
  if (m <= 0 || l <= 0) return 0;
  if (iters < 1 || iters > kMaxIters || stage > 2 + iters)
    return (int)cudaErrorInvalidValue;
  const Plan p = resolve_plan(m, l);
  Args a = {};
  for (int k = 0; k < iters; ++k)
    for (int c = 0; c < 3; ++c) a.sch.abc[k][c] = coeffs[3 * k + c];
  a.part = work;
  a.nparts = p.gram.nparts;
  a.r = r;
  a.ws = work + p.ws_off;
  a.l = l;
  a.iters = iters;
  a.stage = stage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = panel::launch_gram(y, work, m, l, p.gram, s);
  if (err == cudaSuccess) err = launch_iteration(p, a, work, s);
  if (err == cudaSuccess && stage < 0)
    err = panel::launch_apply<false, false>(y, a.ws, q, m, l, s);
  return (int)err;
}

}  // extern "C"
