// Kernel K6: bf16(A) and the sketch Y = bf16(A) Omega in one pass over A,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The port rounds a 'default' call's f32 operand
// to bf16 once a call, in its first stage-A product
// (rsvd/driver.py::Bf16OnFirstUse); that product is the sketch Y = A Omega
// (n x l Omega, l <= 144).  Before, the cast was its own pass (read A at
// f32, write the copy) and the GEMM read the copy back.  K6 makes the copy
// and the product while each tile of A is on chip, so the copy is never
// read back: at 100000^2 and l = 144 the pass moves 60 GB (40 read, 20
// written) where the cast and the GEMM moved 80.
//
// Given A (m x n f32, row-major, contiguous) and Omega^T (l x n bf16,
// row-major) it writes a16 = bf16(A) (round to nearest even, the
// instruction torch's a.to(torch.bfloat16) runs on the card: bitwise the
// same copy) and Y = a16 Omega (m x l f32, accumulated in f32 by wgmma).
//
// What bounds it.  Bytes: 2 m n l FLOP at bf16 (2.9 TFLOP at 100000^2 and
// l = 144: 2.9 ms of the tensor cores) against 6 m n bytes (17.9 ms at
// 3.35 TB/s).  On an H100 80GB HBM3 (700 W) it took 21.5 ms there (2.80
// TB/s, 83% of that bound; torch's cast alone streamed 3.05), against 26.9
// ms for the cast and the GEMM it replaces.  It runs one block a 128-row
// tile, so a short A streams through few SMs: at 16 tiles it took 1.7-1.9x
// the pair's time (the driver routes such an A to the pair).
//
// Design.
//   - Persistent blocks, one an SM, each walking 128-row tiles of A
//     (tile = blockIdx.x + i gridDim.x), so one tile's epilogue (Y's
//     write) overlaps the next tile's loads.
//   - One producer warp issues TMA loads through a ring of kStages stages
//     in shared memory; a stage holds a 128 x 64 f32 tile of A (two boxes
//     of 32 columns, 128-byte swizzled) and the 64 x 144 bf16 tile of
//     Omega^T (one box, 128-byte swizzled; rows past l and columns past n
//     come in as zeros).  Omega's loads carry an L2 evict-last hint: it
//     (n l 2 bytes, 28.8 MB at the fit's shape) is read again by every
//     tile, while A and the copy stream through L2 once (on an H100 80GB
//     HBM3 at 50000 x 100000: 2.87 TB/s with the hint, 2.81 without).
//   - Two consumer warpgroups, 64 rows each.  A warpgroup reads its 64 x 64
//     f32 tile from the stage (conflict-free 16-byte reads: the 8 threads
//     of a quarter warp take 8 rows of one column chunk, which the swizzle
//     spreads over all banks), rounds it to bf16 and writes one 128-byte
//     swizzled 64 x 64 bf16 tile.  That tile is wgmma's A operand and the
//     source of a TMA store into a16: the copy costs no second read.
//   - Four wgmma m64n144k16 a stage, K-major A and B from shared memory,
//     the accumulator in registers (72 floats a thread) until the tile's
//     last stage; Y is written once, straight from the registers.  One
//     tile width, 144 (the fit's l), serves every l up to it: the pass is
//     bound by bytes, so the padded columns, which multiply zeros and are
//     not written, cost no time.
//   - The stage is released (its mbarrier, one arrival a consumer warp)
//     once the stage's wgmma have completed; the bf16 tile is reused once
//     the previous TMA store has read it.  The pass is bound by bytes, so
//     the wgmma of a stage are waited on at once: the other warpgroup's
//     conversion and the producer's loads run meanwhile.
// Ragged m and n come from TMA's bounds: loads past them read zeros,
// stores past them are dropped; Y's rows past m and columns past l are
// masked.  The wrapper (linalg/kernels.py::cast_sketch) takes n % 8 == 0
// (TMA's 16-byte strides of the bf16 rows) and 16-byte aligned operands.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "panel.cuh"

namespace {

constexpr int kBM = 128;                  // rows of a tile
constexpr int kBK = 64;                   // columns of A a stage
constexpr int kHalfBytes = kBM * 32 * 4;  // one 32-column f32 box
constexpr int kABytes = 2 * kHalfBytes;   // the stage's f32 tile of A
constexpr int kConsumers = 2;             // warpgroups of 64 rows
constexpr int kCopyBytes = 64 * kBK * 2;  // a warpgroup's bf16 tile
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kMaxStages = 4;
constexpr int kEmptyArrivals = 4 * kConsumers;  // one a consumer warp

constexpr int kBN = 144;                  // Omega's columns, l padded
constexpr int kWBytes = kBN * kBK * 2;    // the stage's Omega^T tile
constexpr int kStage = kABytes + kWBytes;
constexpr int kFixed = 1024 + kConsumers * kCopyBytes + 256;
constexpr int kFit = ((int)panel::kSmemMax - kFixed) / kStage;
constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
constexpr int kSmem = kFixed + kStages * kStage;
static_assert(kStages >= 2, "a ring needs two stages");
static_assert(kStage % 1024 == 0, "stages keep 1024-byte alignment");

// --- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of this parity; a wait that never ends (a fault)
// stops the kernel instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (i > (1LL << 26)) __trap();
  }
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_hint(uint32_t dst,
                                              const CUtensorMap* map, int x,
                                              int y, uint32_t bar,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the previous TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the previous TMA stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// two floats as one bf16x2 word, the first in the low half (its address
// comes first), each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzled layout TMA writes: rows of 128 bytes, 8-row groups 1024 bytes
// apart (stride 64 in 16-byte units), the leading offset unused (1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x 144, f32, 72 registers a thread) += A (64 x 16) B (16 x 144),
// both bf16 in shared memory; accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      uint32_t accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %74, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(accumulate));
}


// --- the kernel -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    cast_sketch_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_c,
                       float* __restrict__ y, int m, int n, int l) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  // stage s: A's two boxes at base + s kStage, Omega^T's tile after them;
  // then each warpgroup's bf16 tile; then the full and empty mbarriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t copies = base + S * kStage;
  const uint32_t bars = copies + kConsumers * kCopyBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };

  const int tiles = (m + kBM - 1) / kBM;
  const int ktiles = (n + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane != 0) return;
    const uint64_t keep = evict_last_policy();
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty(s), phase ^ 1u);
        mbar_expect(full(s), kStage);
        const uint32_t st = base + s * kStage;
        tma_load(st, &map_a, kt * kBK, tile * kBM, full(s));
        tma_load(st + kHalfBytes, &map_a, kt * kBK + 32, tile * kBM, full(s));
        tma_load_hint(st + kABytes, &map_w, kt * kBK, 0, full(s), keep);
        if (++s == S) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
  const int wg = warp >> 2, wi = warp & 3, t = threadIdx.x & 127;
  const uint32_t copy = copies + wg * kCopyBytes;
  // the conversion's items: row r (of the warpgroup's 64) and bf16 chunk
  // c (columns 8c .. 8c + 7); a quarter warp takes 8 rows of one chunk
  const int r0 = 16 * wi + (lane & 7), c0 = lane >> 3;
  const int sw = lane & 7;  // the swizzle's row phase, r & 7 for every item
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full(s), phase);
      const uint32_t st = base + s * kStage;
      float4 v[8];
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = r0 + 8 * (it & 1), c = c0 + 4 * (it >> 1);
        const int j = (2 * c) & 7;  // the first 16-byte f32 chunk in its box
        const uint32_t row = st + (c >> 2) * kHalfBytes + (64 * wg + r) * 128;
        v[2 * it] = lds128(row + ((j ^ sw) << 4));
        v[2 * it + 1] = lds128(row + (((j + 1) ^ sw) << 4));
      }
      if (t == 0) bulk_wait_read();  // the last store has read the tile
      warpgroup_sync(1 + wg);
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = r0 + 8 * (it & 1), c = c0 + 4 * (it >> 1);
        const float4 a = v[2 * it], b = v[2 * it + 1];
        sts128(copy + r * 128 + ((c ^ sw) << 4),
               make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                          pack_bf16(b.x, b.y), pack_bf16(b.z, b.w)));
      }
      fence_async_smem();
      warpgroup_sync(1 + wg);
      if (t == 0) {
        tma_store(&map_c, copy, kt * kBK, tile * kBM + 64 * wg);
        bulk_commit();
      }
      wgmma_fence();
      const uint64_t da = sw128_desc(copy), db = sw128_desc(st + kABytes);
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)  // 32 bytes of each row a step
        wgmma(acc, da + 2 * k, db + 2 * k, (kt > 0 || k > 0) ? 1u : 0u);
      wgmma_commit();
      wgmma_wait();
      if (lane == 0) mbar_arrive(empty(s));
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }
    // Y's rows of this warp: wgmma's accumulator holds rows lane / 4 and
    // lane / 4 + 8 of the warp's 16, columns 8 j + 2 (lane % 4) + {0, 1}
    const int row = tile * kBM + 64 * wg + 16 * wi + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= l) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row + 8 * h;
        if (rr >= m) continue;
        float* dst = y + (size_t)rr * l + col;
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        if (col + 1 < l && (l & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          dst[0] = x0;
          if (col + 1 < l) dst[1] = x1;
        }
      }
    }
  }
  if (t == 0) bulk_wait();
}

// --- the host side --------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major rows x cols map, boxes of box_rows x box_cols, 128-byte
// swizzled (box_cols x the element size is 128 bytes)
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* ptr, int rows, int cols, int box_rows,
              int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

extern "C" {

// Launches a16 = bf16(a) and y = a16 omega on `stream` (omega_t: Omega^T,
// l x n bf16, row-major); returns the first CUDA error (0 = launched).
// Takes 1 <= l <= 144, n % 8 == 0 and 16-byte aligned a, a16 and omega_t,
// else cudaErrorInvalidValue.
int rsvd_cast_sketch_bf16(const float* a, void* a16, const void* omega_t,
                          float* y, int m, int n, int l, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (l <= 0 || l > kBN || n % 8 != 0 || misaligned(a) || misaligned(a16) ||
      misaligned(omega_t))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_w, map_c;
  if (!make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, m, n, kBM,
                32) ||
      !make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, omega_t, l, n,
                kBN, kBK) ||
      !make_map(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a16, m, n, 64,
                kBK))
    return (int)cudaErrorInvalidValue;
  static bool sized[panel::kMaxDevices];
  cudaError_t err = panel::allow_smem_once(cast_sketch_kernel, sized);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (m + kBM - 1) / kBM;
  const int sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  return (int)panel::launch(cast_sketch_kernel, dim3(grid), kThreads,
                            (size_t)kSmem, static_cast<cudaStream_t>(stream),
                            0, map_a, map_w, map_c, y, m, n, l);
}

}  // extern "C"
