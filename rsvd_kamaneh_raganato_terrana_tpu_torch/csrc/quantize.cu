// Kernel K5: affine uint8 quantization of an f32 tensor of any shape,
// deterministic (K5a) or with stochastic rounding (K5b), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels in
//   rsvd_kamaneh_raganato_terrana_tpu/linalg/pallas_kernels.py
//   quantize_uint8 / _quantize_kernel (K5a) / _quantize_sr_kernel (K5b).
// Given x (n f32 values, flat), lo = min(x) and scale = max((max(x) -
// lo) / 255, FLT_MIN) as device scalars (the caller's reduction, outside
// the kernel as in the TPU version), it writes
//   K5a: q = clamp(rint((x - lo) * (1 / scale)), 0, 255)
//   K5b: q = clamp(floor(s) + (u < s - floor(s)), 0, 255),
//        s = (x - lo) * (1 / scale),
// as uint8.  Each operation is rounded alone (__fsub_rn, __fmul_rn: no
// FMA contraction, no fast math) and rintf rounds half to even, as
// jnp.round and torch.round do, so the kernel is bitwise its plain
// PyTorch version.  K5b's u cannot be the TPU's per-block PRNG bits: it is
// the murmur3 hash of (seed, flat index mod 2^32), h = mix(idx ^
// mix(seed)), u = (h >> 8) 2^-24 in [0, 1) -- the index scheme of the TPU
// sketch kernel's _gaussian_tile -- so the draw does not depend on the
// launch shape, on the tensor's shape, or on the device.
//
// What bounds it.  4 bytes read and 1 byte written per element: at
// 16384^2 that is 1.34 GB, 0.40 ms at the card's 3.35 TB/s.  K5b adds
// ~20 integer operations per element for the hash, which should stay
// under the memory time.  The kernel is a grid-stride loop over float4
// groups (16-byte loads, 4-byte stores, 64-bit indices); the n % 4 tail
// elements go to the first threads of block 0.  No padding of x in
// device memory, no host synchronization: lo and scale are read through
// pointers.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "panel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks for each of 132 SMs

template <bool kStochastic>
__device__ __forceinline__ uint8_t quantize_one(float x, float lo, float inv,
                                                unsigned long long idx,
                                                uint32_t seed_mix) {
  const float scaled = __fmul_rn(__fsub_rn(x, lo), inv);
  float q;
  if (kStochastic) {
    const float fl = floorf(scaled);
    const float frac = __fsub_rn(scaled, fl);
    const uint32_t h = rsvd_hash::mix((uint32_t)idx ^ seed_mix);
    const float u = __fmul_rn((float)(int)(h >> 8), 1.0f / 16777216.0f);
    q = __fadd_rn(fl, u < frac ? 1.0f : 0.0f);
  } else {
    q = rintf(scaled);
  }
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  return (uint8_t)(int)q;
}

template <bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quantize_u8(const float* __restrict__ x, uint8_t* __restrict__ q,
            long long n, const float* __restrict__ lo_p,
            const float* __restrict__ scale_p, uint32_t seed_mix) {
  const float lo = *lo_p;
  const float inv = 1.0f / *scale_p;  // IEEE division, once per thread
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  uchar4* q4 = reinterpret_cast<uchar4*>(q);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const float4 v = x4[i];
    const unsigned long long e = 4ull * (unsigned long long)i;
    uchar4 o;
    o.x = quantize_one<kStochastic>(v.x, lo, inv, e, seed_mix);
    o.y = quantize_one<kStochastic>(v.y, lo, inv, e + 1, seed_mix);
    o.z = quantize_one<kStochastic>(v.z, lo, inv, e + 2, seed_mix);
    o.w = quantize_one<kStochastic>(v.w, lo, inv, e + 3, seed_mix);
    q4[i] = o;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long e = 4 * n4 + threadIdx.x;
    q[e] = quantize_one<kStochastic>(x[e], lo, inv, (unsigned long long)e,
                                     seed_mix);
  }
}

}  // namespace

extern "C" {

// Launches K5a (stochastic = 0) or K5b on `stream` over the n values of x
// (16-byte aligned; q 4-byte aligned); returns cudaGetLastError() (0 =
// launched).  `seed` is the seed's two's-complement uint32.
int rsvd_quantize_u8_f32(const float* x, uint8_t* q, long long n,
                         const float* lo, const float* scale, int stochastic,
                         uint32_t seed, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (stochastic) {
    quantize_u8<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, q, n, lo, scale, rsvd_hash::mix(seed));
  } else {
    quantize_u8<false><<<(unsigned)blocks, kThreads, 0, s>>>(x, q, n, lo,
                                                             scale, 0u);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
