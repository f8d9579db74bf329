// The counter-based uint32 hash shared by K4 (sketch.cu) and K5b
// (quantize.cu): the murmur3 finalizer of the TPU kernels'
// pallas_kernels.py::_mix.  uint32 arithmetic wraps as JAX's does, so a
// draw keyed on (seed, global index) is the same on every backend and
// launch shape.

#pragma once

#include <cstdint>

namespace rsvd_hash {

__host__ __device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace rsvd_hash
