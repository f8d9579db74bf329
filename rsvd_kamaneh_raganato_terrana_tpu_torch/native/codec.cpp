// Quantized factor codec for compressed-image persistence.
//
// The reference stores SVD factors at 1 byte/entry by integer truncation
// (`static_cast<int>(value) & 0xFF`, image_compression/src/image_com.cpp:
// 94-118), which destroys fractional values and wraps negatives.  This codec
// keeps the 1-byte storage cost but uses per-tensor affine quantization
// (uint8 = round((x - min) / scale)), which is lossless to ~0.4% of dynamic
// range and reversible.  A "truncate" mode reproduces the reference's exact
// byte semantics for parity testing.
//
// File layout (little-endian, written by apps/image.py):
//   magic  "RSV2"                 (4 bytes)
//   mode   uint8  (0=affine, 1=truncate)
//   tiled  uint8  (1 = tile-compressed)
//   k      int32  number of tensors
//   [if tiled: gy gx m n as int64 — exact tile grid + original shape]
//   per tensor: ndim int32, dims int64[ndim], scale f64, offset f64,
//               payload uint8[prod(dims)]

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Affine-quantize n doubles to bytes. Returns scale/offset through pointers.
void codec_quantize_affine(const double* x, int64_t n, uint8_t* out,
                           double* scale, double* offset) {
  double lo = x[0], hi = x[0];
  for (int64_t i = 1; i < n; ++i) {
    lo = x[i] < lo ? x[i] : lo;
    hi = x[i] > hi ? x[i] : hi;
  }
  double s = (hi - lo) / 255.0;
  if (s == 0.0) s = 1.0;
  *scale = s;
  *offset = lo;
  double inv = 1.0 / s;
  for (int64_t i = 0; i < n; ++i) {
    double q = std::nearbyint((x[i] - lo) * inv);
    q = q < 0 ? 0 : (q > 255 ? 255 : q);
    out[i] = static_cast<uint8_t>(q);
  }
}

void codec_dequantize_affine(const uint8_t* q, int64_t n, double scale,
                             double offset, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = q[i] * scale + offset;
}

// Reference-compatible byte truncation (image_com.cpp:97-99).
void codec_quantize_truncate(const double* x, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint8_t>(static_cast<int>(x[i]) & 0xFF);
  }
}

void codec_dequantize_truncate(const uint8_t* q, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = static_cast<double>(q[i]);
}

}  // extern "C"
