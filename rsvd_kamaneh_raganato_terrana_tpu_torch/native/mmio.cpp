// Fast MatrixMarket parser/writer for the host-side data-loading path.
//
// The reference's I/O layer is Eigen loadMarket/saveMarket called from C++
// test mains (tests/rSVD_test.cpp:54-57,108-115).  In the TPU framework the
// compute path is JAX; the host runtime around it (file ingest before
// device_put, result export for the NumPy oracle harness) is this native
// library, exposed to Python through ctypes (native/__init__.py).
//
// Build: make -C native   (produces librsvd_native.so)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Parse a MatrixMarket file (coordinate or array, real, general) into a
// freshly malloc'd row-major dense buffer.  Returns 0 on success.
int mmio_read(const char* path, double** out_data, int64_t* out_rows,
              int64_t* out_cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  // Read whole file into memory: the files are small-to-medium and this
  // keeps the tokenizer branch-free and fast.
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  const char* p = buf.c_str();
  const char* end = p + buf.size();

  // Header line (case-insensitive qualifiers).
  if (std::strncmp(p, "%%MatrixMarket", 14) != 0) return 3;
  const char* line_end = static_cast<const char*>(std::memchr(p, '\n', end - p));
  if (!line_end) return 3;
  std::string header(p, line_end - p);
  for (char& ch : header) ch = static_cast<char>(std::tolower(ch));
  bool array_fmt = header.find("array") != std::string::npos;
  // symmetric files store one triangle only; mirror after filling.
  bool skew = header.find("skew-symmetric") != std::string::npos;
  bool symmetric = !skew && header.find("symmetric") != std::string::npos;
  if (header.find("hermitian") != std::string::npos ||
      header.find("complex") != std::string::npos)
    return 7;  // unsupported field/symmetry
  if (array_fmt && (symmetric || skew))
    return 7;  // array-symmetric stores a packed triangle: unsupported
  p = line_end + 1;

  // Skip comments.
  while (p < end && *p == '%') {
    line_end = static_cast<const char*>(std::memchr(p, '\n', end - p));
    if (!line_end) return 3;
    p = line_end + 1;
  }

  char* next = nullptr;
  int64_t rows = std::strtoll(p, &next, 10);
  p = next;
  int64_t cols = std::strtoll(p, &next, 10);
  p = next;
  int64_t nnz = 0;
  if (!array_fmt) {
    nnz = std::strtoll(p, &next, 10);
    p = next;
  }
  if (rows <= 0 || cols <= 0) return 4;

  double* data =
      static_cast<double*>(std::calloc(static_cast<size_t>(rows * cols), sizeof(double)));
  if (!data) return 5;

  if (array_fmt) {
    // Column-major dense listing.
    for (int64_t j = 0; j < cols; ++j) {
      for (int64_t i = 0; i < rows; ++i) {
        data[i * cols + j] = std::strtod(p, &next);
        if (next == p) { std::free(data); return 6; }
        p = next;
      }
    }
  } else {
    for (int64_t k = 0; k < nnz; ++k) {
      int64_t i = std::strtoll(p, &next, 10);
      p = next;
      int64_t j = std::strtoll(p, &next, 10);
      p = next;
      double v = std::strtod(p, &next);
      p = next;
      if (i < 1 || i > rows || j < 1 || j > cols) { std::free(data); return 6; }
      data[(i - 1) * cols + (j - 1)] = v;
    }
  }

  if ((symmetric || skew) && rows == cols) {
    double sign = skew ? -1.0 : 1.0;
    for (int64_t i = 0; i < rows; ++i) {
      for (int64_t j = 0; j < i; ++j) {
        double lower = data[i * cols + j];
        double upper = data[j * cols + i];
        // one triangle is stored; mirror whichever side is present
        if (lower != 0.0 && upper == 0.0) data[j * cols + i] = sign * lower;
        else if (upper != 0.0 && lower == 0.0) data[i * cols + j] = sign * upper;
      }
    }
  }

  *out_data = data;
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

void mmio_free(double* data) { std::free(data); }

// Write a row-major dense buffer in coordinate format (nonzeros only),
// matching the layout of Eigen saveMarket output.
int mmio_write(const char* path, const double* data, int64_t rows,
               int64_t cols) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  std::fputs("%%MatrixMarket matrix coordinate real general\n", f);

  int64_t nnz = 0;
  for (int64_t i = 0; i < rows * cols; ++i) nnz += (data[i] != 0.0);
  std::fprintf(f, "%lld %lld %lld\n", static_cast<long long>(rows),
               static_cast<long long>(cols), static_cast<long long>(nnz));

  for (int64_t i = 0; i < rows; ++i) {
    for (int64_t j = 0; j < cols; ++j) {
      double v = data[i * cols + j];
      if (v != 0.0) {
        std::fprintf(f, "%lld %lld %.18e\n", static_cast<long long>(i + 1),
                     static_cast<long long>(j + 1), v);
      }
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
