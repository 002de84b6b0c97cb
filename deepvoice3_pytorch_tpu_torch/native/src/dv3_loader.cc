// Threaded .npy batch loader + padded collate.
//
// A copy of the JAX package's deepvoice3_pytorch_tpu/native/src/
// dv3_loader.cc for the PyTorch port.
// Native equivalent of the reference's DataLoader worker processes
// (reference train.py:965-968, _NPYDataSource train.py:149-173): reads the
// preprocessor's float32 .npy feature files on a thread pool and packs them
// into a single zero-padded (B, T_max, C) batch buffer, so the Python input
// pipeline does one ctypes call per batch instead of B numpy file reads +
// a pad-and-stack pass.
//
// Supports .npy format versions 1.0/2.0, little-endian float32 ('<f4'),
// C-order, 1-D or 2-D arrays.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long rows = 0;
  long cols = 1;
  long header_bytes = 0;
  bool ok = false;
};

// Parse the npy header enough to get dtype/shape. Returns ok=false on any
// unsupported layout.
NpyInfo parse_header(FILE* f) {
  NpyInfo info;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8) return info;
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  const int major = magic[6];
  long header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) return info;
    header_len = b[0] | (b[1] << 8);
    info.header_bytes = 10 + header_len;
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) return info;
    header_len = static_cast<long>(b[0]) | (static_cast<long>(b[1]) << 8) |
                 (static_cast<long>(b[2]) << 16) |
                 (static_cast<long>(b[3]) << 24);
    info.header_bytes = 12 + header_len;
  }
  std::string hdr(header_len, '\0');
  if (std::fread(&hdr[0], 1, header_len, f) !=
      static_cast<std::size_t>(header_len))
    return info;
  if (hdr.find("'descr': '<f4'") == std::string::npos &&
      hdr.find("\"descr\": \"<f4\"") == std::string::npos)
    return info;
  if (hdr.find("'fortran_order': False") == std::string::npos &&
      hdr.find("\"fortran_order\": false") == std::string::npos)
    return info;
  const auto sp = hdr.find("'shape':");
  const auto sp2 = (sp == std::string::npos) ? hdr.find("\"shape\":") : sp;
  if (sp2 == std::string::npos) return info;
  const auto lp = hdr.find('(', sp2);
  const auto rp = hdr.find(')', sp2);
  if (lp == std::string::npos || rp == std::string::npos) return info;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  long dims[2] = {0, 1};
  int nd = 0;
  const char* p = shape.c_str();
  while (*p && nd < 2) {
    while (*p == ' ' || *p == ',') ++p;
    if (*p < '0' || *p > '9') break;
    dims[nd++] = std::strtol(p, const_cast<char**>(&p), 10);
  }
  if (nd == 0) return info;
  info.rows = dims[0];
  info.cols = (nd == 2) ? dims[1] : 1;
  info.ok = true;
  return info;
}

}  // namespace

extern "C" {

// Probe one npy file: writes [rows, cols] into shape_out. Returns 0 on
// success, nonzero on unsupported/missing file.
int dv3_npy_shape(const char* path, long* shape_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  const NpyInfo info = parse_header(f);
  std::fclose(f);
  if (!info.ok) return 2;
  shape_out[0] = info.rows;
  shape_out[1] = info.cols;
  return 0;
}

// Load n_items npy files (all with the same column count `cols`) into a
// zero-initialized (n_items, max_rows, cols) float32 buffer `out`, each
// item's data starting at row `row_offset` (the collate b_pad region stays
// zero — reference train.py:324-330), recording each item's row count in
// rows_out. Skips (leaves zero, rows=-1) any file that fails to parse.
// Returns the number of successful loads.
int dv3_load_padded_batch(const char** paths, int n_items, long max_rows,
                          long cols, long row_offset, float* out,
                          long* rows_out, int n_threads) {
  std::memset(out, 0,
              sizeof(float) * static_cast<std::size_t>(n_items) * max_rows *
                  cols);
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min(n_threads, std::max(n_items, 1));
  std::atomic<int> next{0}, ok{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n_items; i = next.fetch_add(1)) {
        rows_out[i] = -1;
        FILE* f = std::fopen(paths[i], "rb");
        if (!f) continue;
        const NpyInfo info = parse_header(f);
        // A file longer than the padded buffer would be silently truncated
        // while rows_out reported the full count; treat it as a failure so
        // the caller falls back to the (loud) numpy collate path.
        if (!info.ok || info.cols != cols || info.rows > max_rows - row_offset) {
          std::fclose(f);
          continue;
        }
        const long rows = info.rows;
        float* dst =
            out + (static_cast<long>(i) * max_rows + row_offset) * cols;
        const std::size_t want = static_cast<std::size_t>(rows) * cols;
        if (std::fread(dst, sizeof(float), want, f) == want) {
          rows_out[i] = info.rows;
          ok.fetch_add(1);
        }
        std::fclose(f);
      }
    });
  }
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // extern "C"
