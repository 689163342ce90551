// Native motion-batch loader of the PyTorch port: .npy parsing + crop +
// z-normalize + pad, multithreaded (a carried copy of the JAX package's
// mld_tpu/native/loader.cc, equal to it below this comment). It is host
// code: the batches it writes are the numpy collator's, and the card never
// runs it.
//
// C ABI (ctypes):
//   mld_load_batch(paths, n, starts, crops, max_len, mean, stddev, nfeats,
//                  out_motion, out_lengths, num_threads) -> 0 on success
//   mld_read_npy_header(path, &rows, &cols)              -> 0 on success

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long header_offset = 0;
  long rows = 0;
  long cols = 0;
  bool fortran = false;
  int word_size = 4;  // f4 or f8
};

// Minimal .npy v1/v2 header parser for little-endian float arrays.
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->header_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info->header_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    size_t end = header.find_first_of(",}", p);
    return header.substr(p + 1, end - p - 1);
  };

  std::string descr = find_val("'descr'");
  if (descr.find("f4") != std::string::npos) info->word_size = 4;
  else if (descr.find("f8") != std::string::npos) info->word_size = 8;
  else return false;
  info->fortran = find_val("'fortran_order'").find("True") !=
                  std::string::npos;
  if (info->fortran) return false;  // C-order only

  size_t p = header.find("'shape'");
  p = header.find('(', p);
  size_t end = header.find(')', p);
  std::string shape = header.substr(p + 1, end - p - 1);
  long dims[2] = {1, 1};
  int nd = 0;
  char* cursor = &shape[0];
  while (nd < 2) {
    char* next = nullptr;
    long v = strtol(cursor, &next, 10);
    if (next == cursor) break;
    dims[nd++] = v;
    cursor = next;
    while (*cursor == ',' || *cursor == ' ') cursor++;
  }
  info->rows = dims[0];
  info->cols = nd > 1 ? dims[1] : 1;
  return true;
}

// Read rows [start, start+count) of a 2-D float npy into out (f4).
bool read_npy_rows(const char* path, long start, long count, long expect_cols,
                   float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.cols != expect_cols ||
      start + count > info.rows) {
    fclose(f);
    return false;
  }
  long row_bytes = info.cols * info.word_size;
  if (fseek(f, info.header_offset + start * row_bytes, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  if (info.word_size == 4) {
    size_t want = static_cast<size_t>(count) * info.cols;
    size_t got = fread(out, 4, want, f);
    fclose(f);
    return got == want;
  }
  // f8: convert
  std::vector<double> buf(count * info.cols);
  size_t got = fread(buf.data(), 8, buf.size(), f);
  fclose(f);
  if (got != buf.size()) return false;
  for (size_t i = 0; i < buf.size(); ++i) out[i] = float(buf[i]);
  return true;
}

}  // namespace

extern "C" {

int mld_read_npy_header(const char* path, long* rows, long* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  NpyInfo info;
  bool ok = parse_npy_header(f, &info);
  fclose(f);
  if (!ok) return 2;
  *rows = info.rows;
  *cols = info.cols;
  return 0;
}

// Assemble a normalized, padded batch.
//   paths[i]: npy file with [T_i, nfeats] features
//   starts[i], crops[i]: crop window
//   out_motion: [n, max_len, nfeats] zero-initialized by callee
//   out_lengths: [n]
int mld_load_batch(const char** paths, int n, const int* starts,
                   const int* crops, int max_len, const float* mean,
                   const float* stddev, int nfeats, float* out_motion,
                   int* out_lengths, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    std::vector<float> tmp;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int len = crops[i] < max_len ? crops[i] : max_len;
      out_lengths[i] = len;
      float* dst = out_motion + static_cast<size_t>(i) * max_len * nfeats;
      memset(dst, 0, sizeof(float) * max_len * nfeats);
      tmp.resize(static_cast<size_t>(len) * nfeats);
      if (!read_npy_rows(paths[i], starts[i], len, nfeats, tmp.data())) {
        failed.store(1);
        continue;
      }
      for (long t = 0; t < len; ++t) {
        const float* src = tmp.data() + t * nfeats;
        float* row = dst + t * nfeats;
        for (int c = 0; c < nfeats; ++c) {
          row[c] = (src[c] - mean[c]) / stddev[c];
        }
      }
    }
  };

  int threads = num_threads > 0 ? num_threads : 4;
  if (threads > n) threads = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failed.load();
}

}  // extern "C"
