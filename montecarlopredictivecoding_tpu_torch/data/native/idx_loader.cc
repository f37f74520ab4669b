// Native data-loader runtime for montecarlopredictivecoding_tpu_torch (the
// port's own copy of the JAX package's data/native/idx_loader.cc).
//
// The host side of the input pipeline (IDX parsing, preprocessing, batch
// gather) is a small C++ library bound via ctypes (data/native_loader.py),
// so feeding the GPU never waits on per-item Python:
//
//   * idx_read_header / idx_read_data — big-endian IDX (MNIST) file reader;
//   * preprocess_images — threaded uint8 -> float32 conversion with the
//     reference's three modes: scale to [0,1], binarize at a threshold
//     (BinaryMNIST), normalize to [-1,1] (Normalize(0.5, 0.5));
//   * gather_batch — threaded row gather for shuffled minibatches.
//
// Build (native_loader.py does it on first use, into build/torch_native/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libidx_loader.so idx_loader.cc -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

uint32_t read_be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int n_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw == 0 ? 4 : static_cast<int>(hw);
}

template <typename F>
void parallel_for(int64_t n, F body) {
  int threads = n_threads();
  if (n < 1 << 14 || threads <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Parse an IDX header. Returns 0 on success; fills ndim_out and up to 4
// dims in shape_out. data_offset_out is the byte offset of the payload.
int idx_read_header(const char* path, int64_t* shape_out, int* ndim_out,
                    int64_t* data_offset_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4) {
    std::fclose(f);
    return -2;
  }
  if (hdr[0] != 0 || hdr[1] != 0) {
    std::fclose(f);
    return -3;  // bad magic
  }
  if (hdr[2] != 0x08) {
    std::fclose(f);
    return -4;  // only uint8 payloads (MNIST)
  }
  int ndim = hdr[3];
  if (ndim < 1 || ndim > 4) {
    std::fclose(f);
    return -5;
  }
  for (int i = 0; i < ndim; ++i) {
    unsigned char dim[4];
    if (std::fread(dim, 1, 4, f) != 4) {
      std::fclose(f);
      return -6;
    }
    shape_out[i] = read_be32(dim);
  }
  *ndim_out = ndim;
  *data_offset_out = 4 + 4 * ndim;
  std::fclose(f);
  return 0;
}

// Read the uint8 payload (size bytes) starting at offset.
int idx_read_data(const char* path, int64_t offset, uint8_t* out,
                  int64_t size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  size_t got = std::fread(out, 1, static_cast<size_t>(size), f);
  std::fclose(f);
  return got == static_cast<size_t>(size) ? 0 : -3;
}

// uint8 -> float32 with the reference preprocessing modes:
//   mode 0: x / 255                               (raw [0,1])
//   mode 1: (x / 255 > threshold) ? 1 : 0         (BinaryMNIST)
//   mode 2: (x / 255 - 0.5) / 0.5                 (Normalize(0.5, 0.5))
void preprocess_images(const uint8_t* src, float* dst, int64_t n, int mode,
                       float threshold) {
  const float inv = 1.0f / 255.0f;
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    switch (mode) {
      case 1:
        for (int64_t i = lo; i < hi; ++i)
          dst[i] = (src[i] * inv > threshold) ? 1.0f : 0.0f;
        break;
      case 2:
        for (int64_t i = lo; i < hi; ++i)
          dst[i] = (src[i] * inv - 0.5f) * 2.0f;
        break;
      default:
        for (int64_t i = lo; i < hi; ++i) dst[i] = src[i] * inv;
    }
  });
}

// Gather rows: out[i, :] = data[idx[i], :], threaded over rows.
void gather_batch(const float* data, const int32_t* idx, float* out,
                  int64_t batch, int64_t dim) {
  parallel_for(batch, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * dim, data + static_cast<int64_t>(idx[i]) * dim,
                  sizeof(float) * static_cast<size_t>(dim));
    }
  });
}

}  // extern "C"
