// Native host-side data plane of the port's host loader (a copy of the JAX
// package's pytorch_cifar_tpu/native/cifar_native.cpp).
//
// The per-batch host work (index gather, CIFAR binary record decode,
// optional CPU-side augmentation) in C++ with OpenMP, exposed over a flat C
// ABI consumed through ctypes. On-device augmentation (data/augment.py)
// stays the default; these paths feed the host loader its uint8 batches.
//
// Built at first use by __init__.py (g++ -O3 -fopenmp -shared -fPIC) into
// native/build/.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Gather `batch` images of `image_bytes` bytes each from `images` at
// `idx[0..batch)` into contiguous `out`. Parallel memcpy — the hot host op
// feeding every training step.
void gather_batch(const uint8_t* images, const int32_t* idx, int64_t batch,
                  int64_t image_bytes, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out + b * image_bytes,
                images + static_cast<int64_t>(idx[b]) * image_bytes,
                static_cast<size_t>(image_bytes));
  }
}

// Gather labels (int32) — trivial, but keeps the whole batch assembly in one
// native pass when called alongside gather_batch.
void gather_labels(const int32_t* labels, const int32_t* idx, int64_t batch,
                   int32_t* out) {
  for (int64_t b = 0; b < batch; ++b) out[b] = labels[idx[b]];
}

// Decode CIFAR-10 binary records (the cifar-10-binary.tar.gz layout:
// 1 label byte + 3072 planar CHW bytes per record) into NHWC uint8 images
// + int32 labels. The planar->interleaved transpose is the real decode work
// torchvision does per sample in Python/PIL.
void decode_cifar_records(const uint8_t* records, int64_t n, uint8_t* images,
                          int32_t* labels) {
  const int64_t kRecord = 3073;  // 1 + 3*32*32
  const int64_t kPlane = 1024;   // 32*32
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* rec = records + i * kRecord;
    labels[i] = rec[0];
    const uint8_t* px = rec + 1;
    uint8_t* out = images + i * 3 * kPlane;
    for (int64_t p = 0; p < kPlane; ++p) {
      out[p * 3 + 0] = px[p];
      out[p * 3 + 1] = px[kPlane + p];
      out[p * 3 + 2] = px[2 * kPlane + p];
    }
  }
}

// Host augmentation: zero-pad by `padding`, crop at per-image offsets
// (off_h, off_w), optional horizontal flip. uint8 in/out, NHWC. The same
// crop and flip as data/augment.py's device path.
void augment_batch_u8(const uint8_t* in, int64_t n, int64_t h, int64_t w,
                      int64_t c, int64_t padding, const int32_t* off_h,
                      const int32_t* off_w, const uint8_t* flip,
                      uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n; ++b) {
    const uint8_t* img = in + b * h * w * c;
    uint8_t* dst = out + b * h * w * c;
    const int64_t dy = off_h[b] - padding;  // source row of output row 0
    const int64_t dx = off_w[b] - padding;
    const bool fl = flip[b] != 0;
    for (int64_t y = 0; y < h; ++y) {
      const int64_t sy = y + dy;
      if (sy < 0 || sy >= h) {
        std::memset(dst + y * w * c, 0, static_cast<size_t>(w * c));
        continue;
      }
      for (int64_t x = 0; x < w; ++x) {
        const int64_t ox = fl ? (w - 1 - x) : x;
        const int64_t sx = x + dx;
        uint8_t* px = dst + (y * w + ox) * c;
        if (sx < 0 || sx >= w) {
          std::memset(px, 0, static_cast<size_t>(c));
        } else {
          std::memcpy(px, img + (sy * w + sx) * c, static_cast<size_t>(c));
        }
      }
    }
  }
}

int native_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
