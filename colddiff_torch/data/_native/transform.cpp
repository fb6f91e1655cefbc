// Host-side input-pipeline helpers of colddiff_torch's loaders.
//
// The per-image host work of the loaders -- crop + horizontal flip + uint8
// -> float32 [-1, 1] scaling -- is fused into single passes here, so the
// DataLoader's threads assemble a batch for the card without one numpy
// array per stage.  The arithmetic is the JAX package's
// (colddiff/data/_native/transform.cpp) line for line, so both packages'
// loaders give the same bits.  Bound via ctypes (colddiff_torch/data/native.py),
// which builds it with `g++ -O3 -march=native -shared -fPIC` at first use.
//
// Layout contract: images are HWC uint8 (PIL memory order); outputs are
// NHWC float32 in [-1, 1].

#include <cstdint>
#include <cstring>

extern "C" {

// Fused crop/flip/normalize for one image.
//   src:  [in_h, in_w, c] uint8
//   dst:  [size, size, c] float32
//   y0/x0: crop origin; flip: mirror horizontally.
void crop_flip_normalize(const uint8_t* src, int in_h, int in_w, int c,
                         int y0, int x0, int size, int flip, float* dst) {
  const float scale = 2.0f / 255.0f;
  for (int y = 0; y < size; ++y) {
    const uint8_t* row = src + ((int64_t)(y0 + y) * in_w + x0) * c;
    float* out = dst + (int64_t)y * size * c;
    if (flip) {
      for (int x = 0; x < size; ++x) {
        const uint8_t* px = row + (int64_t)(size - 1 - x) * c;
        for (int k = 0; k < c; ++k) out[x * c + k] = px[k] * scale - 1.0f;
      }
    } else {
      const int64_t n = (int64_t)size * c;
      for (int64_t i = 0; i < n; ++i) out[i] = row[i] * scale - 1.0f;
    }
  }
}

// Batched variant: gathers n images (each with its own crop/flip) into one
// contiguous NHWC float32 batch.
//   srcs:   array of n pointers to [in_h, in_w, c] uint8 images
//   params: [n, 3] int32 rows of (y0, x0, flip)
void batch_crop_flip_normalize(const uint8_t** srcs, int n, int in_h, int in_w,
                               int c, const int32_t* params, int size,
                               float* dst) {
  const int64_t stride = (int64_t)size * size * c;
  for (int i = 0; i < n; ++i) {
    crop_flip_normalize(srcs[i], in_h, in_w, c, params[i * 3 + 0],
                        params[i * 3 + 1], size, params[i * 3 + 2],
                        dst + i * stride);
  }
}

// Reflect-101-free simple zero pad + crop used by the CIFAR augmentation
// (pad 4, random crop, optional flip) fused into one pass.
void pad4_crop_flip_normalize(const uint8_t* src, int h, int w, int c, int y0,
                              int x0, int flip, float* dst) {
  // output is [h, w, c]; source coordinates are offset by the pad
  const float scale = 2.0f / 255.0f;
  for (int y = 0; y < h; ++y) {
    int sy = y0 + y - 4;
    float* out = dst + (int64_t)y * w * c;
    for (int x = 0; x < w; ++x) {
      int ox = flip ? (w - 1 - x) : x;
      int sx = x0 + ox - 4;
      float* px_out = out + (int64_t)x * c;
      if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
        for (int k = 0; k < c; ++k) px_out[k] = -1.0f;  // zero pixel -> -1
      } else {
        const uint8_t* px = src + ((int64_t)sy * w + sx) * c;
        for (int k = 0; k < c; ++k) px_out[k] = px[k] * scale - 1.0f;
      }
    }
  }
}

}  // extern "C"
