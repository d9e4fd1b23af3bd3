// Helpers shared by the NHWC stencil kernels (max_pool.cu,
// depthwise_stencil.cu): element types by their storage, naturally aligned
// vector loads and stores of V channels, and the thread -> (pixel, channel
// vector) decode of a one-thread-per-(pixel, vector) grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// element types by their storage: bf16 travels as its 16 bits
struct BF16 {
  using S = uint16_t;
  static __device__ __forceinline__ float to_float(S s) {
    return __uint_as_float(static_cast<uint32_t>(s) << 16);
  }
  static __device__ __forceinline__ S from_float(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  static __device__ __forceinline__ S neg_inf() { return 0xFF80; }
};

struct F32 {
  using S = float;
  static __device__ __forceinline__ float to_float(S s) { return s; }
  static __device__ __forceinline__ S from_float(float f) { return f; }
  static __device__ __forceinline__ S neg_inf() { return -INFINITY; }
};

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };
template <>
struct Raw<1> { using type = uint8_t; };

// V elements of S moved as one naturally aligned load or store
template <typename S, int V>
union Pack {
  typename Raw<V * sizeof(S)>::type raw;
  S v[V];
};

template <typename S, int V>
__device__ __forceinline__ Pack<S, V> load(const S* p) {
  Pack<S, V> r;
  r.raw = *reinterpret_cast<const typename Raw<V * sizeof(S)>::type*>(p);
  return r;
}

template <typename S, int V>
__device__ __forceinline__ void store(S* p, const Pack<S, V>& r) {
  *reinterpret_cast<typename Raw<V * sizeof(S)>::type*>(p) = r.raw;
}

// thread i -> (global pixel index, y, x, first channel of its vector)
struct Where {
  long long pix;
  int y, x, c0;
};

template <int V>
__device__ __forceinline__ Where decode(long long i, int h, int w, int c) {
  const int cv = c / V;
  Where p;
  p.c0 = static_cast<int>(i % cv) * V;
  p.pix = i / cv;
  p.x = static_cast<int>(p.pix % w);
  p.y = static_cast<int>((p.pix / w) % h);
  return p;
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// blocks of `threads` for one thread per (pixel, vector of vec channels);
// 0 if the shape is not taken
inline long long blocks_for(int n, int h, int w, int c, int vec, int threads,
                            long long* total) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || vec <= 0 || c % vec != 0)
    return 0;
  *total = static_cast<long long>(n) * h * w * (c / vec);
  const long long blocks = (*total + threads - 1) / threads;
  return blocks > 2147483647LL ? 0 : blocks;
}

}  // namespace
