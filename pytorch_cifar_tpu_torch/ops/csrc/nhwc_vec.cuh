// Helpers shared by the NHWC stencil kernels (max_pool.cu,
// depthwise_stencil.cu): element types by their storage, naturally aligned
// vector loads and stores of V channels, and their copies into a
// shared-memory tile.

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

// BYTES global -> shared, zero-filled when !ok (src is then not read)
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (BYTES == 8 || BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
                 : "memory");
  } else {
    using R = typename Raw<BYTES>::type;
    *static_cast<R*>(dst) = ok ? *static_cast<const R*>(src) : R(0);
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace
