// Depthwise K x K / stride 1 / SAME convolution, NHWC, forward only.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/depthwise_stencil.py:
// depthwise_stencil (Pallas `_kernel`). Same function:
//   out[n, y, x, c] = sum_{dy, dx} x[n, y + dy - p, x + dx - p, c]
//                                  * w[dy, dx, c],   p = K / 2,
// zero outside the map, summed in fp32 in row-major tap order, one rounding
// to x's type. x is (n, h, w, c), w is (K, K, c) in x's type, K is 3, 5 or 7.
//
// Design (simple and right first):
// - One thread per (pixel, vector of V channels), taps read straight from
//   global memory. C is innermost, so a warp's threads sit on neighbouring
//   channels: every tap is one coalesced load of x and one of w, and the
//   K * K re-reads of neighbouring pixels come through L1/L2. Bounds checks
//   per tap make maps smaller than the halo (4x4, 2x2) nothing special.
// - V * elem is 16 bytes where C and the base pointers allow it, else 8, 4,
//   ... down to one element (the wrapper decides from data_ptr() and C):
//   C = 44 in bf16 has 88-byte pixels and runs with 8-byte vectors, C = 130
//   with 4-byte ones.
// - The TPU kernel's (nb, h, w, cb) VMEM tile, its in-tile zero pad and its
//   128-lane channel padding answered Mosaic's layout rules and have no
//   counterpart here.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): bytes at K = 3 (2 * s * E + K * K * C * s bytes against
// 2 * K * K * E operations), operations from K = 5 in bf16 (K * K / s > 10).
// What this design leaves on the table: a shared-memory tile with a halo
// per (image, row band, channel chunk) would read x once instead of K * K
// times through L1, and a register window along a row would reuse each
// loaded tap for K outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nhwc_vec.cuh"

namespace {

constexpr int kThreads = 256;

template <typename IO, int V, int K>
__global__ void __launch_bounds__(kThreads) depthwise_kernel(
    const typename IO::S* __restrict__ x, const typename IO::S* __restrict__ wt,
    typename IO::S* __restrict__ out, long long total, int h, int w, int c) {
  using S = typename IO::S;
  constexpr int P = K / 2;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const Where p = decode<V>(i, h, w, c);
  const long long here = p.pix * c + p.c0;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int iy = p.y + dy - P;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int ix = p.x + dx - P;
      if (ix < 0 || ix >= w) continue;
      const Pack<S, V> xv = load<S, V>(
          x + here + (static_cast<long long>(dy - P) * w + dx - P) * c);
      const Pack<S, V> wv = load<S, V>(wt + (dy * K + dx) * c + p.c0);
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = fmaf(IO::to_float(xv.v[v]), IO::to_float(wv.v[v]), acc[v]);
    }
  }
  Pack<S, V> r;
#pragma unroll
  for (int v = 0; v < V; ++v) r.v[v] = IO::from_float(acc[v]);
  store<S, V>(out + here, r);
}

template <typename IO, int V, int K>
int launch_k(const void* x, const void* wt, void* out, long long blocks,
             long long total, int h, int w, int c, cudaStream_t s) {
  using S = typename IO::S;
  depthwise_kernel<IO, V, K><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const S*>(x), static_cast<const S*>(wt),
      static_cast<S*>(out), total, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO, int V>
int launch(const void* x, const void* wt, void* out, int n, int h, int w,
           int c, int k, cudaStream_t s) {
  using S = typename IO::S;
  long long total = 0;
  const long long blocks = blocks_for(n, h, w, c, V, kThreads, &total);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(x, V * sizeof(S)) || !aligned(wt, V * sizeof(S)) ||
      !aligned(out, V * sizeof(S)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (k) {
    case 3: return launch_k<IO, V, 3>(x, wt, out, blocks, total, h, w, c, s);
    case 5: return launch_k<IO, V, 5>(x, wt, out, blocks, total, h, w, c, s);
    case 7: return launch_k<IO, V, 7>(x, wt, out, blocks, total, h, w, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (n, h, w, c), wt (k, k, c) -> out (n, h, w, c). vec = channels per
// thread: c % vec == 0 and every pointer aligned to vec elements (the
// wrapper picks the widest).
extern "C" int depthwise_stencil_bf16(const void* x, const void* wt, void* out,
                                      int n, int h, int w, int c, int k,
                                      int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8: return launch<BF16, 8>(x, wt, out, n, h, w, c, k, s);
    case 4: return launch<BF16, 4>(x, wt, out, n, h, w, c, k, s);
    case 2: return launch<BF16, 2>(x, wt, out, n, h, w, c, k, s);
    case 1: return launch<BF16, 1>(x, wt, out, n, h, w, c, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int depthwise_stencil_f32(const void* x, const void* wt, void* out,
                                     int n, int h, int w, int c, int k,
                                     int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return launch<F32, 4>(x, wt, out, n, h, w, c, k, s);
    case 2: return launch<F32, 2>(x, wt, out, n, h, w, c, k, s);
    case 1: return launch<F32, 1>(x, wt, out, n, h, w, c, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
