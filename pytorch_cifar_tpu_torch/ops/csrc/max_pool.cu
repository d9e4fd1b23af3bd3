// 3x3 / stride 1 / pad 1 max pool, NHWC: forward (with or without a winner
// map) and backward.
//
// Replaces the TPU kernels of pytorch_cifar_tpu/ops/max_pool.py:
// max_pool3x3_s1 -> _max_pool3x3_fwd (Pallas `_fwd_kernel`) and
// _max_pool3x3_bwd (Pallas `_bwd_kernel`). Same function:
//   out[n, y, x, c] = max over the 3x3 window around (y, x), -inf outside
//   the map; the winner is the row-major FIRST maximum (taps scanned 0..8
//   with a strict >), which is what the TPU kernel's separable
//   max_h(max_w(x)) picks too;
//   gi[p] = sum of g[window] over the windows whose winner is p.
// One difference, on purpose: a NaN wins over anything (v > best || v != v),
// as torch's and XLA's max pools propagate it, where the TPU kernel's strict
// > alone would let a NaN pass only at tap 0.
//
// Design (simple and right first):
// - Forward: one thread per (pixel, vector of V channels). C is innermost,
//   so a warp's threads sit on neighbouring channels and every tap is one
//   coalesced load; the 9 taps of neighbouring pixels overlap and come
//   through L1/L2. V * elem is 16 bytes where C and the base pointers allow
//   it, else 8, 4, ... down to one element (the wrapper decides from
//   data_ptr() and C, so C = 130 or an offset view still runs).
// - The winner map is ONE uint8 per element (the winning tap 0..8), written
//   only under autograd: 1 byte per element beside the output, where the
//   TPU kernel kept two maps in the input dtype.
// - Backward: a gather, no atomics. The thread of input position p reads
//   the map of the up to 9 windows that contain p (window (y - dy + 1,
//   x - dx + 1) sees p as its tap (dy, dx)) and adds g where the map names
//   that tap, in tap order, in fp32, and rounds once. A window whose
//   winner is tap 0 in the halo (every real tap -inf) names no input
//   position: its gradient is dropped, as on the TPU, and nothing is read
//   or written out of bounds.
// - Compares are done on the values widened to fp32 (exact for bf16); the
//   output is the winner's own bits.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Training forward:
// read E elements, write E elements and E map bytes, (2s + 1) * E bytes;
// inference forward 2s * E; backward reads g and the map and writes gi,
// (2s + 1) * E. What this design leaves on the table: the 9x re-read goes
// through L1/L2 instead of a shared-memory tile, and the backward loads the
// map nine times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nhwc_vec.cuh"

namespace {

constexpr int kThreads = 256;

template <typename IO, int V, bool MAP>
__global__ void __launch_bounds__(kThreads) max_pool_fwd_kernel(
    const typename IO::S* __restrict__ x, typename IO::S* __restrict__ out,
    uint8_t* __restrict__ idx, long long total, int h, int w, int c) {
  using S = typename IO::S;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const Where p = decode<V>(i, h, w, c);
  // the window's centre is element (p.pix, p.c0); tap (dy, dx) lies
  // ((dy - 1) * w + dx - 1) pixels from it
  const S* centre = x + p.pix * c + p.c0;
  Pack<S, V> best;
  Pack<uint8_t, V> win;
  float bestf[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best.v[v] = IO::neg_inf();  // tap 0 in the halo: -inf, winner 0
    bestf[v] = -INFINITY;
    win.v[v] = 0;
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int iy = p.y + t / 3 - 1, ix = p.x + t % 3 - 1;
    // a halo tap is -inf: it never beats the running best under a strict >
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) continue;
    const Pack<S, V> cur =
        load<S, V>(centre + (static_cast<long long>(t / 3 - 1) * w + t % 3 - 1) * c);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float f = IO::to_float(cur.v[v]);
      if (f > bestf[v] || f != f) {  // first maximum wins; a NaN always wins
        bestf[v] = f;
        best.v[v] = cur.v[v];
        win.v[v] = static_cast<uint8_t>(t);
      }
    }
  }
  store<S, V>(out + p.pix * c + p.c0, best);
  if (MAP) store<uint8_t, V>(idx + p.pix * c + p.c0, win);
}

template <typename IO, int V>
__global__ void __launch_bounds__(kThreads) max_pool_bwd_kernel(
    const typename IO::S* __restrict__ g, const uint8_t* __restrict__ idx,
    typename IO::S* __restrict__ gi, long long total, int h, int w, int c) {
  using S = typename IO::S;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const Where p = decode<V>(i, h, w, c);
  const long long here = p.pix * c + p.c0;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    // the window that sees this position as its tap t
    const int oy = p.y - (t / 3 - 1), ox = p.x - (t % 3 - 1);
    if (oy < 0 || oy >= h || ox < 0 || ox >= w) continue;
    const long long off =
        here - (static_cast<long long>(t / 3 - 1) * w + t % 3 - 1) * c;
    const Pack<uint8_t, V> m = load<uint8_t, V>(idx + off);
    bool any = false;
#pragma unroll
    for (int v = 0; v < V; ++v) any |= m.v[v] == t;
    if (!any) continue;
    const Pack<S, V> gv = load<S, V>(g + off);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (m.v[v] == t) acc[v] += IO::to_float(gv.v[v]);
  }
  Pack<S, V> r;
#pragma unroll
  for (int v = 0; v < V; ++v) r.v[v] = IO::from_float(acc[v]);
  store<S, V>(gi + here, r);
}

// one call's arguments: `in` is x (forward) or g (backward), `out` is out or
// gi; the forward writes `idx` unless it is null, the backward reads it
struct Call {
  const void* in;
  void* idx;
  void* out;
  long long blocks, total;
  int h, w, c;
  cudaStream_t s;
};

template <typename IO, bool BWD, int V>
int launch(const Call& a) {
  using S = typename IO::S;
  if (!aligned(a.in, V * sizeof(S)) || !aligned(a.out, V * sizeof(S)) ||
      (a.idx != nullptr && !aligned(a.idx, V)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned blocks = static_cast<unsigned>(a.blocks);
  const S* in = static_cast<const S*>(a.in);
  S* out = static_cast<S*>(a.out);
  uint8_t* idx = static_cast<uint8_t*>(a.idx);
  if (BWD) {
    if (idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    max_pool_bwd_kernel<IO, V><<<blocks, kThreads, 0, a.s>>>(
        in, idx, out, a.total, a.h, a.w, a.c);
  } else if (idx != nullptr) {
    max_pool_fwd_kernel<IO, V, true><<<blocks, kThreads, 0, a.s>>>(
        in, out, idx, a.total, a.h, a.w, a.c);
  } else {
    max_pool_fwd_kernel<IO, V, false><<<blocks, kThreads, 0, a.s>>>(
        in, out, nullptr, a.total, a.h, a.w, a.c);
  }
  return static_cast<int>(cudaGetLastError());
}

// vec = channels per thread: c % vec == 0 and every pointer aligned to vec
// elements (the wrapper picks the widest, up to 16 bytes)
template <typename IO, bool BWD>
int dispatch(const void* in, const void* idx, void* out, int n, int h, int w,
             int c, int vec, void* stream) {
  Call a{in, const_cast<void*>(idx), out, 0, 0, h, w, c,
         static_cast<cudaStream_t>(stream)};
  a.blocks = blocks_for(n, h, w, c, vec, kThreads, &a.total);
  if (a.blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec * static_cast<int>(sizeof(typename IO::S))) {
    case 16: return launch<IO, BWD, 16 / sizeof(typename IO::S)>(a);
    case 8: return launch<IO, BWD, 8 / sizeof(typename IO::S)>(a);
    case 4: return launch<IO, BWD, 4 / sizeof(typename IO::S)>(a);
    case 2:
      if constexpr (sizeof(typename IO::S) == 2) return launch<IO, BWD, 1>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (n, h, w, c) -> out (n, h, w, c) and, when idx is not null, the uint8
// winner map idx (n, h, w, c).
extern "C" int max_pool3x3_fwd_bf16(const void* x, void* out, void* idx, int n,
                                    int h, int w, int c, int vec,
                                    void* stream) {
  return dispatch<BF16, false>(x, idx, out, n, h, w, c, vec, stream);
}

extern "C" int max_pool3x3_fwd_f32(const void* x, void* out, void* idx, int n,
                                   int h, int w, int c, int vec,
                                   void* stream) {
  return dispatch<F32, false>(x, idx, out, n, h, w, c, vec, stream);
}

// g, idx (n, h, w, c) -> gi (n, h, w, c): each window's g to its winner.
extern "C" int max_pool3x3_bwd_bf16(const void* g, const void* idx, void* gi,
                                    int n, int h, int w, int c, int vec,
                                    void* stream) {
  return dispatch<BF16, true>(g, idx, gi, n, h, w, c, vec, stream);
}

extern "C" int max_pool3x3_bwd_f32(const void* g, const void* idx, void* gi,
                                   int n, int h, int w, int c, int vec,
                                   void* stream) {
  return dispatch<F32, true>(g, idx, gi, n, h, w, c, vec, stream);
}
