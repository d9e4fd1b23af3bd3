// Depthwise K x K / stride 1 / SAME convolution, NHWC, forward only.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/depthwise_stencil.py:
// depthwise_stencil (Pallas `_kernel`). Same function:
//   out[n, y, x, c] = sum_{dy, dx} x[n, y + dy - p, x + dx - p, c]
//                                  * w[dy, dx, c],   p = K / 2,
// zero outside the map, summed in fp32 in row-major tap order, one rounding
// to x's type. x is (n, h, w, c), w is (K, K, c) in x's type, K is 3, 5 or 7.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores; a stencil has no product for them): bytes at K = 3
// (2 * s * E + K * K * C * s bytes against 2 * K * K * E operations),
// operations from K = 5 in bf16 (K * K / s > 10).
//
// Design (the wrapper's plan, ops/depthwise_stencil.py: plan, picks the
// tile):
// - One block per (tile of `ib` images x `th` rows, chunk of `ccv` channel
//   vectors of V channels), 128 threads or fewer (against 256: 4%
//   faster per MobileNet forward, more blocks in flight; capping the
//   registers for more blocks an SM spilled and lost). It stages the
//   tile's input with its zero halo,
//   [image][row][column][channel], and the chunk's K x K weights in shared
//   memory with cp.async copies of V * s bytes (16 where C and the pointers
//   allow it), whose zero-fill is the padding: every input element is read
//   from device memory once per tile, not K * K times through L1.
// - Each thread owns one channel vector and a run of 4 outputs along a row;
//   per tap row it loads the 4 + K - 1 inputs into registers once (the
//   register window), so every loaded input feeds up to K outputs. It
//   steps over the tile's rows `tr` at a time. The tile is padded to
//   whole runs (xruns * 4 + K - 1 columns, zero-filled) so that no window
//   load needs a bound: a guarded window on an unpadded tile measured 1.5x
//   slower (PERF.md).
// - At small maps (MobileNet's 4x4x512 and 2x2x1024) one block covers
//   several whole images, so a launch is 256 full blocks and not many
//   near-empty ones.
// - V * s is 16 bytes where C and the base pointers allow it, else 8, 4,
//   ... (the wrapper decides from data_ptr() and C): C = 44 in bf16 runs
//   8-byte vectors, C = 130 4-byte ones; a 2-byte vector (bf16, odd C) is
//   below cp.async's smallest copy and is staged with plain loads.
// - An output's sum runs over the taps in row-major order with one fmaf
//   each, whatever the tile, so every plan gives the same bits.
// The design it replaces (one thread per (pixel, channel vector), every tap
// read from device memory through L1) took 0.0762 ms per bucket-128 bf16
// MobileNet forward (9 launches) against cuDNN's 0.0686, and 0.412 ms
// at (512, 32, 32, 44) k = 7 against cuDNN's 0.189 (NVIDIA H100 80GB HBM3,
// 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nhwc_vec.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int kRun = 4;           // outputs along a row per thread
constexpr int kMaxThreads = 128;  // the plan's block never exceeds it
constexpr int kSmemOptIn = 232448;

// shared-memory elements of one plan's tile and weights
inline long long smem_elems(int ib, int th, int ccv, int xruns, int v,
                            int k) {
  return ((long long)ib * (th + k - 1) * (xruns * kRun + k - 1) + k * k) *
         ccv * v;
}

template <typename IO, int V, int K>
__global__ void __launch_bounds__(kMaxThreads) depthwise_kernel(
    const typename IO::S* __restrict__ x, const typename IO::S* __restrict__ wt,
    typename IO::S* __restrict__ out, int n, int h, int w, int c, int ib,
    int th, int tr, int ccv, int xruns) {
  using S = typename IO::S;
  constexpr int P = K / 2;
  constexpr int WIN = kRun + K - 1;
  const int cvt = c / V;
  const int bands = (h + th - 1) / th;
  const int img0 = (blockIdx.x / bands) * ib;
  const int oy0 = (blockIdx.x % bands) * th;
  const int cv0 = blockIdx.y * ccv;
  const int tw = xruns * kRun + K - 1, tht = th + K - 1;  // tile, pixels
  const int pv = ccv * V;  // elements of one tile pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ts = reinterpret_cast<S*>(smem_raw);
  S* ws = ts + (size_t)ib * tht * tw * pv;

  const int tile_vecs = ib * tht * tw * ccv;
  for (int i = threadIdx.x; i < tile_vecs; i += blockDim.x) {
    const int v = i % ccv, p = i / ccv;
    const int r = p / tw;
    const int img = img0 + r / tht, iy = oy0 + r % tht - P, ix = p % tw - P;
    const bool ok = img < n && iy >= 0 && iy < h && ix >= 0 && ix < w &&
                    cv0 + v < cvt;
    copy_async<V * sizeof(S)>(
        ts + (size_t)p * pv + v * V,
        ok ? x + (((long long)img * h + iy) * w + ix) * c + (cv0 + v) * V : x,
        ok);
  }
  for (int i = threadIdx.x; i < K * K * ccv; i += blockDim.x) {
    const int v = i % ccv, tap = i / ccv;
    const bool ok = cv0 + v < cvt;
    copy_async<V * sizeof(S)>(ws + tap * pv + v * V,
                              ok ? wt + tap * c + (cv0 + v) * V : wt, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // thread -> (channel vector, run of kRun columns, row, image)
  const int v = threadIdx.x % ccv;
  int r = threadIdx.x / ccv;
  const int x0 = (r % xruns) * kRun;
  r /= xruns;
  const int im = r / tr, img = img0 + im, cv = cv0 + v;
  if (im >= ib || img >= n || cv >= cvt) return;
  for (int ty = r % tr; ty < th && oy0 + ty < h; ty += tr) {
    float acc[kRun][V];
#pragma unroll
    for (int j = 0; j < kRun; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const S* row = ts + ((size_t)(im * tht + ty + dy) * tw + x0) * pv + v * V;
      float win[WIN][V];
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        const Pack<S, V> p = load<S, V>(row + j * pv);
#pragma unroll
        for (int e = 0; e < V; ++e) win[j][e] = IO::to_float(p.v[e]);
      }
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const Pack<S, V> wv = load<S, V>(ws + (dy * K + dx) * pv + v * V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float wf = IO::to_float(wv.v[e]);
#pragma unroll
          for (int j = 0; j < kRun; ++j)
            acc[j][e] = fmaf(win[j + dx][e], wf, acc[j][e]);
        }
      }
    }
    S* o = out + (((long long)img * h + oy0 + ty) * w + x0) * c + cv * V;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (x0 + j < w) {
        Pack<S, V> q;
#pragma unroll
        for (int e = 0; e < V; ++e) q.v[e] = IO::from_float(acc[j][e]);
        store<S, V>(o + (long long)j * c, q);
      }
    }
  }
}

template <typename IO, int V, int K>
int launch_k(const void* x, const void* wt, void* out, int n, int h, int w,
             int c, int ib, int th, int tr, int ccv, int xruns, int smem,
             cudaStream_t s) {
  using S = typename IO::S;
  // set once per instantiation and device (smem_opt_in.cuh); each launch
  // asks only for its own plan's bytes
  const cudaError_t attr = smem_opt_in<depthwise_kernel<IO, V, K>>(kSmemOptIn);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = (long long)((n + ib - 1) / ib) * ((h + th - 1) / th);
  const int chunks = (c / V + ccv - 1) / ccv;
  if (tiles > 2147483647LL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  depthwise_kernel<IO, V, K>
      <<<dim3((unsigned)tiles, chunks), ib * tr * xruns * ccv, smem, s>>>(
          static_cast<const S*>(x), static_cast<const S*>(wt),
          static_cast<S*>(out), n, h, w, c, ib, th, tr, ccv, xruns);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO, int V>
int launch(const void* x, const void* wt, void* out, int n, int h, int w,
           int c, int k, int ib, int th, int tr, int ccv, int xruns, int smem,
           cudaStream_t s) {
  using S = typename IO::S;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % V || ib <= 0 || th <= 0 ||
      th > h || (ib > 1 && th != h) || tr <= 0 || tr > th || ccv <= 0 ||
      ccv > c / V || xruns * kRun < w || (xruns - 1) * kRun >= w ||
      ib * tr * xruns * ccv > kMaxThreads || smem > kSmemOptIn ||
      smem != smem_elems(ib, th, ccv, xruns, V, k) * (long long)sizeof(S))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(x, V * sizeof(S)) || !aligned(wt, V * sizeof(S)) ||
      !aligned(out, V * sizeof(S)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (k) {
    case 3:
      return launch_k<IO, V, 3>(x, wt, out, n, h, w, c, ib, th, tr, ccv,
                                xruns, smem, s);
    case 5:
      return launch_k<IO, V, 5>(x, wt, out, n, h, w, c, ib, th, tr, ccv,
                                xruns, smem, s);
    case 7:
      return launch_k<IO, V, 7>(x, wt, out, n, h, w, c, ib, th, tr, ccv,
                                xruns, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (n, h, w, c), wt (k, k, c) -> out (n, h, w, c). vec = channels per
// vector: c % vec == 0 and every pointer aligned to vec elements (the
// wrapper picks the widest). (ib, th, tr, ccv, xruns, smem) is the
// wrapper's plan, checked here against the shape.
#define DW_CASE(IO, V)                                                     \
  case V:                                                                  \
    return launch<IO, V>(x, wt, out, n, h, w, c, k, ib, th, tr, ccv, xruns, \
                         smem, static_cast<cudaStream_t>(stream));

extern "C" int depthwise_stencil_bf16(const void* x, const void* wt, void* out,
                                      int n, int h, int w, int c, int k,
                                      int vec, int ib, int th, int tr, int ccv,
                                      int xruns, int smem, void* stream) {
  switch (vec) { DW_CASE(BF16, 8) DW_CASE(BF16, 4) DW_CASE(BF16, 2)
                 DW_CASE(BF16, 1) }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int depthwise_stencil_f32(const void* x, const void* wt, void* out,
                                     int n, int h, int w, int c, int k,
                                     int vec, int ib, int th, int tr, int ccv,
                                     int xruns, int smem, void* stream) {
  switch (vec) { DW_CASE(F32, 4) DW_CASE(F32, 2) DW_CASE(F32, 1) }
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef DW_CASE
