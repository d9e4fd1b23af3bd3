// Row gather: out[r] = images[idx[r]], rows moved as raw bytes.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/dma_gather.py:
// dma_row_gather (Pallas `_gather_kernel`, a ring of 32 in-flight row
// DMAs), the epoch shuffle of the device-resident training set:
// jnp.take(images, idx, axis=0) for in-range idx. Rows are any trailing
// shape of any dtype; only their byte size matters here.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Each output row is
// read once and written once, plus 4 B of index: (2 * M * row_bytes +
// 4 * M) / 3.35e12 s, 0.092 ms for the 50,176-row CIFAR epoch at batch 512.
// A gather has no reuse, so the design's whole job is to keep enough bytes
// in flight with few instructions.
//
// Design:
// - One warp per output row, and one row per warp: a grid of M / 8 blocks
//   of 8 warps, so the block scheduler hands out rows as warps finish (the
//   loop strides only where M outgrows the grid). Lane 0 reads the row's
//   index once and broadcasts it with a shuffle; the index is clamped to
//   [0, N), so no launch reads out of bounds (out-of-range indices are not
//   relied on, as in JAX).
// - The 32 lanes copy the row with 16-byte (uint4) loads and stores when
//   the row's byte size and both base pointers are 16-byte aligned (the
//   wrapper decides from data_ptr()), and byte by byte otherwise. Each lane
//   issues all its loads of a 256-unit span (up to 8) before its first
//   store: a 3,072 B CIFAR row is 192 uint4, the whole row in flight at
//   once, and a warp's loads cover whole 128 B lines.
// - The TPU kernel's ring of DMAs and its semaphores answered the TPU's
//   per-descriptor latency; on Hopper the warps resident on the 132 SMs keep
//   enough loads in flight by themselves. Its direct counterpart, a ring of
//   cp.async.bulk row copies through shared memory, was built and measured
//   slower than this design: 0.1114 ms against 0.1072 for the epoch gather
//   (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one row each
constexpr int kPerLane = 8;    // units a lane loads before it stores
constexpr long long kMaxBlocks = 2147483647;

template <typename U>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const U* __restrict__ src, const int32_t* __restrict__ idx,
    U* __restrict__ dst, long long n, long long m, long long row_units) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long r = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       r < m; r += warps) {
    long long s = 0;
    if (lane == 0) s = idx[r];
    s = __shfl_sync(0xffffffffu, s, 0);
    s = s < 0 ? 0 : (s >= n ? n - 1 : s);
    const U* in = src + s * row_units;
    U* out = dst + r * row_units;
    for (long long u0 = lane; u0 < row_units; u0 += 32 * kPerLane) {
      U v[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (u0 + 32 * k < row_units) v[k] = in[u0 + 32 * k];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (u0 + 32 * k < row_units) out[u0 + 32 * k] = v[k];
    }
  }
}

}  // namespace

// images (n, row_bytes) -> out (m, row_bytes) by idx (m,) int32; vec != 0
// takes the 16-byte path (row_bytes % 16 == 0, both pointers 16-aligned).
extern "C" int dma_row_gather(const void* images, const int32_t* idx,
                              void* out, long long n, long long m,
                              long long row_bytes, int vec, void* stream) {
  if (n <= 0 || m < 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  if (vec && (row_bytes % 16 != 0 || (uintptr_t)images % 16 != 0 ||
              (uintptr_t)out % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long rows_per_block = kThreads / 32;
  long long blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    gather_rows_kernel<uint4><<<(int)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(images), idx, static_cast<uint4*>(out), n,
        m, row_bytes / 16);
  } else {
    gather_rows_kernel<unsigned char><<<(int)blocks, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(images), idx,
        static_cast<unsigned char*>(out), n, m, row_bytes);
  }
  return (int)cudaGetLastError();
}
