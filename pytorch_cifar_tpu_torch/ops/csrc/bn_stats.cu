// Per-channel batch moments (E[x], E[x^2]) in fp32, one read of x, one
// launch.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/bn_stats.py: fused_moments
// (`_moments_sums` -> Pallas `_moments_kernel`). x is NHWC viewed as a
// row-major (rows, c) matrix, rows = N * H * W, in bf16 or fp32; the result
// is out[0, :] = sum(x) / rows and out[1, :] = sum(x * x) / rows, summed in
// fp32. The gradient is elementwise and stays in PyTorch
// (ops/bn_stats.py), as the JAX package keeps it in jnp.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes at ResNet-18's large
// maps (x is read once: 67 MB for the (512, 32, 32, 64) bf16 activation,
// 0.020 ms), and fixed costs at its small ones (8 MB at (512, 4, 4, 512),
// 0.0025 ms): launches, synchronisations and the sum across blocks. The
// design it replaces ran a partial pass and a second finalize launch, a
// five-level shared-memory tree with a barrier a level, and four loads a
// thread in flight; it took 0.665 ms per b512 bf16 ResNet-18 forward (20
// launches) against a 0.188 ms bound, and lost to torch.batch_norm_stats
// at 8x8x256 and 4x4x512 (NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
// - A grid of (row chunks, channel tiles), about kTargetBlocks blocks of
//   256 threads (two an SM), chunks of at least kMinRowsPerThread rows a
//   thread. A thread owns V adjacent channels (V = 8 bf16 or 4 fp32: one 16-byte
//   load a row when c % V == 0 and x is 16-byte aligned, else V = 1 with
//   scalar loads, e.g. c = 130) and walks every TY-th row of its chunk,
//   kUnroll independent 16-byte loads issued before their sums, in fp32
//   registers: with two blocks an SM, that is what keeps enough bytes in
//   flight at the large maps (a cp.async ring would stage bytes that are
//   read once). More blocks made the sum across them cost more than they
//   gained, and eight loads in flight were slower than 16 at 32x32x64.
// - The TY row-threads of a channel are summed by warp shuffles, then
//   across the 8 warps in a fixed order through a [moment][warp][j][tx]
//   shared array that a warp writes and reads on distinct banks (the
//   design it replaces put a warp's threads on 4 of them at V = 8), and
//   the block writes its partial (2, tile) to a workspace.
// - One launch: after its partial is visible (__threadfence), a block
//   draws an integer ticket for its channel tile (atomicAdd on an int).
//   The block that draws the last one sums that tile's partials in chunk
//   order (each thread a stride of chunks, then the threads' sums in
//   order), divides by rows, writes out, and resets the tile's counter to
//   0 for the next launch. No float atomics: the order of every sum
//   depends on the shape alone, never on which block finishes last, so two
//   launches on one input are bit-identical. The counters live across
//   launches (the wrapper keeps one buffer per device and stream); a
//   counter that resets itself needs no memset launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetBlocks = 264;  // row chunks x channel tiles: 2 an SM
constexpr int kMinRowsPerThread = 8;
constexpr int kUnroll = 16;  // loads of one thread in flight

template <typename T, int V>
struct Vec;  // one thread's V channels of a row, as loaded

template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int j) const {
    const uint32_t w = (&raw.x)[j / 2];
    return __uint_as_float(j % 2 ? w & 0xFFFF0000u : w << 16);
  }
};

template <>
struct Vec<float, 4> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float get(int j) const { return (&raw.x)[j]; }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  uint16_t raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint16_t*>(p);
  }
  __device__ __forceinline__ float get(int) const {
    return __uint_as_float(static_cast<uint32_t>(raw) << 16);
  }
};

template <>
struct Vec<float, 1> {
  float raw;
  __device__ __forceinline__ void load(const float* p) { raw = *p; }
  __device__ __forceinline__ float get(int) const { return raw; }
};

// TX threads across the channel tile (V channels each), TY = 256 / TX
// threads down the rows; a warp holds 32 / TX of the row-threads.
template <typename T, int V, int TX>
__global__ void __launch_bounds__(kThreads) moments_kernel(
    const T* __restrict__ x, float* __restrict__ partial,
    float* __restrict__ out, int* __restrict__ tickets, long long rows,
    int c, long long rows_per_block, int chunks) {
  constexpr int TY = kThreads / TX;
  constexpr int CT = TX * V;
  constexpr int P = kThreads / (2 * CT);  // the finish's threads a value
  __shared__ float red[2][kWarps][V][TX];
  __shared__ float fin[P][2 * CT];
  __shared__ bool last;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * CT + tx * V;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;

  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  // V > 1 only when c % V == 0, so c0 < c means all V channels are real
  if (c0 < c) {
    long long r = r0 + ty;
    for (; r + (kUnroll - 1) * TY < r1; r += kUnroll * TY) {
      Vec<T, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u].load(x + (r + u * TY) * c + c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = v[u].get(j);
          a[j] += f;
          b[j] = fmaf(f, f, b[j]);
        }
    }
    for (; r < r1; r += TY) {
      Vec<T, V> v;
      v.load(x + r * c + c0);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = v.get(j);
        a[j] += f;
        b[j] = fmaf(f, f, b[j]);
      }
    }
  }
  // the warp's row-threads of each channel, then the warps in order
#pragma unroll
  for (int off = TX; off < 32; off *= 2)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] += __shfl_xor_sync(0xFFFFFFFFu, a[j], off);
      b[j] += __shfl_xor_sync(0xFFFFFFFFu, b[j], off);
    }
  if (lane < TX) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[0][warp][j][tx] = a[j];
      red[1][warp][j][tx] = b[j];
    }
  }
  __syncthreads();
  const int tile0 = blockIdx.y * CT;
  if (threadIdx.x < 2 * CT) {  // thread (m, j, t) sums channel t * V + j
    const int m = threadIdx.x / CT, j = threadIdx.x % CT / TX;
    const int t = threadIdx.x % TX;
    float s = red[m][0][j][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[m][w][j][t];
    if (tile0 + t * V + j < c)
      partial[((size_t)blockIdx.x * 2 + m) * c + tile0 + t * V + j] = s;
  }
  // the partial is visible before the ticket is drawn
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.y], 1) == chunks - 1;
  __syncthreads();
  if (!last) return;

  // the last block of this tile: every partial of it, in chunk order
  __threadfence();
  const int v = threadIdx.x % (2 * CT), p = threadIdx.x / (2 * CT);
  const int m = v / CT, ch = v % CT;
  float s = 0.f;
  if (tile0 + ch < c) {
    const float* src = partial + (size_t)m * c + tile0 + ch;
    // one block does this while the rest of the card idles: 16 loads in
    // flight, their sums still in chunk order
#pragma unroll 16
    for (int k = p; k < chunks; k += P) s += __ldcg(src + (size_t)k * 2 * c);
  }
  fin[p][v] = s;
  __syncthreads();
  if (threadIdx.x < 2 * CT && tile0 + ch < c) {
    float t = fin[0][v];
#pragma unroll
    for (int q = 1; q < P; ++q) t += fin[q][v];
    out[(size_t)m * c + tile0 + ch] = t / (float)rows;
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;  // ready for the next launch
}

template <typename T, int V, int TX>
int launch(const void* x, float* partial, float* out, int* tickets,
           long long rows, int c, int chunks, long long rows_per_block,
           cudaStream_t s) {
  constexpr int CT = TX * V;
  dim3 grid(chunks, (c + CT - 1) / CT);
  moments_kernel<T, V, TX><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), partial, out, tickets, rows, c,
      rows_per_block, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// The chunking both the wrapper (to size the workspace and the tickets)
// and the launch use: rows are split into `chunks` chunks of
// `rows_per_block` rows (a multiple of 32, so every TY divides it), over
// `tiles` channel tiles, fixed by (rows, c, vec) alone.
extern "C" int fused_moments_plan(long long rows, int c, int vec,
                                  int elem_bytes, long long* rows_per_block,
                                  int* chunks, int* tiles) {
  if (rows <= 0 || c <= 0 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int ct = vec ? 64 : 32;  // channels per tile: TX * V
  const int tx = vec ? ct / (16 / elem_bytes) : 32;
  const long long n_tiles = (c + ct - 1) / ct;
  long long want = kTargetBlocks / n_tiles;
  if (want < 1) want = 1;
  long long rpb = (rows + want - 1) / want;
  const long long least = (long long)(kThreads / tx) * kMinRowsPerThread;
  if (rpb < least) rpb = least;
  rpb = (rpb + 31) / 32 * 32;
  const long long n_chunks = (rows + rpb - 1) / rpb;
  if (n_chunks > 0x7fffffffLL || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  *rows_per_block = rpb;
  *chunks = (int)n_chunks;
  *tiles = (int)n_tiles;
  return (int)cudaSuccess;
}

// x (rows, c) -> out (2, c) fp32; partial is the (chunks, 2, c) fp32
// workspace and tickets the (tiles,) int32 counters, zero before the
// launch and left zero after it, both sized by fused_moments_plan. vec !=
// 0 takes the 16-byte path (c % V == 0 and x 16-byte aligned, checked by
// the wrapper and here).
extern "C" int fused_moments_bf16(const void* x, float* partial, float* out,
                                  int* tickets, long long rows, int c,
                                  int vec, void* stream) {
  long long rpb;
  int chunks, tiles;
  int err = fused_moments_plan(rows, c, vec, 2, &rpb, &chunks, &tiles);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (c % 8 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return launch<__nv_bfloat16, 8, 8>(x, partial, out, tickets, rows, c,
                                       chunks, rpb, s);
  }
  return launch<__nv_bfloat16, 1, 32>(x, partial, out, tickets, rows, c,
                                      chunks, rpb, s);
}

extern "C" int fused_moments_f32(const void* x, float* partial, float* out,
                                 int* tickets, long long rows, int c, int vec,
                                 void* stream) {
  long long rpb;
  int chunks, tiles;
  int err = fused_moments_plan(rows, c, vec, 4, &rpb, &chunks, &tiles);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (c % 4 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return launch<float, 4, 16>(x, partial, out, tickets, rows, c, chunks,
                                rpb, s);
  }
  return launch<float, 1, 32>(x, partial, out, tickets, rows, c, chunks, rpb,
                              s);
}
