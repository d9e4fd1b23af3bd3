// Per-channel batch moments (E[x], E[x^2]) in fp32, one read of x.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/bn_stats.py: fused_moments
// (`_moments_sums` -> Pallas `_moments_kernel`). x is NHWC viewed as a
// row-major (rows, c) matrix, rows = N * H * W, in bf16 or fp32; the result
// is out[0, :] = sum(x) / rows and out[1, :] = sum(x * x) / rows, summed in
// fp32. The gradient is elementwise and stays in PyTorch
// (ops/bn_stats.py), as the JAX package keeps it in jnp.
//
// Design (simple, right and deterministic first):
// - Pass 1 (moments_partial): a grid of (row chunks, channel tiles). Each
//   block of 256 threads owns a tile of channels and a fixed chunk of rows;
//   a thread owns V adjacent channels (V = 8 bf16 or 4 fp32: one 16-byte
//   load per row when c % V == 0 and x is 16-byte aligned, else V = 1 with
//   scalar loads, e.g. c = 130) and walks every TY-th row of the chunk,
//   accumulating sum and sum of squares in fp32 registers. A shared-memory
//   tree sums the TY row-threads of each channel in a fixed order, and the
//   block writes its partial (2, tile) to a workspace.
// - Pass 2 (moments_finalize): one block per channel sums the chunks'
//   partials in a fixed order (a strided walk, then a shared-memory tree)
//   and divides by rows.
// - No float atomics anywhere: the split of rows into chunks depends only
//   on the shape, so two launches on the same input are bit-identical.
//   (The JAX kernel once returned wrong sums at c = 512 because its
//   accumulation order across grid steps was wrong; here each partial has
//   its own slot and the order is fixed.)
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. x is read once:
// 67 MB for ResNet-18's (512, 32, 32, 64) bf16 activation, 0.020 ms; the
// partials are at most a few hundred KB. What this design leaves on the
// table: no cp.async/TMA staging, one partial pass plus a second launch,
// and the scalar path for channel counts that are not a multiple of V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 1024;  // row chunks x channel tiles, ~8 per SM

template <typename T, int V>
struct Load;

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&v)[8]) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[4]) {
    float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
};

template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
};

// TX threads across the channel tile (V channels each), TY = 256 / TX
// threads down the rows.
template <typename T, int V, int TX>
__global__ void __launch_bounds__(kThreads) moments_partial(
    const T* __restrict__ x, float* __restrict__ partial, long long rows,
    int c, long long rows_per_block) {
  constexpr int TY = kThreads / TX;
  constexpr int CT = TX * V;
  __shared__ float s1[TY][CT];
  __shared__ float s2[TY][CT];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int c0 = blockIdx.y * CT + tx * V;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  long long r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;

  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  // V > 1 only when c % V == 0, so c0 < c means all V channels are real
  if (c0 < c) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += TY) {
      float v[V];
      Load<T, V>::run(x + r * c + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] += v[j];
        b[j] = fmaf(v[j], v[j], b[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s1[ty][tx * V + j] = a[j];
    s2[ty][tx * V + j] = b[j];
  }
  __syncthreads();
#pragma unroll
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[ty][tx * V + j] += s1[ty + s][tx * V + j];
        s2[ty][tx * V + j] += s2[ty + s][tx * V + j];
      }
    }
    __syncthreads();
  }
  if (ty == 0) {
    float* p = partial + (size_t)blockIdx.x * 2 * c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c0 + j < c) {
        p[c0 + j] = s1[0][tx * V + j];
        p[c + c0 + j] = s2[0][tx * V + j];
      }
    }
  }
}

// One block per channel: out[0, ch] = sum_k partial[k, 0, ch] / rows, and
// the same for the squares, summed in a fixed order.
__global__ void __launch_bounds__(kThreads) moments_finalize(
    const float* __restrict__ partial, float* __restrict__ out, int c,
    int chunks, float rows) {
  __shared__ float s1[kThreads];
  __shared__ float s2[kThreads];
  const int ch = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    a += partial[(size_t)k * 2 * c + ch];
    b += partial[(size_t)k * 2 * c + c + ch];
  }
  s1[threadIdx.x] = a;
  s2[threadIdx.x] = b;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s1[threadIdx.x] += s1[threadIdx.x + s];
      s2[threadIdx.x] += s2[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[ch] = s1[0] / rows;
    out[c + ch] = s2[0] / rows;
  }
}

template <typename T, int V, int TX>
int launch(const void* x, float* partial, float* out, long long rows, int c,
           int chunks, long long rows_per_block, cudaStream_t s) {
  constexpr int CT = TX * V;
  dim3 grid(chunks, (c + CT - 1) / CT);
  moments_partial<T, V, TX><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), partial, rows, c, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_finalize<<<c, kThreads, 0, s>>>(partial, out, c, chunks,
                                          (float)rows);
  return (int)cudaGetLastError();
}

}  // namespace

// The chunking both the wrapper (to size the workspace) and the launch use:
// rows are split into `chunks` chunks of `rows_per_block` rows (a multiple
// of 32, so every TY divides it), fixed by (rows, c, vec) alone.
extern "C" int fused_moments_plan(long long rows, int c, int vec,
                                  int elem_bytes, long long* rows_per_block,
                                  int* chunks) {
  if (rows <= 0 || c <= 0 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int ct = vec ? 64 : 32;  // channels per tile: TX * V
  const long long tiles = (c + ct - 1) / ct;
  long long want = kTargetBlocks / tiles;
  if (want < 1) want = 1;
  long long rpb = (rows + want - 1) / want;
  rpb = (rpb + 31) / 32 * 32;
  const long long n_chunks = (rows + rpb - 1) / rpb;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *rows_per_block = rpb;
  *chunks = (int)n_chunks;
  return (int)cudaSuccess;
}

// x (rows, c) -> out (2, c) fp32; partial is the (chunks, 2, c) fp32
// workspace sized by fused_moments_plan. vec != 0 takes the 16-byte path
// (c % V == 0 and x 16-byte aligned, checked by the wrapper and here).
extern "C" int fused_moments_bf16(const void* x, float* partial, float* out,
                                  long long rows, int c, int vec,
                                  void* stream) {
  long long rpb;
  int chunks;
  int err = fused_moments_plan(rows, c, vec, 2, &rpb, &chunks);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (c % 8 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return launch<__nv_bfloat16, 8, 8>(x, partial, out, rows, c, chunks, rpb,
                                       s);
  }
  return launch<__nv_bfloat16, 1, 32>(x, partial, out, rows, c, chunks, rpb,
                                      s);
}

extern "C" int fused_moments_f32(const void* x, float* partial, float* out,
                                 long long rows, int c, int vec,
                                 void* stream) {
  long long rpb;
  int chunks;
  int err = fused_moments_plan(rows, c, vec, 4, &rpb, &chunks);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (c % 4 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return launch<float, 4, 16>(x, partial, out, rows, c, chunks, rpb, s);
  }
  return launch<float, 1, 32>(x, partial, out, rows, c, chunks, rpb, s);
}
