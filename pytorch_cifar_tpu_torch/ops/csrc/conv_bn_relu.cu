// Fused inference conv3x3 (stride 1, pad 1) + folded BatchNorm + ReLU, NHWC.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/conv_bn_relu.py:
// conv3x3_bn_relu (Pallas `_kernel`). Same function:
//   out[n, y, x, co] = relu(sum_{ky, kx, ci} x[n, y+ky-1, x+kx-1, ci]
//                           * w[ky, kx, ci, co] * scale[co] + bias[co])
// with zero padding, an fp32 sum, fp32 scale/bias, and one rounding to the
// output type. x is NHWC, w is HWIO, out has x's type (bf16 or fp32).
//
// Design (simple and right first):
// - One block per (image, tile of output rows, 64 output channels): an
//   implicit GEMM with M = the tile's pixels (<= 64), N = 64, K = 9 * cin.
// - For each chunk of 16 input channels the block stages the zero-padded
//   (rows + 2) x (w + 2) input halo, [pixel][ci], and the 9 x 16 x 64
//   weight slice in its global HWIO order, [tap][ci][co], both by straight
//   16-byte copies where the channel counts allow; the border is
//   zero-filled here, so no padded copy of x is ever written. Channels past
//   cin (the stem's cin = 3) stage as zeros, which adds exact zeros to the
//   sum.
// - bf16: each of the 4 warps owns 16 output channels and issues
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate) for every tap, with the
//   B fragments read by ldmatrix.trans; fp32: the same fragment layout
//   summed with fp32 FMAs on the CUDA cores (TF32 would miss the fp32
//   tolerance).
// - Epilogue: acc * scale + bias, ReLU, one cast, one NHWC store.
// - No split-K: every output's summation order is fixed by (chunk, tap,
//   channel), so a row's result does not depend on the batch size.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at bucket
// 128 the 64..512-channel ResNet-18 sites do 9.66 GFLOP each and move
// 9-34 MB, so they are operation-bound near 10 us; the stem (cin = 3) is
// byte-bound near 5 us. What this simple design leaves on the table:
// every block restages its full weight slice (small pixel tiles at 4x4 and
// 8x8 maps make that the dominant traffic), staging is synchronous (no
// cp.async/TMA double buffering), the A fragments are plain 32-bit shared
// loads, mma.sync instead of wgmma, and a grid of only n * cout/64 blocks
// at 4x4 maps when the batch is small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTileN = 64;     // output channels per block, 16 per warp
constexpr int kChunk = 16;     // input channels per K step (one mma k16)
constexpr int kStride = 24;    // smem elements per halo pixel: 16 + 8 pad
                               // makes the 32-bit A fragment loads of 8
                               // rows x 4 lanes conflict-free
constexpr int kStrideW = 72;   // smem elements per weight row (ci): 64 + 8
                               // pad, 144 bytes, so the 8 rows of each
                               // ldmatrix phase hit distinct banks
constexpr int kMaxM = 64;      // output pixels per block (4 m16 fragments)

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

// acc[mf][nf][0..3] follows the m16n8 accumulator layout: rows g and g + 8
// of m fragment mf, columns 2t and 2t + 1 of n fragment nf.
// wtap is one tap's [ci][co] weight tile. ldmatrix.x4.trans gives every
// lane the B fragment pairs (k = 2t, 2t + 1; n = g) of four 8x8 tiles:
// lanes 0-7 address k rows 0-7 and lanes 8-15 rows 8-15 at column nbase
// (n fragment 0), lanes 16-31 the same rows at nbase + 8 (n fragment 1).
__device__ __forceinline__ void mma_tap(
    float (&acc)[4][2][4], const __nv_bfloat16* xs,
    const __nv_bfloat16* wtap, const int (&pix)[4][2], int toff,
    int mfrags, int nbase, int g, int t) {
  const int lane = g * 4 + t;
  const __nv_bfloat16* bp = wtap +
      ((lane & 7) + ((lane >> 3) & 1) * 8) * kStrideW + nbase +
      (lane >> 4) * 8;
  uint32_t b[2][2];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"((uint32_t)__cvta_generic_to_shared(bp)));
#pragma unroll
  for (int mf = 0; mf < 4; ++mf) {
    if (mf < mfrags) {
      const __nv_bfloat16* r0 = xs + (pix[mf][0] + toff) * kStride + 2 * t;
      const __nv_bfloat16* r1 = xs + (pix[mf][1] + toff) * kStride + 2 * t;
      uint32_t a0 = *reinterpret_cast<const uint32_t*>(r0);
      uint32_t a1 = *reinterpret_cast<const uint32_t*>(r1);
      uint32_t a2 = *reinterpret_cast<const uint32_t*>(r0 + 8);
      uint32_t a3 = *reinterpret_cast<const uint32_t*>(r1 + 8);
#pragma unroll
      for (int nf = 0; nf < 2; ++nf) {
        float* c = acc[mf][nf];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[nf][0]),
              "r"(b[nf][1]));
      }
    }
  }
}

// fp32: the same accumulator layout, summed over the 16 channels in order.
__device__ __forceinline__ void mma_tap(
    float (&acc)[4][2][4], const float* xs, const float* wtap,
    const int (&pix)[4][2], int toff, int mfrags, int nbase, int g, int t) {
  const float* w0 = wtap + nbase + 2 * t;
#pragma unroll 4
  for (int k = 0; k < kChunk; ++k) {
    float b[2][2];
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      b[nf][0] = w0[k * kStrideW + nf * 8];
      b[nf][1] = w0[k * kStrideW + nf * 8 + 1];
    }
#pragma unroll
    for (int mf = 0; mf < 4; ++mf) {
      if (mf < mfrags) {
        float a0 = xs[(pix[mf][0] + toff) * kStride + k];
        float a1 = xs[(pix[mf][1] + toff) * kStride + k];
#pragma unroll
        for (int nf = 0; nf < 2; ++nf) {
          acc[mf][nf][0] = fmaf(a0, b[nf][0], acc[mf][nf][0]);
          acc[mf][nf][1] = fmaf(a0, b[nf][1], acc[mf][nf][1]);
          acc[mf][nf][2] = fmaf(a1, b[nf][0], acc[mf][nf][2]);
          acc[mf][nf][3] = fmaf(a1, b[nf][1], acc[mf][nf][3]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv3x3_bn_relu_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int h, int wd, int cin, int cout, int th,
    bool vec_x, bool vec_w) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ww = wd + 2;
  const int halo_px = (th + 2) * ww;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + halo_px * kStride;  // [tap][ci][co], 16-byte aligned

  const int co0 = blockIdx.x * kTileN;
  const int oy0 = blockIdx.y * th;
  const int m_tile = th * wd;
  const int mfrags = (m_tile + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* xin = x + (size_t)blockIdx.z * h * wd * cin;

  // halo-tile pixel of each A row this thread reads (tap (0,0)); rows past
  // the tile are clamped to a real pixel and never stored
  int pix[4][2];
#pragma unroll
  for (int mf = 0; mf < 4; ++mf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int m = min(mf * 16 + g + 8 * r, m_tile - 1);
      pix[mf][r] = (m / wd) * ww + (m % wd);
    }
  }

  float acc[4][2][4];
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    // input halo, zero outside the image and past cin
    if (vec_x) {
      constexpr int G = kChunk / V;
      for (int i = threadIdx.x; i < halo_px * G; i += kThreads) {
        int p = i / G, grp = i % G;
        int iy = oy0 + p / ww - 1, ix = p % ww - 1, ci = c0 + grp * V;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd && ci < cin)
          v = *reinterpret_cast<const uint4*>(
              xin + ((size_t)iy * wd + ix) * cin + ci);
        *reinterpret_cast<uint4*>(xs + p * kStride + grp * V) = v;
      }
    } else {
      for (int i = threadIdx.x; i < halo_px * kChunk; i += kThreads) {
        int p = i / kChunk, c = i % kChunk;
        int iy = oy0 + p / ww - 1, ix = p % ww - 1, ci = c0 + c;
        T v = IO<T>::zero();
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd && ci < cin)
          v = xin[((size_t)iy * wd + ix) * cin + ci];
        xs[p * kStride + c] = v;
      }
    }
    // weights: global (tap, ci, co) -> shared (tap, ci, co), zero past
    // cin and cout
    if (vec_w) {
      constexpr int G = kTileN / V;
      for (int i = threadIdx.x; i < 9 * kChunk * G; i += kThreads) {
        int grp = i % G, c = (i / G) % kChunk, tap = i / (G * kChunk);
        int ci = c0 + c, co = grp * V;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (ci < cin && co0 + co < cout)
          u = *reinterpret_cast<const uint4*>(
              w + ((size_t)tap * cin + ci) * cout + co0 + co);
        *reinterpret_cast<uint4*>(ws + (tap * kChunk + c) * kStrideW + co) =
            u;
      }
    } else {
      for (int i = threadIdx.x; i < 9 * kChunk * kTileN; i += kThreads) {
        int co = i % kTileN, c = (i / kTileN) % kChunk;
        int tap = i / (kTileN * kChunk);
        int ci = c0 + c;
        T v = IO<T>::zero();
        if (ci < cin && co0 + co < cout)
          v = w[((size_t)tap * cin + ci) * cout + co0 + co];
        ws[(tap * kChunk + c) * kStrideW + co] = v;
      }
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      mma_tap(acc, xs, ws + tap * kChunk * kStrideW, pix,
              (tap / 3) * ww + tap % 3, mfrags, warp * 16, g, t);
    }
  }

  T* o = out + (size_t)blockIdx.z * h * wd * cout;
#pragma unroll
  for (int nf = 0; nf < 2; ++nf) {
    int co = co0 + warp * 16 + nf * 8 + 2 * t;
    bool ok0 = co < cout, ok1 = co + 1 < cout;
    float s0 = ok0 ? scale[co] : 0.f, b0 = ok0 ? bias[co] : 0.f;
    float s1 = ok1 ? scale[co + 1] : 0.f, b1 = ok1 ? bias[co + 1] : 0.f;
#pragma unroll
    for (int mf = 0; mf < 4; ++mf) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int m = mf * 16 + g + 8 * r;
        int oy = oy0 + m / wd;
        if (mf < mfrags && m < m_tile && oy < h) {
          T* dst = o + ((size_t)oy * wd + m % wd) * cout + co;
          if (ok0)
            dst[0] = IO<T>::from(fmaxf(acc[mf][nf][2 * r] * s0 + b0, 0.f));
          if (ok1)
            dst[1] =
                IO<T>::from(fmaxf(acc[mf][nf][2 * r + 1] * s1 + b1, 0.f));
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, int n, int h, int wd, int cin,
           int cout, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || wd > kMaxM ||
      n > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  // th * wd <= kMaxM, so the halo (th + 2) * (wd + 2) is at most
  // (kMaxM + 2) * 3 pixels (th = 1 or wd = 1): the attribute is set once per
  // instantiation to that size (thread-safe static init; one device per
  // process), and each launch asks only for its own smem.
  constexpr size_t kMaxSmem =
      ((size_t)(kMaxM + 2) * 3 * kStride + (size_t)9 * kChunk * kStrideW) *
      sizeof(T);
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bn_relu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int th = min(h, kMaxM / wd);
  const size_t smem = ((size_t)(th + 2) * (wd + 2) * kStride +
                       (size_t)9 * kChunk * kStrideW) *
                      sizeof(T);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec_x = cin % V == 0 && ((uintptr_t)x % 16) == 0;
  const bool vec_w = cout % V == 0 && ((uintptr_t)w % 16) == 0;
  dim3 grid((cout + kTileN - 1) / kTileN, (h + th - 1) / th, n);
  conv3x3_bn_relu_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), h, wd, cin, cout, th, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_bn_relu_bf16(const void* x, const void* w,
                                    const float* scale, const float* bias,
                                    void* out, int n, int h, int wd, int cin,
                                    int cout, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, bias, out, n, h, wd, cin, cout,
                               stream);
}

extern "C" int conv3x3_bn_relu_f32(const void* x, const void* w,
                                   const float* scale, const float* bias,
                                   void* out, int n, int h, int wd, int cin,
                                   int cout, void* stream) {
  return launch<float>(x, w, scale, bias, out, n, h, wd, cin, cout, stream);
}
