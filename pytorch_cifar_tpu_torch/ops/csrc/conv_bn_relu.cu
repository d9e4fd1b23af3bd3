// Fused inference conv3x3 (stride 1, pad 1) + folded BatchNorm + ReLU, NHWC.
//
// Replaces the TPU kernel pytorch_cifar_tpu/ops/conv_bn_relu.py:
// conv3x3_bn_relu (Pallas `_kernel`). Same function:
//   out[n, y, x, co] = relu(sum_{ky, kx, ci} x[n, y+ky-1, x+kx-1, ci]
//                           * w[ky, kx, ci, co] * scale[co] + bias[co])
// with zero padding, an fp32 sum, fp32 scale/bias, and one rounding to the
// output type. x is NHWC, w is HWIO, out has x's type (bf16 or fp32).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at bucket
// 128 each of ResNet-18's 64..512-channel sites does 9.66 GFLOP and moves
// 9-34 MB, so it is operation-bound near 10 us; the stem (cin = 3) is
// byte-bound near 5 us. GoogLeNet's 24 shapes (cin 16..192, cout 32..384)
// are operation-bound too.
//
// Two paths, chosen by the wrapper's plan (ops/conv_bn_relu.py: plan):
//
// 1. wgmma (bf16, cin % 8 == 0 and cout % 8 == 0: every zoo site but the
//    three stems). An implicit GEMM, M = pixels, N = cout, K = 9 * cin:
//    - A block is two warpgroups over a 128-pixel M tile and a BN = 64 or
//      128 output-channel N tile. The M tile is a band of `th` rows of one
//      image or, at maps of 64 pixels or fewer, `ib` whole images (8x8: 2,
//      4x4: 8, 2x2: 32), so small maps keep every MMA row busy: the TPU
//      kernel's images-per-program, rethought for 132 SMs (the N tile is
//      64 there, so bucket 128 still gives 128-256 blocks).
//    - K runs in chunks of 16 input channels. A chunk's stage holds the
//      zero-padded input halo of the M tile, [pixel][16 ci] with the two
//      16-byte halves of a pixel swapped every 4 pixels (conflict-free
//      ldmatrix), and the 9 taps' [16 ci][BN co] weight tiles, stored
//      MN-major (HWIO is co-innermost) in the 128-byte-swizzled layout a
//      wgmma descriptor reads with its transpose bit set.
//    - Stages form a ring of 4, filled with cp.async 16-byte copies
//      whose zero-fill supplies the halo's zero border, the channel tail
//      past cin and the images past n. Each chunk's wgmmas are issued
//      first, then the copies of the chunk 3 ahead, then the block waits:
//      the copies and the next chunks' loads overlap the multiplies.
//      BN = 64 tiles on maps of more than 16 pixels are built for two
//      blocks an SM (128 registers a thread, a ring within half the SM's
//      shared memory); BN = 128 tiles, and 4x4 or smaller maps (too few
//      blocks to share an SM), for one. Those three tiles are all the
//      plan chooses, so they are all that is built.
//    - BN is 128 where it pads cout no wider than 64 does (cout 96, 128,
//      208, 224, 256 at maps over 64 pixels), else 64 (cout 192, 288,
//      320, and every map of 64 pixels or fewer, where blocks are few).
//    - Per chunk each warp gathers its A fragments with ldmatrix from
//      per-lane halo addresses (the tap's shift is an address offset, no
//      im2col), then each warpgroup issues 9 wgmma.mma_async m64nBNk16
//      (A from registers, B from shared memory, fp32 accumulators).
//    - Epilogue: acc * scale + bias, ReLU, one rounding to bf16, staged in
//      shared memory and written out in 16-byte NHWC stores.
//    Measured (NVIDIA H100 80GB HBM3, 700 W, bucket-128 bf16, PERF.md):
//    0.317 ms per ResNet-18 forward and 1.676 ms per GoogLeNet forward,
//    against cuDNN's 0.387 and 2.143 in the same run; maps of 8x8 and 4x4
//    still lose to cuDNN (4x4x512: 128 blocks, one an SM).
// 2. sync (fp32, and bf16 with cin or cout not a multiple of 8: the stems),
//    the original design: one block per (image, row tile of <= 64 pixels, 64
//    output channels); per 16-channel chunk the halo and the 9 x 16 x 64
//    weight slice are staged synchronously, then bf16 runs mma.sync
//    m16n8k16 per warp and fp32 the same fragment layout on the CUDA cores
//    with FMAs (TF32 would miss the fp32 tolerance).
//    Measured before this redesign, when it served every site (NVIDIA H100
//    80GB HBM3, 700 W, bucket-128 bf16): 0.673 ms per ResNet-18 forward (6
//    launches) and 3.256 ms per GoogLeNet forward (28), against cuDNN's
//    0.389 and 2.139 ms: every block restaged its whole weight slice, a 4x4
//    map kept 16 of 64 MMA rows busy, and nothing overlapped the copies.
//
// Batch invariance: neither path splits K, and the plan depends on
// (h, w, cin, cout) alone, so an output's summation order is fixed by
// (chunk, tap, channel) and an image sits at the same place of its tile
// whatever n is: rows of a batch equal the same images run alone.

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

// ReLU that keeps a NaN, as jnp.maximum(y, 0) and torch.relu do: fmaxf
// (max.f32) returns the other operand. max.NaN.f32 (sm_80+) returns NaN
// when an operand is NaN and is max.f32 otherwise, in one instruction.
__device__ __forceinline__ float relu_nan(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

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
            dst[0] = IO<T>::from(relu_nan(acc[mf][nf][2 * r] * s0 + b0));
          if (ok1)
            dst[1] =
                IO<T>::from(relu_nan(acc[mf][nf][2 * r + 1] * s1 + b1));
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


// ---------------------------------------------------------------------------
// The wgmma path (bf16)

namespace wg {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kM = 64 * kWarpgroups;  // output pixels per block
constexpr int kKC = 16;               // input channels per stage: one k16
constexpr int kPix = kKC * 2;         // bytes of one halo pixel in a stage
constexpr int kAtom = 1024;           // 8 rows x 128 bytes: a swizzle atom
constexpr int kSmemOptIn = 232448;    // the most one block may ask for
constexpr int kStages = 4;            // the cp.async ring's depth

__host__ __device__ constexpr int round_up(int v, int a) {
  return (v + a - 1) / a * a;
}
// one stage: 9 weight tiles of [16 ci][bn co], then the halo
__host__ __device__ constexpr int weight_bytes(int bn) {
  return 9 * kKC * bn * 2;
}
__host__ __device__ constexpr int stage_bytes(int bn, int halo_px) {
  return weight_bytes(bn) + round_up(halo_px * kPix, kAtom);
}
// the ring, or the epilogue's [kM][bn + 8] bf16 staging tile if larger,
// plus slack to align the base to a swizzle atom
__host__ __device__ constexpr int smem_bytes(int bn, int halo_px) {
  return kAtom + (kStages * stage_bytes(bn, halo_px) > kM * (bn + 8) * 2
                      ? kStages * stage_bytes(bn, halo_px)
                      : kM * (bn + 8) * 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// shared-memory matrix descriptor, 128-byte swizzle: for an MN-major
// operand the leading offset steps 64 columns (one atom across), the stride
// offset 8 k rows (one atom down)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64 x 16, registers) * B (16 x BN, shared memory, MN-major)
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
          WG_D8(48), WG_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef WG_D8

// Block (M tile, N tile): blockIdx.x = (image group, row band), blockIdx.y
// = BN output channels. ib * th * wd <= kM rows are real; ib > 1 only when
// th == h.
// MINB: blocks an SM the kernel is built for. Two cap it at 128 registers
// a thread (BN = 64 only: BN = 128 holds 64 accumulators a thread).
template <int BN, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    conv3x3_bn_relu_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int n, int h, int wd, int cin,
    int cout, int ib, int th) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = round_up(raw, kAtom);  // swizzle atoms: 1 KB aligned
  const int hw = wd + 2, himg = (th + 2) * hw, halo_px = ib * himg;
  const int sbytes = stage_bytes(BN, halo_px);
  const int bands = (h + th - 1) / th;
  const int img0 = (blockIdx.x / bands) * ib;
  const int oy0 = (blockIdx.x % bands) * th;
  const int co0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = (cin + kKC - 1) / kKC;
  const int rows = ib * th * wd;

  // this lane's ldmatrix row (of its warp's 16) and 16-byte half; a row
  // past the tile reads halo pixel 0 and is never stored
  const int arow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ahalf = lane >> 4;
  int apix = 0;
  if (arow < rows) {
    const int r = arow % (th * wd);
    apix = (arow / (th * wd)) * himg + (r / wd) * hw + r % wd;
  }

  auto load_stage = [&](int stage, int chunk) {
    const uint32_t sb = base + stage * sbytes;
    const int c0 = chunk * kKC;
    constexpr int JV = BN / 8;  // 16-byte vectors of one weight row
    for (int i = tid; i < 9 * kKC * JV; i += kThreads) {
      const int j = i % JV, c = (i / JV) % kKC, tap = i / (JV * kKC);
      const int ci = c0 + c, co = co0 + j * 8;
      const bool ok = ci < cin && co < cout;
      const __nv_bfloat16* src =
          ok ? w + ((size_t)tap * cin + ci) * cout + co : w;
      // tap tile: [k atom (c / 8)][n atom (j / 8)][row c % 8][16-byte
      // chunk (j % 8) ^ (c % 8)]
      cp_async16(sb + tap * (kKC * BN * 2) + (c >> 3) * (BN / 64) * kAtom +
                     (j >> 3) * kAtom + (c & 7) * 128 +
                     (((j & 7) ^ (c & 7)) << 4),
                 src, ok);
    }
    const uint32_t ab = sb + weight_bytes(BN);
    for (int i = tid; i < halo_px * 2; i += kThreads) {
      const int p = i >> 1, half = i & 1;
      const int rem = p % himg;
      const int img = img0 + p / himg, iy = oy0 + rem / hw - 1;
      const int ix = rem % hw - 1, ci = c0 + half * 8;
      const bool ok = img < n && iy >= 0 && iy < h && ix >= 0 && ix < wd &&
                      ci < cin;
      const __nv_bfloat16* src =
          ok ? x + (((size_t)img * h + iy) * wd + ix) * cin + ci : x;
      cp_async16(ab + p * kPix + ((half ^ ((p >> 2) & 1)) << 4), src, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load_stage(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  constexpr uint32_t kLbo = kAtom, kSbo = (BN / 64) * kAtom;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's part)
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every part has landed; stage c - 1 is free

    const uint32_t sb = base + (c % kStages) * sbytes;
    const uint32_t ab = sb + weight_bytes(BN);
    uint32_t a[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int q = apix + (tap / 3) * hw + tap % 3;
      ldmatrix_x4(a[tap], ab + q * kPix + ((ahalf ^ ((q >> 2) & 1)) << 4));
    }
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      Mma<BN>::run(acc, a[tap],
                   desc_sw128(sb + tap * (kKC * BN * 2), kLbo, kSbo));
    wgmma_commit();
    // the next copies are issued while the tensor cores multiply
    if (c + kStages - 1 < chunks)
      load_stage((c + kStages - 1) % kStages, c + kStages - 1);
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the epilogue over it

  constexpr int ES = BN + 8;  // staging row, elements: conflict-free writes
  __nv_bfloat16* e =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw));
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + 2 * t, co = co0 + col;
    const bool ok = co < cout;  // cout % 8 == 0: both columns or neither
    const float s0 = ok ? scale[co] : 0.f, s1 = ok ? scale[co + 1] : 0.f;
    const float b0 = ok ? bias[co] : 0.f, b1 = ok ? bias[co + 1] : 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = warp * 16 + g + 8 * rr;
      *reinterpret_cast<__nv_bfloat162*>(e + row * ES + col) =
          __floats2bfloat162_rn(relu_nan(acc[4 * j + 2 * rr] * s0 + b0),
                                relu_nan(acc[4 * j + 2 * rr + 1] * s1 + b1));
    }
  }
  __syncthreads();
  constexpr int JV = BN / 8;
  for (int i = tid; i < kM * JV; i += kThreads) {
    const int m = i / JV, j = i % JV, co = co0 + j * 8;
    if (m >= rows || co >= cout) continue;
    const int r = m % (th * wd);
    const int img = img0 + m / (th * wd), oy = oy0 + r / wd;
    if (img >= n || oy >= h) continue;
    *reinterpret_cast<uint4*>(out + (((size_t)img * h + oy) * wd + r % wd) *
                                        cout + co) =
        *reinterpret_cast<const uint4*>(e + m * ES + j * 8);
  }
}

template <int BN, int MINB>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, int n, int h, int wd, int cin,
           int cout, int ib, int th, int smem, cudaStream_t stream) {
  // set once per instantiation (thread-safe static init; one device per
  // process); each launch asks only for its own plan's bytes
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_bn_relu_wgmma_kernel<BN, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles =
      (long long)((n + ib - 1) / ib) * ((h + th - 1) / th);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (cout + BN - 1) / BN);
  conv3x3_bn_relu_wgmma_kernel<BN, MINB>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), scale, bias,
      static_cast<__nv_bfloat16*>(out), n, h, wd, cin, cout, ib, th);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// The wgmma path. (ib, th, bn, minb, smem) is the wrapper's plan;
// it is checked here against the shape and the kernel's own shared-memory
// sum.
extern "C" int conv3x3_bn_relu_bf16_wgmma(
    const void* x, const void* w, const float* scale, const float* bias,
    void* out, int n, int h, int wd, int cin, int cout, int ib, int th,
    int bn, int minb, int smem, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || cin % 8 ||
      cout % 8 || ib <= 0 || th <= 0 || th > h || (ib > 1 && th != h) ||
      ib * th * wd > wg::kM || smem > wg::kSmemOptIn ||
      smem != wg::smem_bytes(bn, ib * (th + 2) * (wd + 2)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_CASE(BN, MB)                                                      \
  if (bn == BN && minb == MB)                                                \
    return wg::launch<BN, MB>(x, w, scale, bias, out, n, h, wd, cin, cout,   \
                              ib, th, smem, s);
  WG_CASE(64, 2) WG_CASE(64, 1) WG_CASE(128, 1)
#undef WG_CASE
  return (int)cudaErrorInvalidValue;
}
