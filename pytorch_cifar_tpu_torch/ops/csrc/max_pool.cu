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
// > alone would let a NaN pass only at tap 0. Of several NaNs the last in
// tap order wins.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Training forward:
// read E elements, write E elements and E map bytes, (2s + 1) * E bytes;
// inference forward 2s * E; backward reads g and the map and writes gi,
// (2s + 1) * E. Nine taps per output read straight from device memory
// would move 9x the bytes through L1/L2; the forward reads each input once,
// and the work between its loads and stores is what it has to keep small:
// a per-element scan in fp32 left the first strip design (and the design it
// replaces) issue-bound, at 38-40% of the bound in bf16 (NVIDIA H100 80GB
// HBM3, 700 W).
//
// Forward design, the TPU kernel's separable max_h(max_w(x)) on a
// shared-memory strip (the wrapper's plan, ops/max_pool.py: plan, picks the
// tile, and the entry point checks it):
// - One block per (group of `ib` whole images, or a band of `rows` output
//   rows of one image; chunk of `ccv` channel vectors of V channels), the
//   chunk fastest in blockIdx.x so that the chunks of one pixel, whose
//   writes may share a 32-byte sector (C = 528: a map row is 528 bytes),
//   run side by side. Its thread of (channel vector, column, image) stages
//   its own vector of the band's rows and of the rows above and below with
//   cp.async (16 bytes where C and the pointers allow it; a 2-byte vector,
//   bf16 and odd C, is below cp.async's smallest copy and is staged with a
//   plain load) into a tile of (rows + 2) x (w + 2) pixels whose border
//   outside the map holds -inf, so no tap needs a bound check. Neighbouring
//   bands of one image are neighbouring blocks: a halo row read twice comes
//   from L2.
// - Each thread walks down its band: the 3-tap w-pass of each tile row is
//   computed once (three shared-memory loads), and a window of three row
//   results (best value, winning column) slides in registers; the h-pass
//   over the window gives the output and the winner 3 * row + column. Each
//   pass starts from its first tap (left column, row above) and takes the
//   next two under v > best || v != v: over the -inf border that is
//   exactly the plain version's 9-tap scan (first maximum in row-major
//   order, the last NaN, a window whose real taps are all -inf keeping tap
//   0 in the halo).
// - A vector is worked on as 32-bit words, two bf16 lanes or one fp32 lane
//   each: a compare gives a mask per lane (set.gt / set.neu on bf16x2),
//   and a take is two bitwise selects, of the value's own bits (the output
//   is the winner's bits, +-0 and NaN payloads as they came) and of its tap
//   index in the same lanes. A bf16 never leaves its 16 bits. The output
//   and, under autograd, one uint8 map byte per element are written once.
// The design it replaces (one thread per (pixel, channel vector), nine tap
// loads through L1/L2) took 2.442 ms with the map and 1.994 without per
// b512 bf16 GoogLeNet step (9 launches) against bounds of 0.930 and 0.744
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Backward, the forward's strip turned around (the wrapper's plan with
// backward=True: the same chunks, a tile of g and the map, elem + 1 bytes
// a channel): a gather, no atomics. A block stages its band's g rows and
// winner-map rows, and the rows above and below, by cp.async into a tile
// whose border outside the map holds g = 0 and map = 255 (names no tap),
// so no tap needs a bound check and each map byte and g element leaves
// device memory once (a halo row is read twice, from L2). Each thread
// walks its (column, vector) down the band with the 3 x 3 windows' cells
// that contain it sliding in registers: input position p sums, for t =
// 0..8 in order, the g of the window that sees p as its tap t (window
// (y - dy + 1, x - dx + 1), t = 3 dy + dx) where that window's map names
// t, in fp32 from +0, and rounds once; the plain version's bits. Map bytes
// are compared four at a time (add_tap) and a lane's byte mask selects
// the g bits (a bf16 widened by shifting them), so an unmatched tap adds
// +0, never g * 0: a NaN or an infinity that no window routes to p never
// reaches p's sum. A window whose winner is tap 0 in the halo (every real
// tap -inf) names no position: its gradient is dropped, as on the TPU.
// What bounds it: in fp32 the bytes (83% of the bound per b512 GoogLeNet
// step); in bf16, with half the bytes for the same nine selects and adds
// an element, the issue of that work (63%): 1.475 ms against a 0.930 ms
// bound, where the design it replaces (one thread per (pixel, vector),
// nine map and g loads per output through L1/L2) took 2.337 in the same
// call (NVIDIA H100 80GB HBM3, 700 W). Staging row by row with barriers
// between, and a compare and predicated add per channel, were no faster.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "nhwc_vec.cuh"

namespace {

constexpr int kMaxThreads = 512;   // a plan's block, at most (both ways)
constexpr int kSmemOptIn = 232448;

// A vector of V elements is worked on as N 32-bit words: two bf16 lanes or
// one fp32 lane each (a lone bf16 sits in the low lane beside a -inf).
// Every compare yields a mask per lane, and a take is two bitwise selects:
// the value's own bits and its tap index, kept in the same lanes.
template <typename IO, int V>
struct Lanes {
  static constexpr int kBytes = V * static_cast<int>(sizeof(typename IO::S));
  static constexpr int N = kBytes >= 4 ? kBytes / 4 : 1;
  static constexpr uint32_t kOne = sizeof(typename IO::S) == 2 ? 0x00010001u : 1u;
};

// lanes where cur takes over best: cur > best, or cur is a NaN
__device__ __forceinline__ uint32_t take_mask(BF16, uint32_t cur,
                                              uint32_t best) {
  uint32_t gt, nan;
  asm("set.gt.u32.bf16x2 %0, %1, %2;\n" : "=r"(gt) : "r"(cur), "r"(best));
  asm("set.neu.u32.bf16x2 %0, %1, %1;\n" : "=r"(nan) : "r"(cur));
  return gt | nan;
}

__device__ __forceinline__ uint32_t take_mask(F32, uint32_t cur,
                                              uint32_t best) {
  const float c = __uint_as_float(cur), b = __uint_as_float(best);
  return c > b || c != c ? 0xFFFFFFFFu : 0u;
}

// the best so far of a scan and the tap that gave it, lane by lane
template <typename IO, int V>
struct Best {
  uint32_t val[Lanes<IO, V>::N], tap[Lanes<IO, V>::N];

  __device__ __forceinline__ void start(const uint32_t (&v)[Lanes<IO, V>::N],
                                        const uint32_t (&t)[Lanes<IO, V>::N]) {
#pragma unroll
    for (int i = 0; i < Lanes<IO, V>::N; ++i) {
      val[i] = v[i];
      tap[i] = t[i];
    }
  }
  // the scan's next tap: v with tap index t (+ add in every lane)
  __device__ __forceinline__ void take(const uint32_t (&v)[Lanes<IO, V>::N],
                                       const uint32_t (&t)[Lanes<IO, V>::N],
                                       uint32_t add) {
#pragma unroll
    for (int i = 0; i < Lanes<IO, V>::N; ++i) {
      const uint32_t m = take_mask(IO{}, v[i], val[i]);
      val[i] = (v[i] & m) | (val[i] & ~m);
      tap[i] = ((t[i] + add) & m) | (tap[i] & ~m);
    }
  }
};

template <typename IO, int V>
__device__ __forceinline__ void load_lanes(const typename IO::S* p,
                                           uint32_t (&w)[Lanes<IO, V>::N]) {
  using L = Lanes<IO, V>;
  if constexpr (L::kBytes == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else if constexpr (L::kBytes == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x, w[1] = q.y;
  } else if constexpr (L::kBytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {  // one bf16; the high lane -inf never takes
    w[0] = 0xFF800000u | *reinterpret_cast<const uint16_t*>(p);
  }
}

template <typename IO, int V>
__device__ __forceinline__ void store_lanes(typename IO::S* p,
                                            const uint32_t (&w)[Lanes<IO, V>::N]) {
  using L = Lanes<IO, V>;
  if constexpr (L::kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (L::kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (L::kBytes == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  }
}

// the V tap indices (one per lane, each < 9) as V map bytes
template <typename IO, int V>
__device__ __forceinline__ void store_taps(uint8_t* p,
                                           const uint32_t (&t)[Lanes<IO, V>::N]) {
  if constexpr (sizeof(typename IO::S) == 2) {  // 16-bit lanes
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(__byte_perm(t[0], t[1], 0x6420),
                                                __byte_perm(t[2], t[3], 0x6420));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(p) = __byte_perm(t[0], t[1], 0x6420);
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint16_t*>(p) =
          static_cast<uint16_t>(__byte_perm(t[0], 0, 0x0020));
    } else {
      *p = static_cast<uint8_t>(t[0]);
    }
  } else {  // 32-bit lanes
    if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(p) =
          __byte_perm(__byte_perm(t[0], t[1], 0x0040),
                      __byte_perm(t[2], t[3], 0x0040), 0x5410);
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint16_t*>(p) =
          static_cast<uint16_t>(__byte_perm(t[0], t[1], 0x0040));
    } else {
      *p = static_cast<uint8_t>(t[0]);
    }
  }
}

// the w-pass of one tile row at a thread's column: taps at columns -1, 0,
// +1 (the tile's pad columns hold -inf), started from the first
template <typename IO, int V>
__device__ __forceinline__ Best<IO, V> w_pass(const typename IO::S* at,
                                              int pv) {
  using L = Lanes<IO, V>;
  uint32_t left[L::N], mid[L::N], right[L::N], zero[L::N];
  load_lanes<IO, V>(at - pv, left);
  load_lanes<IO, V>(at, mid);
  load_lanes<IO, V>(at + pv, right);
#pragma unroll
  for (int i = 0; i < L::N; ++i) zero[i] = 0;
  Best<IO, V> b;
  b.start(left, zero);
  b.take(mid, zero, L::kOne);
  b.take(right, zero, 2 * L::kOne);
  return b;
}

template <typename IO, int V, bool MAP>
__global__ void __launch_bounds__(kMaxThreads) max_pool_fwd_kernel(
    const typename IO::S* __restrict__ x, typename IO::S* __restrict__ out,
    uint8_t* __restrict__ idx, int n, int h, int w, int c, int ib, int rows,
    int ccv) {
  using S = typename IO::S;
  using L = Lanes<IO, V>;
  // block -> (image group, band, channel chunk), the chunk fastest: the
  // chunks of one pixel run side by side, so writes that share a sector
  // meet in L2
  const int cvt = c / V;
  const int chunks = (cvt + ccv - 1) / ccv;
  const int bands = (h + rows - 1) / rows;
  const int cv0 = (blockIdx.x % chunks) * ccv;
  const int tile = blockIdx.x / chunks;
  const int img0 = (tile / bands) * ib;
  const int oy0 = (tile % bands) * rows;
  const int pv = ccv * V;              // elements of one tile pixel
  const int row_step = (w + 2) * pv;   // elements of one tile row
  const int tr = rows + 2;             // tile rows of one image
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [image][tile row][column + 1][pv]: tile row r is input row oy0 - 1 + r,
  // rows and columns outside the map hold -inf
  S* ts = reinterpret_cast<S*>(smem_raw);

  // thread -> (channel vector, column, image); it stages its own vector of
  // every tile row, and the pad columns beside it at the map's edges
  const int v = threadIdx.x % ccv;
  const int col = (threadIdx.x / ccv) % w;
  const int im = threadIdx.x / (ccv * w);
  const int img = img0 + im, cv = cv0 + v;
  const bool live = im < ib && img < n && cv < cvt;
  S* mine = ts + ((size_t)im * tr * (w + 2) + col + 1) * pv + v * V;
  const S* src = x + (((long long)img * h + oy0 - 1) * w + col) * c + cv * V;
  if (live) {
    Pack<S, V> neg;
#pragma unroll
    for (int e = 0; e < V; ++e) neg.v[e] = IO::neg_inf();
    for (int r = 0; r < tr; ++r) {
      S* dst = mine + (size_t)r * row_step;
      const int iy = oy0 - 1 + r;
      if (iy >= 0 && iy < h)
        copy_async<V * sizeof(S)>(dst, src + (long long)r * w * c, true);
      else
        store<S, V>(dst, neg);
      if (col == 0) store<S, V>(dst - pv, neg);
      if (col == w - 1) store<S, V>(dst + pv, neg);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (!live) return;

  // a window of three w-passes slides down the band; the h-pass over it
  // starts from the row above and names tap 3 * row + column
  Best<IO, V> above = w_pass<IO, V>(mine, pv);
  Best<IO, V> here = w_pass<IO, V>(mine + row_step, pv);
  const long long first = (((long long)img * h + oy0) * w + col) * c + cv * V;
  const long long out_step = (long long)w * c;
  const int count = oy0 + rows < h ? rows : h - oy0;
  for (int k = 0; k < count; ++k) {
    const Best<IO, V> below = w_pass<IO, V>(mine + (size_t)(k + 2) * row_step, pv);
    Best<IO, V> b;
    b.start(above.val, above.tap);
    b.take(here.val, here.tap, 3 * L::kOne);
    b.take(below.val, below.tap, 6 * L::kOne);
    store_lanes<IO, V>(out + first + k * out_step, b.val);
    if (MAP) store_taps<IO, V>(idx + first + k * out_step, b.tap);
    above = here;
    here = below;
  }
}

// One tile pixel's staged vector for the backward: V cotangents as 32-bit
// words (two bf16 or one fp32 each; a lone bf16 in the low half) and the
// V winner-map bytes (padded with bytes that are never read).
template <typename IO, int V>
struct Cell {
  static constexpr int kGBytes = V * static_cast<int>(sizeof(typename IO::S));
  static constexpr int GW = kGBytes >= 4 ? kGBytes / 4 : 1;
  static constexpr int MW = V >= 4 ? V / 4 : 1;
  uint32_t g[GW], m[MW];

  __device__ __forceinline__ void load(const typename IO::S* gp,
                                       const uint8_t* mp) {
    if constexpr (kGBytes == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(gp);
      g[0] = q.x, g[1] = q.y, g[2] = q.z, g[3] = q.w;
    } else if constexpr (kGBytes == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(gp);
      g[0] = q.x, g[1] = q.y;
    } else if constexpr (kGBytes == 4) {
      g[0] = *reinterpret_cast<const uint32_t*>(gp);
    } else {
      g[0] = *reinterpret_cast<const uint16_t*>(gp);
    }
    if constexpr (V == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(mp);
      m[0] = q.x, m[1] = q.y;
    } else if constexpr (V == 4) {
      m[0] = *reinterpret_cast<const uint32_t*>(mp);
    } else if constexpr (V == 2) {
      m[0] = *reinterpret_cast<const uint16_t*>(mp);
    } else {
      m[0] = *mp;
    }
  }
};

// prmt.b32 in its default mode: a selector nibble with its msb set
// replicates the sign bit of the byte it picks
__device__ __forceinline__ uint32_t prmt_sign(uint32_t a, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(0u), "r"(sel));
  return r;
}

// acc[e] += (map byte e == t ? g[e] : +0.0f), lane by lane, for one tap.
// Four map bytes are compared at once: map bytes and t lie below 0x80 (or
// are 0xFF), so ((m ^ t) | 0x80) - 1 borrows within its own byte and
// leaves bit 7 set exactly where m != t; a sign-replicating prmt turns
// that into a byte mask, which clears the cotangent's bits (a bf16 widened
// by shifting them) where the map names another tap. An unmatched lane
// thus adds the bits of +0.0: a NaN or an infinity in a cotangent that no
// window routes here never reaches the sum. (__vcmpeq4 in place of the
// borrow was slower: the compare is a fair part of the work a tap does.)
template <typename IO, int V>
__device__ __forceinline__ void add_tap(float (&acc)[V], const Cell<IO, V>& c,
                                        uint32_t t) {
  // bit 7 of each byte of ne: that map byte differs from t
  uint32_t ne[Cell<IO, V>::MW];
#pragma unroll
  for (int i = 0; i < Cell<IO, V>::MW; ++i)
    ne[i] = ((c.m[i] ^ (t * 0x01010101u)) | 0x80808080u) - 0x01010101u;
  if constexpr (sizeof(typename IO::S) == 2) {
#pragma unroll
    for (int e = 0; e < V; e += 2) {  // one word: elements e, e + 1
      const int b = e % 4;            // their map bytes b, b + 1
      const uint32_t pair = prmt_sign(ne[e / 4], 0x9988 + b * 0x1111);
      const uint32_t w = c.g[e / 2] & ~pair;
      acc[e] += __uint_as_float(w << 16);
      if (e + 1 < V) acc[e + 1] += __uint_as_float(w & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t mask = prmt_sign(ne[e / 4], 0x8888 + (e % 4) * 0x1111);
      acc[e] += __uint_as_float(c.g[e] & ~mask);
    }
  }
}

template <typename IO, int V>
__global__ void __launch_bounds__(kMaxThreads) max_pool_bwd_kernel(
    const typename IO::S* __restrict__ g, const uint8_t* __restrict__ idx,
    typename IO::S* __restrict__ gi, int n, int h, int w, int c, int ib,
    int rows, int ccv) {
  using S = typename IO::S;
  // block -> (image group, band, channel chunk) and thread -> (channel
  // vector, column, image), as in the forward; the tile row r holds the
  // windows of row oy0 - 1 + r, so input row oy0 + k is tap row 2, 1, 0
  // of tile rows k, k + 1, k + 2
  const int cvt = c / V;
  const int chunks = (cvt + ccv - 1) / ccv;
  const int bands = (h + rows - 1) / rows;
  const int cv0 = (blockIdx.x % chunks) * ccv;
  const int tile = blockIdx.x / chunks;
  const int img0 = (tile / bands) * ib;
  const int oy0 = (tile % bands) * rows;
  const int pv = ccv * V;
  const int row_step = (w + 2) * pv;
  const int tr = rows + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [image][tile row][column + 1][pv] of g, then the same of map bytes;
  // outside the map g is 0 and the map 255, which names no tap
  S* gs = reinterpret_cast<S*>(smem_raw);
  uint8_t* ms = smem_raw + (size_t)ib * tr * row_step * sizeof(S);

  const int v = threadIdx.x % ccv;
  const int col = (threadIdx.x / ccv) % w;
  const int im = threadIdx.x / (ccv * w);
  const int img = img0 + im, cv = cv0 + v;
  const bool live = im < ib && img < n && cv < cvt;
  const size_t at = ((size_t)im * tr * (w + 2) + col + 1) * pv + v * V;
  const long long src = (((long long)img * h + oy0 - 1) * w + col) * c + cv * V;
  if (live) {
    Pack<S, V> zero;
    Pack<uint8_t, V> none;
#pragma unroll
    for (int e = 0; e < V; ++e) zero.v[e] = S(0), none.v[e] = 255;
    for (int r = 0; r < tr; ++r) {
      const size_t d = at + (size_t)r * row_step;
      const int iy = oy0 - 1 + r;
      if (iy >= 0 && iy < h) {
        copy_async<V * sizeof(S)>(gs + d, g + src + (long long)r * w * c, true);
        copy_async<V>(ms + d, idx + src + (long long)r * w * c, true);
      } else {
        store<S, V>(gs + d, zero);
        store<uint8_t, V>(ms + d, none);
      }
      if (col == 0) {
        store<S, V>(gs + d - pv, zero);
        store<uint8_t, V>(ms + d - pv, none);
      }
      if (col == w - 1) {
        store<S, V>(gs + d + pv, zero);
        store<uint8_t, V>(ms + d + pv, none);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (!live) return;

  // three tile rows of the three windows' cells (columns x - 1, x, x + 1)
  // slide down the band; input row oy0 + k sums tap t = 3 dy + dx from the
  // window at tile row k + 2 - dy, column x + 1 - dx, in the order t = 0..8
  Cell<IO, V> win[3][3];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      win[r + 1][j].load(gs + at + r * row_step + (j - 1) * pv,
                         ms + at + r * row_step + (j - 1) * pv);
  const long long first = (((long long)img * h + oy0) * w + col) * c + cv * V;
  const long long out_step = (long long)w * c;
  const int count = oy0 + rows < h ? rows : h - oy0;
  for (int k = 0; k < count; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      win[0][j] = win[1][j];
      win[1][j] = win[2][j];
      win[2][j].load(gs + at + (k + 2) * row_step + (j - 1) * pv,
                     ms + at + (k + 2) * row_step + (j - 1) * pv);
    }
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      add_tap<IO, V>(acc, win[2 - t / 3][2 - t % 3], t);
    Pack<S, V> r;
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = IO::from_float(acc[e]);
    store<S, V>(gi + first + k * out_step, r);
  }
}

template <typename IO, int V, bool MAP>
int launch_fwd(const void* x, void* out, void* idx, int n, int h, int w,
               int c, int ib, int rows, int ccv, int smem, unsigned blocks,
               cudaStream_t s) {
  using S = typename IO::S;
  // set once per instantiation (thread-safe static init; one device per
  // process); each launch asks only for its own plan's bytes
  static const cudaError_t attr = cudaFuncSetAttribute(
      max_pool_fwd_kernel<IO, V, MAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  max_pool_fwd_kernel<IO, V, MAP>
      <<<blocks, ib * w * ccv, smem, s>>>(
          static_cast<const S*>(x), static_cast<S*>(out),
          static_cast<uint8_t*>(idx), n, h, w, c, ib, rows, ccv);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, V>) for the vector of vec elements: 16, 8,
// 4 or 2 bytes
template <typename IO, typename F>
int with_vec(int vec, F&& f) {
  using S = typename IO::S;
  switch (vec * static_cast<int>(sizeof(S))) {
    case 16: return f(std::integral_constant<int, 16 / sizeof(S)>{});
    case 8: return f(std::integral_constant<int, 8 / sizeof(S)>{});
    case 4: return f(std::integral_constant<int, 4 / sizeof(S)>{});
    case 2:
      if constexpr (sizeof(S) == 2) return f(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the tile a plan gives: ib images of (rows + 2) x (w + 2) pixels of
// ccv vectors of vec channels, `staged` bytes a channel
inline long long tile_bytes(int ib, int rows, int w, int ccv, int vec,
                            int staged) {
  return (long long)ib * (rows + 2) * (w + 2) * ccv * vec * staged;
}

// the checks the forward and the backward share: the shape, the wrapper's
// plan (ib, rows, ccv, smem) for `staged` bytes a channel, and alignment;
// sets the plan's grid, (image groups x bands x channel chunks) blocks
inline int check_plan(const void* a, const void* b, const void* idx, int n,
                      int h, int w, int c, int vec, int elem, int ib,
                      int rows, int ccv, int smem, int staged,
                      unsigned* blocks) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || vec <= 0 || c % vec ||
      ib <= 0 || rows <= 0 || rows > h || (ib > 1 && rows != h) ||
      ccv <= 0 || ccv > c / vec || (long long)ib * w * ccv > kMaxThreads ||
      smem > kSmemOptIn ||
      smem != tile_bytes(ib, rows, w, ccv, vec, staged))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(a, vec * elem) || !aligned(b, vec * elem) ||
      (idx != nullptr && !aligned(idx, vec)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long grid = (long long)((n + ib - 1) / ib) *
                         ((h + rows - 1) / rows) * ((c / vec + ccv - 1) / ccv);
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(grid);
  return 0;
}

// vec = channels per thread: c % vec == 0 and every pointer aligned to vec
// elements (the wrapper picks the widest, up to 16 bytes); (ib, rows, ccv,
// smem) is the wrapper's plan, checked here
template <typename IO>
int forward(const void* x, void* out, void* idx, int n, int h, int w, int c,
            int vec, int ib, int rows, int ccv, int smem,
            void* stream) {
  using S = typename IO::S;
  unsigned blocks;
  const int bad = check_plan(x, out, idx, n, h, w, c, vec, sizeof(S), ib, rows,
                             ccv, smem, sizeof(S), &blocks);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_vec<IO>(vec, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    return idx != nullptr
        ? launch_fwd<IO, V, true>(x, out, idx, n, h, w, c, ib, rows,
                                  ccv, smem, blocks, s)
        : launch_fwd<IO, V, false>(x, out, nullptr, n, h, w, c, ib, rows,
                                   ccv, smem, blocks, s);
  });
}

template <typename IO>
int backward(const void* g, const void* idx, void* gi, int n, int h, int w,
             int c, int vec, int ib, int rows, int ccv, int smem,
             void* stream) {
  using S = typename IO::S;
  if (idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks;
  const int bad = check_plan(g, gi, idx, n, h, w, c, vec, sizeof(S), ib, rows,
                             ccv, smem, sizeof(S) + 1, &blocks);
  if (bad) return bad;
  return with_vec<IO>(vec, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    static const cudaError_t attr = cudaFuncSetAttribute(
        max_pool_bwd_kernel<IO, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    max_pool_bwd_kernel<IO, V>
        <<<blocks, ib * w * ccv, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const S*>(g), static_cast<const uint8_t*>(idx),
            static_cast<S*>(gi), n, h, w, c, ib, rows, ccv);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// x (n, h, w, c) -> out (n, h, w, c) and, when idx is not null, the uint8
// winner map idx (n, h, w, c).
extern "C" int max_pool3x3_fwd_bf16(const void* x, void* out, void* idx, int n,
                                    int h, int w, int c, int vec, int ib,
                                    int rows, int ccv, int smem,
                                    void* stream) {
  return forward<BF16>(x, out, idx, n, h, w, c, vec, ib, rows, ccv,
                       smem, stream);
}

extern "C" int max_pool3x3_fwd_f32(const void* x, void* out, void* idx, int n,
                                   int h, int w, int c, int vec, int ib,
                                   int rows, int ccv, int smem,
                                   void* stream) {
  return forward<F32>(x, out, idx, n, h, w, c, vec, ib, rows, ccv,
                      smem, stream);
}

// g, idx (n, h, w, c) -> gi (n, h, w, c): each window's g to its winner;
// (ib, rows, ccv, smem) is the wrapper's backward plan, checked here.
extern "C" int max_pool3x3_bwd_bf16(const void* g, const void* idx, void* gi,
                                    int n, int h, int w, int c, int vec,
                                    int ib, int rows, int ccv, int smem,
                                    void* stream) {
  return backward<BF16>(g, idx, gi, n, h, w, c, vec, ib, rows, ccv, smem,
                        stream);
}

extern "C" int max_pool3x3_bwd_f32(const void* g, const void* idx, void* gi,
                                   int n, int h, int w, int c, int vec,
                                   int ib, int rows, int ccv, int smem,
                                   void* stream) {
  return backward<F32>(g, idx, gi, n, h, w, c, vec, ib, rows, ccv, smem,
                       stream);
}
