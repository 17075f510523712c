// 3x3 int8 convolution as an implicit GEMM, hand-written for Hopper (sm_90a):
//
//   acc = conv3x3(xq, wq)                  int8 x int8 -> exact int32 sums
//   y   = float(acc) * scale[c] (+ bias[c])  fp32, written as bf16 or fp32
//
// with scale = s_x * w_scale (the caller folds the per-tensor activation scale
// into the per-output-channel weight scale). Replaces
// sdmatte_tpu/ops/conv3x3.py::_kernel_i8, and also takes the int8 convs that
// the JAX package leaves to XLA on the same path: stride 2 with the
// downsampler's (0, 1), (0, 1) padding, and channel counts that are not a
// multiple of anything (Cin 3 and 4, Cout 3 and 8).
//
// What bounds it on the H100: operations for the wide convs (2*9*Cin integer
// operations per output element against ~1-2 bytes moved, far above the
// ridge), bytes for the narrow ones (Cin 3/4: the output write; Cout 3/8: the
// input read).  Three kernels share the exact epilogue:
//   - conv3x3_i8_sm90 (stride 1, Cin a multiple of 16: the main path).  K3's
//     design (csrc/conv3x3.cu) on bytes: a block computes 4 image rows x 64
//     pixels for BN output channels with two consumer warpgroups on wgmma
//     m64nBNk32 s8 x s8 -> s32, A and B from shared memory by descriptor
//     (integer wgmma takes both K-major, which is what NHWC pixels and
//     (Cout, 3, 3, Cin) weights are).  Two producer threads keep TMA loads in
//     flight through mbarrier rings: one 128-byte-swizzled (4+2) x 66 pixel
//     window per 128-channel chunk (a pixel is one 128-byte row; pixels
//     outside the image and channels past Cin arrive as zeros, and int8 has
//     no zero point, so they add exactly 0) and one weight tile per (chunk,
//     tap).  A tap's shift moves the A tile's start by whole pixel rows of the
//     one window, so the nine taps share a single copy.  The block is
//     persistent: it walks over tiles with the rings running on, so the next
//     tile's loads land under this tile's products and epilogue (a Cin = 128
//     conv has one chunk per tile, nothing else to hide its loads under).
//     BN = 128, or 8 for the convs of at most 8 output channels (conv_out),
//     which would otherwise compute 128 channels to keep 3.
//   - conv3x3_i8_fold (stride 1, Cin 3 or 4: conv_in).  The nine taps fold
//     into K: 27 or 36 values are one or two k32 steps.  These rows are not
//     16-byte aligned for TMA, so the threads gather the im2col rows into the
//     swizzled layout themselves (fence.proxy.async before wgmma reads them).
//   - conv3x3_i8_kernel, the first design (mma.sync m16n8k32 fed by ldmatrix
//     from a cp.async-staged window): stride 2, whose every-other-pixel rows
//     are no contiguous wgmma tile, and any other Cin.
// The Pallas kernel's t+1 window prefetch needs a sequential grid; the
// persistent block's rings take its place.
//
// Exactness: the int32 sums are exact (|acc| <= 9 * Cin * 127^2 < 2^31 for
// Cin <= 14,700; wgmma without .satfinite wraps, it never clamps). The
// epilogue converts with round-to-nearest (__int2float_rn, as JAX's int32 ->
// fp32) and uses __fmul_rn / __fadd_rn, so nvcc cannot contract it into an
// FMA: an fp32 output is the plain version's to the bit.
//
// Memory layout: x is NHWC (an NCHW int8 tensor in torch.channels_last), w is
// (Cout, 3, 3, Cin) (an OIHW weight in channels_last), scale and bias are
// (Cout) fp32, y is (B, Ho, Wo, Cout).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// the first design's tiling (conv3x3_i8_kernel)
namespace v1 {
constexpr int TH = 8, TW = 16, BN = 128, BKC = 64, WARPS_M = 4, WARPS_N = 2;
constexpr int kThreads = WARPS_M * WARPS_N * 32;
constexpr int kLd = BKC + 16;  // bytes per staged row: 80 keeps ldmatrix conflict-free at stride 1
}  // namespace v1

struct I8Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* y;
  int B, H, W, Cin, Cout, Ho, Wo;
  int pad_top, pad_left;
  int tiles_x, tiles_y, co_tiles;
  int vec;  // 16-byte loads allowed
};

namespace v1 {
template <int S>
struct I8Smem {
  static constexpr int kWinH = (TH - 1) * S + 3;
  static constexpr int kWinW = (TW - 1) * S + 3;
  static constexpr int kWinPix = kWinH * kWinW;
  static constexpr size_t kWinBytes = size_t(kWinPix) * kLd;
  static constexpr size_t kWBytes = size_t(9) * BN * kLd;
  static constexpr size_t kSmem = kWinBytes + kWBytes;
};
}  // namespace v1

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Four 8x8 b16 matrices = four 8-row x 16-byte int8 tiles; thread t receives
// bytes 4*(t%4)..+3 of row t/4 of each, which is the s8 fragment layout of
// mma m16n8k32 (A: a0..a3, B: b0, b1 of two n-tiles).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bytes of row `row` at channel c (c % 4 == 0), zero past n and past the row's end.
__device__ __forceinline__ uint32_t gather4(const int8_t* row, int c, int n) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) v |= uint32_t(uint8_t(row[c + j])) << (8 * j);
  return v;
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* dst, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <int S, typename OutT>
__global__ void __launch_bounds__(v1::kThreads, S == 1 ? 2 : 1)
    conv3x3_i8_kernel(const I8Params p) {
  using namespace v1;
  using SM = I8Smem<S>;
  constexpr int WWD = SM::kWinW;
  constexpr int VPR = BKC / 16;             // 16-byte vectors per staged row
  constexpr int WM = TH * TW / WARPS_M;     // output pixels per warp
  constexpr int WN = BN / WARPS_N;          // output channels per warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  static_assert(TW == 16, "an m-tile is one tile row");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BKC % 32 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + SM::kWinBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp % WARPS_M;
  const int warp_n = warp / WARPS_M;

  // Blocks that share an output tile are adjacent, so its window stays in L2.
  const int co_t = blockIdx.x % p.co_tiles;
  const int tile = blockIdx.x / p.co_tiles;
  const int ox0 = (tile % p.tiles_x) * TW;
  const int oy0 = ((tile / p.tiles_x) % p.tiles_y) * TH;
  const int b = tile / (p.tiles_x * p.tiles_y);
  const int co0 = co_t * BN;
  const int iy0 = oy0 * S - p.pad_top;   // input row of window row 0
  const int ix0 = ox0 * S - p.pad_left;

  const int8_t* xg = p.x + (long long)b * p.H * p.W * p.Cin;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int c0 = 0; c0 < p.Cin; c0 += BKC) {
    __syncthreads();  // the previous chunk's products are done with Xs and Ws
    if (p.vec) {
      // weights of this chunk, all nine taps: Ws[tap][n][k]
      for (int i = tid; i < 9 * BN * VPR; i += kThreads) {
        const int tap = i / (BN * VPR);
        const int rem = i % (BN * VPR);
        const int n = rem / VPR;
        const int c = c0 + (rem % VPR) * 16;
        const int co = co0 + n;
        const bool valid = co < p.Cout && c < p.Cin;
        const int8_t* src = p.w + ((long long)co * 9 + tap) * p.Cin + c;
        cp_async16(Ws + (tap * BN + n) * kLd + (rem % VPR) * 16, valid ? src : p.w, valid);
      }
      // input window of this chunk, zero outside the image
      for (int i = tid; i < SM::kWinPix * VPR; i += kThreads) {
        const int pix = i / VPR;
        const int v = i % VPR;
        const int y = iy0 + pix / WWD;
        const int x = ix0 + pix % WWD;
        const int c = c0 + v * 16;
        const bool valid = y >= 0 && y < p.H && x >= 0 && x < p.W && c < p.Cin;
        const int8_t* src = xg + ((long long)y * p.W + x) * p.Cin + c;
        cp_async16(Xs + pix * kLd + v * 16, valid ? src : p.x, valid);
      }
      cp_async_commit();
      cp_async_wait_all();
    } else {
      constexpr int WPR = BKC / 4;  // 4-byte words per staged row
      for (int i = tid; i < 9 * BN * WPR; i += kThreads) {
        const int tap = i / (BN * WPR);
        const int rem = i % (BN * WPR);
        const int n = rem / WPR;
        const int c = c0 + (rem % WPR) * 4;
        const int co = co0 + n;
        uint32_t v = 0;
        if (co < p.Cout) v = gather4(p.w + ((long long)co * 9 + tap) * p.Cin, c, p.Cin);
        *reinterpret_cast<uint32_t*>(Ws + (tap * BN + n) * kLd + (rem % WPR) * 4) = v;
      }
      for (int i = tid; i < SM::kWinPix * WPR; i += kThreads) {
        const int pix = i / WPR;
        const int c = c0 + (i % WPR) * 4;
        const int y = iy0 + pix / WWD;
        const int x = ix0 + pix % WWD;
        uint32_t v = 0;
        if (y >= 0 && y < p.H && x >= 0 && x < p.W)
          v = gather4(xg + ((long long)y * p.W + x) * p.Cin, c, p.Cin);
        *reinterpret_cast<uint32_t*>(Xs + pix * kLd + (i % WPR) * 4) = v;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int8_t* Wt = Ws + tap * BN * kLd;
#pragma unroll
      for (int ks = 0; ks < BKC / 32; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ty = warp_m * MT + mt;
          const int pix = (ty * S + dy) * WWD + (lane & 15) * S + dx;
          ldmatrix_x4(af[mt], Xs + pix * kLd + ks * 32 + (lane >> 4) * 16);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          const int n = warp_n * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bf, Wt + n * kLd + ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_s8(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_s8(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // ---- epilogue: dequantize, bias, masked store ----
  OutT* yg = static_cast<OutT*>(p.y);
  const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = oy0 + warp_m * MT + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = ox0 + g + half * 8;
      if (y >= p.Ho || x >= p.Wo) continue;
      const long long pix = ((long long)b * p.Ho + y) * p.Wo + x;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = co0 + warp_n * WN + nt * 8 + tig * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ne = n + e;
          v[e] = 0.f;
          if (ne < p.Cout) {
            v[e] = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), p.scale[ne]);
            if (p.bias) v[e] = __fadd_rn(v[e], p.bias[ne]);
          }
        }
        if (pairs && n + 1 < p.Cout) {
          store2<OutT>(yg + pix * p.Cout + n, v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < p.Cout) store1(yg + pix * p.Cout + n + e, v[e]);
        }
      }
    }
  }
}

// ---- Hopper: TMA, wgmma on s8, warp specialisation ---------------------------

struct Epilogue {
  const float* scale;
  const float* bias;
  void* y;
  int Ho, Wo, Cout;
};

// One m64 x BN tile of int32 sums in the wgmma accumulator layout (thread
// (warp, g, tig) holds rows 16 * warp + g and + 8, columns 8 * jj + 2 * tig
// and + 1) -> 64 pixels of output row (b, y) from column x0, channels from
// co0.  Dequantized exactly; fp32 goes out from the registers, bf16 through a
// staging tile of the warpgroup for 16-byte stores.  `bar` is a named barrier
// of the warpgroup's 128 threads.
template <int BN, typename OutT>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], const Epilogue& e,
                                           __nv_bfloat16* stage, int bar, int b, int y, int x0,
                                           int co0, int tw) {
  constexpr int kLd = BN + 8;  // staged row stride: conflict-free fragment writes
  constexpr bool kF32 = sizeof(OutT) == 4;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
  const int r = warp * 16 + g;
  const bool row_ok = y < e.Ho;
  const long long row = ((long long)b * e.Ho + y) * e.Wo;  // pixel index of (b, y, 0)
  OutT* yg = static_cast<OutT*>(e.y);
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int cc = jj * 8 + tig * 2;
    float v[4];  // (r, cc), (r, cc + 1), (r + 8, cc), (r + 8, cc + 1)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int co = co0 + cc + q;
      const bool ok = co < e.Cout;
      const float sc = ok ? __ldg(e.scale + co) : 0.f;
      float lo = __fmul_rn(__int2float_rn(acc[4 * jj + q]), sc);
      float hi = __fmul_rn(__int2float_rn(acc[4 * jj + 2 + q]), sc);
      if (e.bias != nullptr && ok) {
        const float bv = __ldg(e.bias + co);
        lo = __fadd_rn(lo, bv);
        hi = __fadd_rn(hi, bv);
      }
      v[q] = lo;
      v[2 + q] = hi;
    }
    if constexpr (kF32) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = x0 + r + 8 * half, co = co0 + cc;
        if (!row_ok || x >= e.Wo || co >= e.Cout) continue;
        float* dst = reinterpret_cast<float*>(yg) + (row + x) * e.Cout + co;
        if ((e.Cout & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[2 * half], v[2 * half + 1]);
        } else {
          dst[0] = v[2 * half];
          if (co + 1 < e.Cout) dst[1] = v[2 * half + 1];
        }
      }
    } else {
      *reinterpret_cast<uint32_t*>(stage + r * kLd + cc) = sm90::pack_bf16(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(stage + (r + 8) * kLd + cc) = sm90::pack_bf16(v[2], v[3]);
    }
    // keeps the compiler from hoisting all of the tile's scale and bias loads
    // (64 registers) above the first store
    if ((jj & 3) == 3) asm volatile("" ::: "memory");
  }
  if constexpr (!kF32) {
    constexpr int G = BN / 8;  // 16-byte groups per pixel
    sm90::named_bar_sync(bar, 128);
    if (row_ok) {
      for (int i = tw; i < 64 * G; i += 128) {
        const int px = i / G, cc = (i % G) * 8;
        const int x = x0 + px, co = co0 + cc;
        if (x >= e.Wo || co >= e.Cout) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(stage + px * kLd + cc);
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(yg) + (row + x) * e.Cout + co;
        if ((e.Cout & 7) == 0) {
          *reinterpret_cast<uint4*>(dst) = val;
        } else {
          const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (co + k < e.Cout) dst[k] = sv[k];
        }
      }
    }
    sm90::named_bar_sync(bar, 128);  // the staging tile is free again
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128)
    sm90::wgmma_s8_m64n128(d, da, db, acc);
  else
    sm90::wgmma_s8_m64n8(d, da, db, acc);
}

namespace h90 {
constexpr int TH = 4, TW = 64, BKC = 128;  // 4 image rows x 64 px, 128-channel chunks
constexpr int kWinCols = TW + 2, kWinPix = (TH + 2) * kWinCols;  // 6 x 66 halo window
// one chunk of a window: 396 pixel rows of 128 B (128-byte swizzle), to a
// multiple of 1024 B
constexpr int kWinBytes = (kWinPix * 128 + 1023) / 1024 * 1024;
constexpr int kWinStages = 2;
constexpr int kWStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
template <int BN>
struct Layout {
  static constexpr int kWBytes = BN * 128;  // one (chunk, tap) weight tile: BN Cout x 128 Cin
  static constexpr int kOffW = kWinStages * kWinBytes;
  static constexpr int kStageBytes = 64 * (BN + 8) * 2;  // a warpgroup's bf16 staging tile
  static constexpr int kOffStage = kOffW + kWStages * kWBytes;
  static constexpr int kOffBar = kOffStage + 2 * kStageBytes;
  static constexpr int kBars = 2 * kWinStages + 2 * kWStages;
  static constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;  // + slack to align the base
  static_assert(kOffW % 1024 == 0 && kWBytes % 1024 == 0 && kOffBar % 8 == 0, "layout");
};
}  // namespace h90

struct I8Params90 {
  CUtensorMap tx;  // x as (Cin, W, H, B), box (128, 66, TH + 2, 1), 128-byte swizzle
  CUtensorMap tw;  // w as (Cin, 9, Cout), box (128, 1, BN), 128-byte swizzle
  Epilogue epi;
  int Cin, pad_top, pad_left;
  int tiles_x, tiles_y, co_tiles, ntiles;
};

// A persistent block: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the
// (batch, tile row, tile column, Cout tile) grid, Cout tiles innermost so that
// blocks working side by side share a window in L2.  Per tile an implicit
// GEMM with M = 4 x 64 pixels, N = BN, K = 9 * Cin, iterated as (128-channel
// chunk, tap).  Warpgroup 2 produces: thread 0 streams the (chunk, tap)
// weight tiles and thread 32 the windows, each through its own mbarrier ring,
// across tile boundaries.  Warpgroups 0 and 1 consume: each owns two image
// rows (two m64 tiles) and runs the nine taps of a chunk from the one window.
template <int BN, typename OutT>
__global__ void __launch_bounds__(h90::kThreads, 1)
    conv3x3_i8_sm90(const __grid_constant__ I8Params90 p) {
  using namespace h90;
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* win_full = bars;
  uint64_t* win_empty = bars + kWinStages;
  uint64_t* w_full = bars + 2 * kWinStages;
  uint64_t* w_empty = w_full + kWStages;

  const int nchunks = (p.Cin + BKC - 1) / BKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWinStages; ++s) {
      sm90::mbar_init(win_full + s, 1);
      sm90::mbar_init(win_empty + s, 256);
    }
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(w_full + s, 1);
      sm90::mbar_init(w_empty + s, 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<56>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      int it = 0;  // weight tiles issued so far
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const int co0 = (tile % p.co_tiles) * BN;
        for (int i = 0; i < nchunks * 9; ++i, ++it) {
          const int st = it % kWStages;
          sm90::mbar_wait(w_empty + st, ((it / kWStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(w_full + st, L::kWBytes);
          sm90::tma_load_3d(smem + L::kOffW + st * L::kWBytes, &p.tw, w_full + st, (i / 9) * BKC,
                            i % 9, co0);
        }
      }
    } else if (pt == 32) {
      int wi = 0;  // windows issued so far
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const int t = tile / p.co_tiles;
        const int x0 = (t % p.tiles_x) * TW;
        const int y0 = ((t / p.tiles_x) % p.tiles_y) * TH;
        const int b = t / (p.tiles_x * p.tiles_y);
        for (int c = 0; c < nchunks; ++c, ++wi) {
          const int ws = wi % kWinStages;
          sm90::mbar_wait(win_empty + ws, ((wi / kWinStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(win_full + ws, kWinPix * 128);
          sm90::tma_load_4d(smem + ws * kWinBytes, &p.tx, win_full + ws, c * BKC,
                            x0 - p.pad_left, y0 - p.pad_top, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<224>();
    const int wg = threadIdx.x >> 7;
    const int tw = threadIdx.x & 127;
    const uint32_t win0 = sm90::smem_u32(smem);
    const uint32_t w0 = sm90::smem_u32(smem + L::kOffW);
    __nv_bfloat16* stage =
        reinterpret_cast<__nv_bfloat16*>(smem + L::kOffStage + wg * L::kStageBytes);

    int it = 0, wi = 0;  // weight tiles and windows consumed so far
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      const int co0 = (tile % p.co_tiles) * BN;
      const int t = tile / p.co_tiles;
      const int x0 = (t % p.tiles_x) * TW;
      const int y0 = ((t / p.tiles_x) % p.tiles_y) * TH;
      const int b = t / (p.tiles_x * p.tiles_y);

      int acc[2][BN / 2];  // written first by the tile's first product (accumulate = 0)
      for (int c = 0; c < nchunks; ++c, ++wi) {
        const int ws = wi % kWinStages;
        sm90::mbar_wait(win_full + ws, (wi / kWinStages) & 1);
        const uint32_t win = win0 + ws * kWinBytes;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int st = it % kWStages;
          const int dy = tap / 3, dx = tap % 3;
          const uint32_t wt = w0 + st * L::kWBytes;
          sm90::mbar_wait(w_full + st, (it / kWStages) & 1);
          // window pixel of this warpgroup's first row at this tap
          const int pix0 = (wg * 2 + dy) * kWinCols + dx;
          sm90::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BKC / 32; ++ks) {
            const uint64_t db = sm90::desc_kmajor_sw128(wt + ks * 32);
#pragma unroll
            for (int mr = 0; mr < 2; ++mr) {
              const uint32_t aa = win + (pix0 + mr * kWinCols) * 128 + ks * 32;
              wgmma_s8<BN>(acc[mr], sm90::desc_kmajor_sw128(aa), db, (c | tap | ks) != 0);
            }
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous tap's products are done
          if ((c | tap) != 0) {
            sm90::mbar_arrive(w_empty + (it - 1) % kWStages);
            if (tap == 0) sm90::mbar_arrive(win_empty + (wi - 1) % kWinStages);
          }
        }
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int mr = 0; mr < 2; ++mr) sm90::reg_fence(acc[mr]);
      sm90::mbar_arrive(w_empty + (it - 1) % kWStages);
      sm90::mbar_arrive(win_empty + (wi - 1) % kWinStages);

#pragma unroll
      for (int mr = 0; mr < 2; ++mr)
        store_tile<BN, OutT>(acc[mr], p.epi, stage, 2 + wg, b, y0 + wg * 2 + mr, x0, co0, tw);
    }
  }
}

// ---- Cin 3 and 4: the nine taps folded into K -----------------------------------

namespace fold {
constexpr int TH = 4, TW = 64, BN = 128, kThreads = 256;
constexpr int kABytes = TH * 64 * 128;  // four m64 tiles of 128-byte im2col rows
constexpr int kBBytes = BN * 128;
constexpr int kStageBytes = 64 * (BN + 8) * 2;
constexpr int kOffB = kABytes, kOffStage = kOffB + kBBytes;
constexpr size_t kSmem = kOffStage + 2 * kStageBytes + 1024;
}  // namespace fold

// One block: 4 rows x 64 pixels x 128 output channels.  Thread t gathers the
// im2col row of pixel t (k = tap * CIN + c, the order of a (Cout, 3, 3, CIN)
// weight row) into registers with independent byte loads, then writes it as
// 16-byte chunks into a K-major tile with the 128-byte swizzle, of which only
// the first one or two k32 steps are used; the weight rows likewise.  Bytes
// past 9 * CIN and taps outside the image are zero.  Each warpgroup then runs
// its two image rows one after the other (64 accumulator registers), so two
// blocks share an SM and one's stores run under the other's gather.
template <int CIN, typename OutT>
__global__ void __launch_bounds__(fold::kThreads, 2) conv3x3_i8_fold(const I8Params p) {
  using namespace fold;
  constexpr int K = 9 * CIN, kSteps = (K + 31) / 32;
  static_assert(kSteps <= 2, "the folded taps fill at most two k32 steps");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int co0 = (blockIdx.x % p.co_tiles) * BN;
  const int tile = blockIdx.x / p.co_tiles;
  const int x0 = (tile % p.tiles_x) * TW;
  const int y0 = ((tile / p.tiles_x) % p.tiles_y) * TH;
  const int b = tile / (p.tiles_x * p.tiles_y);

  const int t = threadIdx.x;
  {
    const int px = t & 63, sw = px & 7;
    const int oy = y0 + (t >> 6), ox = x0 + px;
    const int8_t* xg = p.x + (long long)b * p.H * p.W * CIN;
    uint32_t row[kSteps * 8];
#pragma unroll
    for (int i = 0; i < kSteps * 8; ++i) row[i] = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int iy = oy - p.pad_top + tap / 3, ix = ox - p.pad_left + tap % 3;
      const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int8_t* src = xg + ((long long)iy * p.W + ix) * CIN;
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const int k = tap * CIN + c;
        const uint32_t v = in ? uint32_t(uint8_t(__ldg(src + c))) : 0u;
        row[k >> 2] |= v << (8 * (k & 3));
      }
    }
    unsigned char* arow = smem + (t >> 6) * 8192 + px * 128;
#pragma unroll
    for (int c16 = 0; c16 < kSteps * 2; ++c16)
      *reinterpret_cast<uint4*>(arow + ((c16 ^ sw) << 4)) =
          make_uint4(row[4 * c16], row[4 * c16 + 1], row[4 * c16 + 2], row[4 * c16 + 3]);

    // weights: thread t takes k32 step t & 1 of row t >> 1
    const int n = t >> 1, ks = t & 1, co = co0 + n;
    if (ks < kSteps) {
      const int8_t* wsrc = p.w + (long long)co * K;
      uint32_t wd[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) wd[i] = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k = ks * 32 + i;
        const uint32_t v = (k < K && co < p.Cout) ? uint32_t(uint8_t(__ldg(wsrc + k))) : 0u;
        wd[i >> 2] |= v << (8 * (i & 3));
      }
      unsigned char* brow = smem + kOffB + n * 128;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<uint4*>(brow + (((ks * 2 + q) ^ (n & 7)) << 4)) =
            make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2], wd[4 * q + 3]);
    }
  }
  sm90::fence_proxy_async();  // the generic writes, before wgmma reads them
  __syncthreads();

  const int wg = t >> 7, tw = t & 127;
  const uint32_t a0 = sm90::smem_u32(smem), b0 = sm90::smem_u32(smem + kOffB);
  Epilogue e;
  e.scale = p.scale, e.bias = p.bias, e.y = p.y;
  e.Ho = p.Ho, e.Wo = p.Wo, e.Cout = p.Cout;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + kOffStage + wg * kStageBytes);
#pragma unroll 1
  for (int mr = 0; mr < 2; ++mr) {
    int acc[BN / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      sm90::wgmma_s8_m64n128(acc, sm90::desc_kmajor_sw128(a0 + (wg * 2 + mr) * 8192 + ks * 32),
                             sm90::desc_kmajor_sw128(b0 + ks * 32), ks != 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(acc);
    store_tile<BN, OutT>(acc, e, stage, 1 + wg, b, y0 + wg * 2 + mr, x0, co0, tw);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

template <int BN, typename OutT>
cudaError_t launch_sm90(const I8Params& c, cudaStream_t stream) {
  using namespace h90;
  using L = Layout<BN>;
  I8Params90 p;
  const uint64_t cin = c.Cin, w = c.W, h = c.H;
  const uint64_t xdims[4] = {cin, w, h, uint64_t(c.B)};
  const uint64_t xstrides[3] = {cin, w * cin, h * w * cin};
  const uint32_t xbox[4] = {BKC, kWinCols, TH + 2, 1};
  cudaError_t err =
      sm90::make_map_int8(&p.tx, 4, c.x, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {cin, 9, uint64_t(c.Cout)};
  const uint64_t wstrides[2] = {cin, 9 * cin};
  const uint32_t wbox[3] = {BKC, 1, BN};
  err = sm90::make_map_int8(&p.tw, 3, c.w, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  p.epi.scale = c.scale, p.epi.bias = c.bias, p.epi.y = c.y;
  p.epi.Ho = c.Ho, p.epi.Wo = c.Wo, p.epi.Cout = c.Cout;
  p.Cin = c.Cin, p.pad_top = c.pad_top, p.pad_left = c.pad_left;
  p.tiles_x = (c.Wo + TW - 1) / TW;
  p.tiles_y = (c.Ho + TH - 1) / TH;
  p.co_tiles = (c.Cout + BN - 1) / BN;
  const long long ntiles = (long long)c.B * p.tiles_y * p.tiles_x * p.co_tiles;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  p.ntiles = int(ntiles);
  auto kern = conv3x3_i8_sm90<BN, OutT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kSmem));
  if (err != cudaSuccess) return err;
  const int blocks = p.ntiles < sm_count() ? p.ntiles : sm_count();
  kern<<<dim3(unsigned(blocks)), kThreads, L::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int CIN, typename OutT>
cudaError_t launch_fold(I8Params p, cudaStream_t stream) {
  p.tiles_x = (p.Wo + fold::TW - 1) / fold::TW;
  p.tiles_y = (p.Ho + fold::TH - 1) / fold::TH;
  p.co_tiles = (p.Cout + fold::BN - 1) / fold::BN;
  auto kern = conv3x3_i8_fold<CIN, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(fold::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x * p.co_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<dim3(unsigned(blocks)), fold::kThreads, fold::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Which kernel takes a conv: 0 the first design, 1 conv3x3_i8_sm90 at BN = 128,
// 2 the same at BN = 8, 3 conv3x3_i8_fold.
int route_of(int Cin, int Cout, int stride, bool aligned16) {
  if (stride != 1) return 0;
  if (Cin % 16 == 0 && aligned16) return Cout <= 8 ? 2 : 1;
  if (Cin == 3 || Cin == 4) return 3;
  return 0;
}

template <int S, typename OutT>
cudaError_t launch(I8Params p, cudaStream_t stream) {
  using namespace v1;
  using SM = I8Smem<S>;
  p.tiles_x = (p.Wo + TW - 1) / TW;
  p.tiles_y = (p.Ho + TH - 1) / TH;
  p.co_tiles = (p.Cout + BN - 1) / BN;
  auto kern = conv3x3_i8_kernel<S, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SM::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x * p.co_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<dim3(unsigned(blocks)), kThreads, SM::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const I8Params& p, int stride, cudaStream_t s) {
  if (stride == 1) return launch<1, OutT>(p, s);
  if (stride == 2) return launch<2, OutT>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, Cin) int8, w (Cout, 3,
// 3, Cin) int8, scale (Cout) fp32, bias (Cout) fp32 or null, y (B, Ho, Wo,
// Cout).  Output pixel (oy, ox) reads input rows oy * stride - pad_top + 0..2
// and columns ox * stride - pad_left + 0..2.  Returns a cudaError_t.
extern "C" int sdm_conv3x3_i8(int out_dtype, const void* x, const void* w, const float* scale,
                              const float* bias, void* y, int B, int H, int W, int Cin, int Cout,
                              int Ho, int Wo, int stride, int pad_top, int pad_left,
                              void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || Cout <= 0) return int(cudaErrorInvalidValue);
  I8Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = scale;
  p.bias = bias;
  p.y = y;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.Ho = Ho;
  p.Wo = Wo;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.tiles_x = p.tiles_y = p.co_tiles = 0;  // set by the launcher for its tiling
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  p.vec = (Cin % 16 == 0) && aligned;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype != 0 && out_dtype != 1) return int(cudaErrorInvalidValue);
  const bool f32 = out_dtype == 0;
  switch (route_of(Cin, Cout, stride, aligned)) {
    case 1:
      return int(f32 ? launch_sm90<128, float>(p, s) : launch_sm90<128, __nv_bfloat16>(p, s));
    case 2:
      return int(f32 ? launch_sm90<8, float>(p, s) : launch_sm90<8, __nv_bfloat16>(p, s));
    case 3:
      if (Cin == 3)
        return int(f32 ? launch_fold<3, float>(p, s) : launch_fold<3, __nv_bfloat16>(p, s));
      return int(f32 ? launch_fold<4, float>(p, s) : launch_fold<4, __nv_bfloat16>(p, s));
    default:
      return int(f32 ? dispatch<float>(p, stride, s) : dispatch<__nv_bfloat16>(p, stride, s));
  }
}

// The kernel a conv of these sizes is routed to, given 16-byte aligned x and
// w: 0 conv3x3_i8_kernel (the first design), 1 conv3x3_i8_sm90 at 128 output
// channels a tile, 2 the same at 8, 3 conv3x3_i8_fold.
extern "C" int sdm_conv3x3_i8_route(int Cin, int Cout, int stride) {
  return route_of(Cin, Cout, stride, true);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
