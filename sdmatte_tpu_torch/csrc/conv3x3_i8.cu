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
// What bounds it on the H100: operations. The VAE's shapes do 2*9*Cin
// integer operations per output element against ~1-2 bytes moved, far above
// the ridge. The design is K3's (csrc/conv3x3.cu) on bytes: a block computes
// a TH x TW output tile for BN output channels; per BKC-channel chunk of the
// input it stages the tile's input window (TH+2 x TW+2 at stride 1, 2TH+1 x
// 2TW+1 at stride 2) and the chunk's weights for all nine taps in shared
// memory with cp.async (zero-filled past the image and past Cin, so an
// out-of-image tap adds exactly 0: int8 has no zero point), then runs the
// nine shifted products with mma.sync m16n8k32 s8.s8.s32. ldmatrix gathers
// the shifted (or, at stride 2, every other) window row per lane. The
// Pallas kernel's t+1 window prefetch needs a sequential grid and is
// dropped; two resident blocks per SM overlap loads with products at stride
// 1. wgmma on s8 with TMA is later work.
//
// Exactness: the int32 sums are exact (|acc| <= 9 * Cin * 127^2 < 2^31 for
// Cin <= 14,700). The epilogue converts with round-to-nearest
// (__int2float_rn, as JAX's int32 -> fp32) and uses __fmul_rn / __fadd_rn,
// so nvcc cannot contract it into an FMA: an fp32 output is the plain
// version's to the bit.
//
// Memory layout: x is NHWC (an NCHW int8 tensor in torch.channels_last), w is
// (Cout, 3, 3, Cin) (an OIHW weight in channels_last), scale and bias are
// (Cout) fp32, y is (B, Ho, Wo, Cout). When Cin is a multiple of 16 and x and
// w are 16-byte aligned the loads are 16-byte cp.async; otherwise a masked
// byte gather (the Cin = 3 and 4 convs).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16, BN = 128, BKC = 64, WARPS_M = 4, WARPS_N = 2;
constexpr int kThreads = WARPS_M * WARPS_N * 32;
constexpr int kLd = BKC + 16;  // bytes per staged row: 80 keeps ldmatrix conflict-free at stride 1

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

template <int S>
struct I8Smem {
  static constexpr int kWinH = (TH - 1) * S + 3;
  static constexpr int kWinW = (TW - 1) * S + 3;
  static constexpr int kWinPix = kWinH * kWinW;
  static constexpr size_t kWinBytes = size_t(kWinPix) * kLd;
  static constexpr size_t kWBytes = size_t(9) * BN * kLd;
  static constexpr size_t kSmem = kWinBytes + kWBytes;
};

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
__global__ void __launch_bounds__(kThreads, S == 1 ? 2 : 1) conv3x3_i8_kernel(const I8Params p) {
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

template <int S, typename OutT>
cudaError_t launch(const I8Params& p, cudaStream_t stream) {
  using SM = I8Smem<S>;
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
  p.tiles_x = (Wo + TW - 1) / TW;
  p.tiles_y = (Ho + TH - 1) / TH;
  p.co_tiles = (Cout + BN - 1) / BN;
  p.vec = (Cin % 16 == 0) && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return int(dispatch<float>(p, stride, s));
  if (out_dtype == 1) return int(dispatch<__nv_bfloat16>(p, stride, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
