// 3x3, stride-1, zero-pad-1 convolution as an implicit GEMM, hand-written for
// Hopper (sm_90a), with an optional GroupNorm-affine + SiLU prologue and an
// optional residual epilogue:
//
//   y = conv3x3(pro(x), w) + bias [+ residual],  pro(x) = silu(x * a[b,c] + d[b,c])
//
// Replaces sdmatte_tpu/ops/conv3x3.py::_kernel_v5 (and covers the padded-halo
// ::_kernel, whose only reason to exist was shapes v5 could not tile: this
// kernel masks its own ragged edges).
//
// What bounds it on the H100: operations. The VAE encoder's shapes do
// 2*9*Cin flops per output element against ~2 bytes read and written, far
// above the ridge. So the design keeps every tensor-core operand in shared
// memory and reuses it: a block computes a TH x TW pixel tile for BN output
// channels; per BKC-channel chunk of the input it stages one (TH+2) x (TW+2)
// halo window (the prologue is applied once per element, as it lands) and the
// chunk's weights for all nine taps, then runs the nine shifted products from
// shared memory with mma.sync m16n8k16 bf16 -> fp32 (ldmatrix gathers the
// shifted window rows directly). Pixels outside the image are zero AFTER the
// prologue, since silu(0*a+d) = silu(d) != 0. There is no cross-block
// prefetch (the TPU kernel's t+1 prefetch needs a sequential grid); two
// blocks per SM overlap one block's loads with the other's products.
// wgmma/TMA pipelining is later work.
//
// Memory layout: x, residual and y are NHWC (the port's NCHW tensors in
// torch.channels_last), w is (Cout, 3, 3, Cin) (an OIHW weight in
// channels_last), a and d are (B, Cin) fp32, bias is (Cout) fp32.
// Any Cout works (output channels past Cout are masked); Cin must be a
// multiple of the chunk (32 for bf16, 16 for fp32).
//
// fp32 inputs run the same tiling and masking with the products done by plain
// FMA on the same fragment layout (no tensor cores), so the kernel can be
// checked at fp32 tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct ConvParams {
  const void* x;
  const void* w;
  const float* bias;
  const float* a;
  const float* d;
  const void* res;
  void* y;
  int B, H, W, Cin, Cout;
  int tiles_x, tiles_y, co_tiles;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct ConvShape;
// bf16: 8x16 pixels x 128 channels per block, 32-channel chunks, 8 warps as 4 (M) x 2 (N).
template <>
struct ConvShape<__nv_bfloat16> {
  static constexpr int TH = 8, TW = 16, BN = 128, BKC = 32, WARPS_M = 4, WARPS_N = 2;
  static constexpr bool kTensorCores = true;
  static constexpr int kMinBlocks = 2;
};
// fp32 (the check path): same tile, 16-channel chunks to fit shared memory.
template <>
struct ConvShape<float> {
  static constexpr int TH = 8, TW = 16, BN = 128, BKC = 16, WARPS_M = 4, WARPS_N = 2;
  static constexpr bool kTensorCores = false;
  static constexpr int kMinBlocks = 1;
};

template <typename T>
struct ConvSmem {
  using C = ConvShape<T>;
  static constexpr int kThreads = C::WARPS_M * C::WARPS_N * 32;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLd = C::BKC + kPad;  // row stride of window and weight rows
  static constexpr int kWinPix = (C::TH + 2) * (C::TW + 2);
  static constexpr size_t kWinBytes = size_t(kWinPix) * kLd * sizeof(T);
  static constexpr size_t kWBytes = size_t(9) * C::BN * kLd * sizeof(T);
  static constexpr size_t kSmem = kWinBytes + kWBytes;
};

template <typename T, bool kAffine, bool kResidual>
__global__ void __launch_bounds__(ConvSmem<T>::kThreads, ConvShape<T>::kMinBlocks)
    conv3x3_kernel(const ConvParams p) {
  using C = ConvShape<T>;
  using SM = ConvSmem<T>;
  constexpr int TH = C::TH, TW = C::TW, BN = C::BN, BKC = C::BKC;
  constexpr int kThreads = SM::kThreads;
  constexpr int kLd = SM::kLd;
  constexpr int WWD = TW + 2;
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPR = BKC / EPV;       // vectors per chunk row
  constexpr int WM = TH * TW / C::WARPS_M;  // pixels per warp
  constexpr int WN = BN / C::WARPS_N;       // channels per warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  static_assert(TW == 16, "an m-tile is one tile row");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BKC % EPV == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + SM::kWinBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp % C::WARPS_M;
  const int warp_n = warp / C::WARPS_M;

  // Blocks that share a pixel tile are adjacent, so its window stays in L2.
  const int co_t = blockIdx.x % p.co_tiles;
  const int tile = blockIdx.x / p.co_tiles;
  const int tx0 = (tile % p.tiles_x) * TW;
  const int ty0 = ((tile / p.tiles_x) % p.tiles_y) * TH;
  const int b = tile / (p.tiles_x * p.tiles_y);
  const int co0 = co_t * BN;

  const T* xg = static_cast<const T*>(p.x) + (long long)b * p.H * p.W * p.Cin;
  const T* wg = static_cast<const T*>(p.w);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c0 = 0; c0 < p.Cin; c0 += BKC) {
    __syncthreads();  // the previous chunk's products are done with Xs and Ws
    // weights of this chunk, all nine taps: Ws[tap][n][k]
    for (int i = tid; i < 9 * BN * VPR; i += kThreads) {
      const int tap = i / (BN * VPR);
      const int rem = i % (BN * VPR);
      const int n = rem / VPR;
      const int v = rem % VPR;
      const int co = co0 + n;
      const bool valid = co < p.Cout;
      const T* src = wg + ((long long)co * 9 + tap) * p.Cin + c0 + v * EPV;
      cp_async16(Ws + (tap * BN + n) * kLd + v * EPV, valid ? src : wg, valid);
    }
    cp_async_commit();
    // halo window of this chunk, prologue applied as it lands
    for (int i = tid; i < SM::kWinPix * VPR; i += kThreads) {
      const int pix = i / VPR;
      const int v = i % VPR;
      const int y = ty0 + pix / WWD - 1;
      const int x = tx0 + pix % WWD - 1;
      const int c = c0 + v * EPV;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
        raw = *reinterpret_cast<const uint4*>(xg + ((long long)y * p.W + x) * p.Cin + c);
        if constexpr (kAffine) {
          T* e = reinterpret_cast<T*>(&raw);
          const float* ab = p.a + (long long)b * p.Cin + c;
          const float* db = p.d + (long long)b * p.Cin + c;
#pragma unroll
          for (int j = 0; j < EPV; ++j) e[j] = from_f<T>(silu(to_f(e[j]) * ab[j] + db[j]));
        }
      }
      *reinterpret_cast<uint4*>(Xs + pix * kLd + v * EPV) = raw;
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const T* Wt = Ws + tap * BN * kLd;
      if constexpr (C::kTensorCores) {
#pragma unroll
        for (int ks = 0; ks < BKC / 16; ++ks) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int ty = warp_m * MT + mt;
            const int pix = (ty + dy) * WWD + (lane & 15) + dx;
            ldmatrix_x4(af[mt], Xs + pix * kLd + ks * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bf[4];
            const int n = warp_n * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(bf, Wt + n * kLd + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
              mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
            }
          }
        }
      } else {
        for (int k = 0; k < BKC; ++k) {
          float xa[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int ty = warp_m * MT + mt;
            xa[mt][0] = to_f(Xs[((ty + dy) * WWD + g + dx) * kLd + k]);
            xa[mt][1] = to_f(Xs[((ty + dy) * WWD + g + 8 + dx) * kLd + k]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = warp_n * WN + nt * 8 + tig * 2;
            const float w0 = to_f(Wt[n * kLd + k]), w1 = to_f(Wt[(n + 1) * kLd + k]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              acc[mt][nt][0] += xa[mt][0] * w0;
              acc[mt][nt][1] += xa[mt][0] * w1;
              acc[mt][nt][2] += xa[mt][1] * w0;
              acc[mt][nt][3] += xa[mt][1] * w1;
            }
          }
        }
      }
    }
  }

  // ---- epilogue: bias, residual, masked store ----
  T* yg = static_cast<T*>(p.y);
  const T* rg = static_cast<const T*>(p.res);
  const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = ty0 + warp_m * MT + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = tx0 + g + half * 8;
      if (y >= p.H || x >= p.W) continue;
      const long long pix = ((long long)b * p.H + y) * p.W + x;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = co0 + warp_n * WN + nt * 8 + tig * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ne = n + e;
          v[e] = acc[mt][nt][half * 2 + e];
          if (ne < p.Cout) {
            if (p.bias) v[e] += p.bias[ne];
            if constexpr (kResidual) v[e] += to_f(rg[pix * p.Cout + ne]);
          }
        }
        if (pairs && n + 1 < p.Cout) {
          if constexpr (C::kTensorCores) {
            __nv_bfloat162 pr = __floats2bfloat162_rn(v[0], v[1]);
            *reinterpret_cast<__nv_bfloat162*>(yg + pix * p.Cout + n) = pr;
          } else {
            *reinterpret_cast<float2*>(yg + pix * p.Cout + n) = make_float2(v[0], v[1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < p.Cout) yg[pix * p.Cout + n + e] = from_f<T>(v[e]);
        }
      }
    }
  }
}

template <typename T, bool kAffine, bool kResidual>
cudaError_t launch(const ConvParams& p, cudaStream_t stream) {
  using SM = ConvSmem<T>;
  auto kern = conv3x3_kernel<T, kAffine, kResidual>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SM::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x * p.co_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<dim3(unsigned(blocks)), SM::kThreads, SM::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const ConvParams& p, cudaStream_t s) {
  const bool aff = p.a != nullptr, res = p.res != nullptr;
  if (aff && res) return launch<T, true, true>(p, s);
  if (aff) return launch<T, true, false>(p, s);
  if (res) return launch<T, false, true>(p, s);
  return launch<T, false, false>(p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a/d (B, Cin) fp32 or both null; bias
// (Cout) fp32 or null; res (B, H, W, Cout) or null.  Returns a cudaError_t.
extern "C" int sdm_conv3x3(int dtype, const void* x, const void* w, const float* bias,
                           const float* a, const float* d, const void* res, void* y, int B, int H,
                           int W, int Cin, int Cout, void* stream) {
  ConvParams p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.a = a;
  p.d = d;
  p.res = res;
  p.y = y;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using C = ConvShape<__nv_bfloat16>;
    if (Cin % C::BKC) return int(cudaErrorInvalidValue);
    p.tiles_x = (W + C::TW - 1) / C::TW;
    p.tiles_y = (H + C::TH - 1) / C::TH;
    p.co_tiles = (Cout + C::BN - 1) / C::BN;
    return int(dispatch<__nv_bfloat16>(p, s));
  }
  if (dtype == 0) {
    using C = ConvShape<float>;
    if (Cin % C::BKC) return int(cudaErrorInvalidValue);
    p.tiles_x = (W + C::TW - 1) / C::TW;
    p.tiles_y = (H + C::TH - 1) / C::TH;
    p.co_tiles = (Cout + C::BN - 1) / C::BN;
    return int(dispatch<float>(p, s));
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
