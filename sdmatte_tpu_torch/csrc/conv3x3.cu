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
// above the ridge, so the design feeds the tensor cores from shared memory
// and keeps the loads and the prologue off their critical path:
//   - bf16 (conv3x3_sm90, the main path): a block computes 4 image rows x 64
//     pixels for 128 output channels with two consumer warpgroups on wgmma
//     m64n128k16 (fp32 accumulation), A and B from shared memory, and one
//     producer warpgroup: one thread fills, by TMA and mbarriers, a 4-stage
//     ring of (64-channel chunk, tap) weight tiles; three warps fill a
//     3-stage ring of halo windows (one 128-byte-swizzled copy per chunk) and
//     apply the GN affine + SiLU prologue once per window element, in place,
//     so the nine taps share it and it runs under the products of earlier
//     chunks.  The prologue is bound by the SFU (MUFU): SiLU as h + h*tanh(h)
//     takes one MUFU operation where exp2 and a reciprocal take two.  Pixels
//     outside the image are zero AFTER the prologue, since silu(0*a+d) =
//     silu(d) != 0: TMA fills them with zeros and the prologue skips them.
//     The epilogue adds bias and residual in fp32, rounds once, and stores
//     16-byte vectors through a staging tile in shared memory.
//   - fp32 (conv3x3_f32, the check route, not on the main path): the first
//     design's tiling, 8x16 pixels x 128 channels, 16-channel chunks staged
//     by cp.async, the products by plain FMA, so the kernel can be held at
//     fp32 tolerance.
//
// Memory layout: x, residual and y are NHWC (the port's NCHW tensors in
// torch.channels_last), w is (Cout, 3, 3, Cin) (an OIHW weight in
// channels_last), a and d are (B, Cin) fp32, bias is (Cout) fp32.
// Any Cout works (output channels past Cout are masked); Cin must be a
// multiple of the chunk (64 for bf16, 16 for fp32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---- fp32: the check route ---------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

namespace f32 {
constexpr int TH = 8, TW = 16, BN = 128, BKC = 16, WARPS_M = 4, WARPS_N = 2;
constexpr int kThreads = WARPS_M * WARPS_N * 32;
constexpr int kLd = BKC + 4;  // row stride of window and weight rows (floats)
constexpr int kWinPix = (TH + 2) * (TW + 2);
constexpr size_t kWinBytes = size_t(kWinPix) * kLd * 4;
constexpr size_t kWBytes = size_t(9) * BN * kLd * 4;
constexpr size_t kSmem = kWinBytes + kWBytes;
}  // namespace f32

template <bool kAffine, bool kResidual>
__global__ void __launch_bounds__(f32::kThreads, 1) conv3x3_f32(const ConvParams p) {
  using namespace f32;
  constexpr int WWD = TW + 2;
  constexpr int VPR = BKC / 4;              // 16-byte vectors per chunk row
  constexpr int WM = TH * TW / WARPS_M;     // pixels per warp
  constexpr int WN = BN / WARPS_N;          // channels per warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + kWinBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp % WARPS_M;
  const int warp_n = warp / WARPS_M;

  // Blocks that share a pixel tile are adjacent, so its window stays in L2.
  const int co_t = blockIdx.x % p.co_tiles;
  const int tile = blockIdx.x / p.co_tiles;
  const int tx0 = (tile % p.tiles_x) * TW;
  const int ty0 = ((tile / p.tiles_x) % p.tiles_y) * TH;
  const int b = tile / (p.tiles_x * p.tiles_y);
  const int co0 = co_t * BN;

  const float* xg = static_cast<const float*>(p.x) + (long long)b * p.H * p.W * p.Cin;
  const float* wg = static_cast<const float*>(p.w);

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
      const float* src = wg + ((long long)co * 9 + tap) * p.Cin + c0 + v * 4;
      cp_async16(Ws + (tap * BN + n) * kLd + v * 4, valid ? src : wg, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // halo window of this chunk, prologue applied as it lands
    for (int i = tid; i < kWinPix * VPR; i += kThreads) {
      const int pix = i / VPR;
      const int v = i % VPR;
      const int y = ty0 + pix / WWD - 1;
      const int x = tx0 + pix % WWD - 1;
      const int c = c0 + v * 4;
      float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
        raw = *reinterpret_cast<const float4*>(xg + ((long long)y * p.W + x) * p.Cin + c);
        if constexpr (kAffine) {
          float* e = reinterpret_cast<float*>(&raw);
          const float* ab = p.a + (long long)b * p.Cin + c;
          const float* db = p.d + (long long)b * p.Cin + c;
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = silu(e[j] * ab[j] + db[j]);
        }
      }
      *reinterpret_cast<float4*>(Xs + pix * kLd + v * 4) = raw;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* Wt = Ws + tap * BN * kLd;
      for (int k = 0; k < BKC; ++k) {
        float xa[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ty = warp_m * MT + mt;
          xa[mt][0] = Xs[((ty + dy) * WWD + g + dx) * kLd + k];
          xa[mt][1] = Xs[((ty + dy) * WWD + g + 8 + dx) * kLd + k];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = warp_n * WN + nt * 8 + tig * 2;
          const float w0 = Wt[n * kLd + k], w1 = Wt[(n + 1) * kLd + k];
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

  // ---- epilogue: bias, residual, masked store ----
  float* yg = static_cast<float*>(p.y);
  const float* rg = static_cast<const float*>(p.res);
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
            if constexpr (kResidual) v[e] += rg[pix * p.Cout + ne];
          }
        }
        if (pairs && n + 1 < p.Cout) {
          *reinterpret_cast<float2*>(yg + pix * p.Cout + n) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < p.Cout) yg[pix * p.Cout + n + e] = v[e];
        }
      }
    }
  }
}

// ---- bf16 on Hopper: TMA, wgmma, warp specialisation ----------------------

namespace h90 {
constexpr int TH = 4, TW = 64, BN = 128, BKC = 64;  // 4 image rows x 64 px x 128 Cout
constexpr int kWinCols = TW + 2, kWinPix = (TH + 2) * kWinCols;  // 6 x 66 halo window
// one 64-channel chunk of a window: 396 pixel rows of 128 B (128-byte
// swizzle), to a multiple of 1024 B
constexpr int kWinBytes = (kWinPix * 128 + 1023) / 1024 * 1024;
constexpr int kWinStages = 3;
constexpr int kWBytes = BN * 128;  // one (chunk, tap) weight tile: 128 Cout x 64 Cin
constexpr int kWStages = 4;
constexpr int kOffW = kWinStages * kWinBytes;
constexpr int kOffBar = kOffW + kWStages * kWBytes;
constexpr int kBars = 3 * kWinStages + 2 * kWStages;
constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;  // + slack to align the base
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kStageLd = BN + 8;  // fp32 row stride of the epilogue's staging tile
constexpr int kStageBytes = 64 * kStageLd * 4;
static_assert(kOffW % 1024 == 0 && 2 * kStageBytes <= kOffW, "shared memory layout");
}  // namespace h90

struct Conv90Params {
  CUtensorMap tx;  // x as (Cin, W, H, B), box (64, 66, TH + 2, 1), 128-byte swizzle
  CUtensorMap tw;  // w as (Cin, 9, Cout), box (64, 1, BN), 128-byte swizzle
  const float* bias;
  const float* a;
  const float* d;
  const void* res;
  void* y;
  int B, H, W, Cin, Cout;
  int tiles_x, tiles_y, co_tiles;
};

// silu(v) = v * sigmoid(v) = h + h * tanh(h), h = v / 2: one MUFU operation
// (tanh.approx, relative error 2^-11) where exp2 and a reciprocal take two.
__device__ __forceinline__ float silu_fast(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// GN affine + SiLU on 8 bf16 channels in place.
__device__ __forceinline__ void affine_silu8(uint4& raw, const float (&av)[8],
                                             const float (&dv)[8]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
    w[i] = sm90::pack_bf16(silu_fast(fmaf(f.x, av[2 * i], dv[2 * i])),
                           silu_fast(fmaf(f.y, av[2 * i + 1], dv[2 * i + 1])));
  }
}

// One block: a TH x 64 pixel tile for BN output channels, an implicit GEMM
// with M = pixels, N = Cout, K = 9 * Cin, iterated as (64-channel chunk, tap).
// Warpgroup 2 produces: its warp 0 streams the (chunk, tap) weight tiles by
// TMA through a kWStages ring; warps 1-3 load each chunk's (TH+2) x 66 halo
// window with one TMA copy (a 128-byte row of 64 channels per pixel, 128-byte
// swizzle; pixels outside the image arrive as zeros), apply the prologue once
// per element in place (outside pixels stay zero), and hand the window over.
// Warpgroups 0 and 1 consume: each owns two image rows (two m64 tiles) and
// runs the nine taps of a chunk from the one window; a tap's shift moves the
// A tile's start by whole 128-byte pixel rows (the swizzle follows the
// address, so any row may start it), and A reaches wgmma straight from shared
// memory by descriptor.
template <bool kAffine, bool kResidual>
__global__ void __launch_bounds__(h90::kThreads, 1)
    conv3x3_sm90(const __grid_constant__ Conv90Params p) {
  using namespace h90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* win_tma = bars;                     // the window's copy landed
  uint64_t* win_ready = bars + kWinStages;      // ... and its prologue is applied
  uint64_t* win_empty = bars + 2 * kWinStages;  // the consumers are done with it
  uint64_t* w_full = bars + 3 * kWinStages;
  uint64_t* w_empty = w_full + kWStages;

  const int co_t = blockIdx.x % p.co_tiles;
  const int tile = blockIdx.x / p.co_tiles;
  const int x0 = (tile % p.tiles_x) * TW;
  const int y0 = ((tile / p.tiles_x) % p.tiles_y) * TH;
  const int b = tile / (p.tiles_x * p.tiles_y);
  const int co0 = co_t * BN;
  const int nchunks = p.Cin / BKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWinStages; ++s) {
      sm90::mbar_init(win_tma + s, 1);
      sm90::mbar_init(win_ready + s, 96);
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
      for (int i = 0; i < nchunks * 9; ++i) {
        const int st = i % kWStages;
        sm90::mbar_wait(w_empty + st, ((i / kWStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(w_full + st, kWBytes);
        sm90::tma_load_3d(smem + kOffW + st * kWBytes, &p.tw, w_full + st, (i / 9) * BKC, i % 9,
                          co0);
      }
    } else if (pt >= 32) {
      // 12 threads per 8-channel group, each with the group's a and d in
      // registers, a stride of 12 pixels through the window
      const int t = pt - 32, grp = t / 12, t12 = t % 12;
      for (int c = 0; c < nchunks; ++c) {
        const int ws = c % kWinStages;
        const uint32_t ph = (c / kWinStages) & 1;
        unsigned char* win = smem + ws * kWinBytes;
        sm90::mbar_wait(win_empty + ws, ph ^ 1);
        if (t == 0) {
          sm90::mbar_arrive_expect_tx(win_tma + ws, kWinPix * 128);
          sm90::tma_load_4d(win, &p.tx, win_tma + ws, c * BKC, x0 - 1, y0 - 1, b);
        }
        sm90::mbar_wait(win_tma + ws, ph);
        if constexpr (kAffine) {
          const long long ch = (long long)b * p.Cin + c * BKC + grp * 8;
          float av[8], dv[8];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float4 a4 = __ldg(reinterpret_cast<const float4*>(p.a + ch) + q);
            const float4 d4 = __ldg(reinterpret_cast<const float4*>(p.d + ch) + q);
            av[4 * q] = a4.x, av[4 * q + 1] = a4.y, av[4 * q + 2] = a4.z, av[4 * q + 3] = a4.w;
            dv[4 * q] = d4.x, dv[4 * q + 1] = d4.y, dv[4 * q + 2] = d4.z, dv[4 * q + 3] = d4.w;
          }
#pragma unroll 2
          for (int pix = t12; pix < kWinPix; pix += 12) {
            const int y = y0 - 1 + pix / kWinCols, x = x0 - 1 + pix % kWinCols;
            if (y < 0 || y >= p.H || x < 0 || x >= p.W) continue;  // zero after the prologue
            uint4* e = reinterpret_cast<uint4*>(win + pix * 128 + ((grp ^ (pix & 7)) << 4));
            uint4 raw = *e;
            affine_silu8(raw, av, dv);
            *e = raw;
          }
          sm90::fence_proxy_async();  // the generic writes, before wgmma reads them
        }
        sm90::mbar_arrive(win_ready + ws);
      }
    }
  } else {
    sm90::setmaxnreg_inc<224>();
    const int wg = threadIdx.x >> 7;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
    const uint32_t win0 = sm90::smem_u32(smem);
    const uint32_t w0 = sm90::smem_u32(smem + kOffW);

    float acc[2][64];  // written first by the block's first product (accumulate = 0)

    for (int c = 0; c < nchunks; ++c) {
      const int ws = c % kWinStages;
      sm90::mbar_wait(win_ready + ws, (c / kWinStages) & 1);
      const uint32_t win = win0 + ws * kWinBytes;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int i = c * 9 + tap, st = i % kWStages;
        const int dy = tap / 3, dx = tap % 3;
        const uint32_t wt = w0 + st * kWBytes;
        sm90::mbar_wait(w_full + st, (i / kWStages) & 1);
        // window pixel of this warpgroup's first row at this tap
        const int pix0 = (wg * 2 + dy) * kWinCols + dx;
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BKC / 16; ++ks) {
          const uint64_t db = sm90::desc_kmajor_sw128(wt + ks * 32);
#pragma unroll
          for (int mr = 0; mr < 2; ++mr) {
            const uint32_t aa = win + (pix0 + mr * kWinCols) * 128 + ks * 32;
            sm90::wgmma_ss_m64n128(acc[mr], sm90::desc_kmajor_sw128(aa), db, (i | ks) != 0);
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous tap's products are done
        if (i > 0) {
          sm90::mbar_arrive(w_empty + (i - 1) % kWStages);
          if (tap == 0) sm90::mbar_arrive(win_empty + (c - 1) % kWinStages);
        }
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int mr = 0; mr < 2; ++mr) sm90::reg_fence(acc[mr]);

    // ---- epilogue: bias, residual, one rounding; staged through shared
    // memory (the windows are free now) for 16-byte coalesced stores ----
    sm90::named_bar_sync(1, 256);
    float* stage = reinterpret_cast<float*>(smem + wg * kStageBytes);
    const __nv_bfloat16* resg = static_cast<const __nv_bfloat16*>(p.res);
    __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y);
    const bool vec = (p.Cout & 7) == 0;
#pragma unroll
    for (int mr = 0; mr < 2; ++mr) {
      const int r = warp * 16 + g;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int cc = jj * 8 + tig * 2;
        *reinterpret_cast<float2*>(stage + r * kStageLd + cc) =
            make_float2(acc[mr][4 * jj + 0], acc[mr][4 * jj + 1]);
        *reinterpret_cast<float2*>(stage + (r + 8) * kStageLd + cc) =
            make_float2(acc[mr][4 * jj + 2], acc[mr][4 * jj + 3]);
      }
      sm90::named_bar_sync(2 + wg, 128);
      const int y = y0 + wg * 2 + mr;
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        const int px = k * 8 + tw / 16, cc = (tw % 16) * 8;
        const int x = x0 + px, co = co0 + cc;
        if (y >= p.H || x >= p.W || co >= p.Cout) continue;
        const float4 s0 = *reinterpret_cast<const float4*>(stage + px * kStageLd + cc);
        const float4 s1 = *reinterpret_cast<const float4*>(stage + px * kStageLd + cc + 4);
        float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const long long pix = ((long long)b * p.H + y) * p.W + x;
        if (vec && co + 8 <= p.Cout) {
          if (p.bias) {
            const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.bias + co));
            const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.bias + co) + 1);
            v[0] += b0.x, v[1] += b0.y, v[2] += b0.z, v[3] += b0.w;
            v[4] += b1.x, v[5] += b1.y, v[6] += b1.z, v[7] += b1.w;
          }
          if constexpr (kResidual) {
            const uint4 rr = *reinterpret_cast<const uint4*>(resg + pix * p.Cout + co);
            const uint32_t* rw = reinterpret_cast<const uint32_t*>(&rr);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[q]));
              v[2 * q] += f.x;
              v[2 * q + 1] += f.y;
            }
          }
          uint4 out;
          uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int q = 0; q < 4; ++q) ow[q] = sm90::pack_bf16(v[2 * q], v[2 * q + 1]);
          *reinterpret_cast<uint4*>(yg + pix * p.Cout + co) = out;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (co + e >= p.Cout) break;
            float val = v[e];
            if (p.bias) val += p.bias[co + e];
            if constexpr (kResidual) val += __bfloat162float(resg[pix * p.Cout + co + e]);
            yg[pix * p.Cout + co + e] = __float2bfloat16_rn(val);
          }
        }
      }
      sm90::named_bar_sync(2 + wg, 128);  // the staging tile is free again
    }
  }
}

template <bool kAffine, bool kResidual>
cudaError_t launch_sm90(const ConvParams& c, cudaStream_t stream) {
  using namespace h90;
  Conv90Params p;
  const uint64_t cin = c.Cin, w = c.W, h = c.H;
  const uint64_t xdims[4] = {cin, w, h, uint64_t(c.B)};
  const uint64_t xstrides[3] = {cin * 2, w * cin * 2, h * w * cin * 2};
  const uint32_t xbox[4] = {BKC, kWinCols, TH + 2, 1};
  cudaError_t err =
      sm90::make_map_bf16(&p.tx, 4, c.x, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {cin, 9, uint64_t(c.Cout)};
  const uint64_t wstrides[2] = {cin * 2, 9 * cin * 2};
  const uint32_t wbox[3] = {BKC, 1, BN};
  err = sm90::make_map_bf16(&p.tw, 3, c.w, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  p.bias = c.bias;
  p.a = c.a;
  p.d = c.d;
  p.res = c.res;
  p.y = c.y;
  p.B = c.B, p.H = c.H, p.W = c.W, p.Cin = c.Cin, p.Cout = c.Cout;
  p.tiles_x = (c.W + TW - 1) / TW;
  p.tiles_y = (c.H + TH - 1) / TH;
  p.co_tiles = (c.Cout + BN - 1) / BN;
  auto kern = conv3x3_sm90<kAffine, kResidual>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x * p.co_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<dim3(unsigned(blocks)), kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_sm90(const ConvParams& p, cudaStream_t s) {
  const bool aff = p.a != nullptr, res = p.res != nullptr;
  if (aff && res) return launch_sm90<true, true>(p, s);
  if (aff) return launch_sm90<true, false>(p, s);
  if (res) return launch_sm90<false, true>(p, s);
  return launch_sm90<false, false>(p, s);
}

template <bool kAffine, bool kResidual>
cudaError_t launch_f32(const ConvParams& p, cudaStream_t stream) {
  auto kern = conv3x3_f32<kAffine, kResidual>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(f32::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x * p.co_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<dim3(unsigned(blocks)), f32::kThreads, f32::kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const ConvParams& p, cudaStream_t s) {
  const bool aff = p.a != nullptr, res = p.res != nullptr;
  if (aff && res) return launch_f32<true, true>(p, s);
  if (aff) return launch_f32<true, false>(p, s);
  if (res) return launch_f32<false, true>(p, s);
  return launch_f32<false, false>(p, s);
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
    if (Cin % h90::BKC) return int(cudaErrorInvalidValue);
    return int(dispatch_sm90(p, s));
  }
  if (dtype == 0) {
    if (Cin % f32::BKC) return int(cudaErrorInvalidValue);
    p.tiles_x = (W + f32::TW - 1) / f32::TW;
    p.tiles_y = (H + f32::TH - 1) / f32::TH;
    p.co_tiles = (Cout + f32::BN - 1) / f32::BN;
    return int(dispatch_f32(p, s));
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
