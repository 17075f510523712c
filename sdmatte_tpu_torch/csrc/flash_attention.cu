// Flash attention with an additive per-key bias, hand-written for Hopper (sm_90a).
//
//   out[b,h,q,:] = softmax_k(scale * q.k + bias[b,k]) @ v[b,h,:,:]
//
// Replaces the Pallas kernels of sdmatte_tpu/ops/flash_attention.py:
//   K1 (d <= 128): ::_kernel_fused_l and ::_kernel_d64_v2, the U-Net's d=64
//      self- and cross-attention;
//   K2 (d = 512):  ::_kernel, the VAE mid-block's single-head attention.
//
// What bounds it on the H100: operations.  At the main path's shapes
// (L = 256..16384 keys, d = 64 or 512) the kernel does 4*L*d flops per query
// row and reads each K/V byte once per query tile, far above the card's ~295
// flop/byte ridge.  So the (Lq, Lk) score matrix never leaves the chip
// (online softmax, fp32 running max and sum in registers).
//
// K1 in bf16 (flash_fwd_sm90, the main path) is built for Hopper, FA3-style.
// At d = 64 each score costs 256 tensor flops and one exp2, and the SM's
// MUFU unit does 16 exp2 per clock, about the rate at which the tensor cores
// produce scores (~16 per clock at 989 TFLOP/s); the fp32 pipe adds ~5
// operations per score.  So no unit may wait for another:
//   - a CTA holds 128 query rows: two consumer warpgroups of 64 rows on
//     wgmma (S = QK^T m64n128k16 from shared memory; O += PV m64n64k16 with P
//     from registers, the S accumulator converted in place, and V read
//     MN-major) and one producer warp that keeps TMA loads of Q and a 3-stage
//     ring of 128-key K/V tiles (128-byte swizzle, any (b, h, row) strides)
//     in flight, with the tile's bias, times log2(e), staged beside K;
//   - within a warpgroup, S of tile j+1 is issued before the softmax of tile
//     j (the softmax runs while the tensor cores work); across the two
//     warpgroups, named barriers alternate the issue of the products, so one
//     warpgroup's exp2 runs under the other's wgmma;
//   - the softmax is one FFMA (scale*log2(e) and the staged bias folded),
//     ex2.approx, and fp32 running max and sum.  Keys past Lk carry
//     MASK_VALUE as their staged bias, unscaled in the log2 domain, against a
//     K row that TMA zero-filled, so they score exactly MASK_VALUE; the bias
//     is added, never turned into -inf, so a row whose keys all carry -10000
//     still gives the softmax of its scores.  Query rows past Lq are computed
//     on zeros and not stored.
//   Measured at the 16384-key shapes (PERF.md): 38-47% of the tensor and
//   MUFU bounds, which are equal there.  The softmax side (MUFU and fp32
//   issue) binds, not the tensor cores: the unbiased path, one fp32
//   operation per score fewer, runs the same shapes 11-19% faster.
//   At d = 128 (off the main path) S, P and O of a 128-key tile do not fit
//   the consumers' registers together, so each tile runs as two 64-key
//   halves, QK, softmax and PV in turn (the two warpgroups still overlap
//   each other).
//
// K1's relative-position mode (flash_fwd_relpos_sm90, bf16, d = 64: ViTMatte's
// ViTDet blocks) adds a per-(query, key) bias made of two decomposed terms,
//   out = softmax_k(scale * q.k + Rh[q, row(k)] + Rw[q, col(k)]) @ v,
// with Rh (B*H, Lq, kh) and Rw (B*H, Lq, kw) bf16 given by the caller (two
// small GEMMs on the unscaled q) and the keys row-major on a kh x kw grid.
// The (Lq, Lk) bias is never formed: at a 12 MP photo's 47,880 tokens it
// would be 110 GB a block in fp32.  What bounds the mode is what bounds the
// per-key path, its softmax side (MUFU exp2 and fp32 issue); a first design
// added the terms inside the softmax, a walk over the tile's keys on the grid
// and two shared-memory lookups and an add a score, about four issue slots
// over the per-key path's five, and ran at 22.5% of the bound against the
// per-key path's 41%.  So the terms cost the softmax nothing here:
//   - a key tile is 2-D: 8 grid rows x 16 grid columns, cut by one 5-D TMA
//     map of K (and one of V), (d, column, row, head, batch) with box
//     (64, 16, 8, 1, 1), which lands as the per-key path's 128 x 64
//     swizzled tile, key t = 16 r + c; TMA zero-fills the slots past the grid
//     (190 x 252 pads to 192 x 256, +2.7%; a 14 x 14 window to 16 x 16, the
//     two tiles it took before).  Row blocks outside, column blocks inside;
//   - within a tile a query row meets 16 Rw and 8 Rh values, so the bias is a
//     product: S = [Q | A] [K | B]^T, the QK wgmma two k16 steps deeper.  B
//     is a constant 128 x 32 one-hot (key t: 1 / scale at lanes c and
//     16 + r; 1/8 at d = 64, exact in bf16), staged once a CTA in the K
//     tile's layout; A is the tile's [Rw | Rh] for the thread's query rows,
//     from registers (RS): TMA brings three 8-term x 128-row boxes a tile
//     (Rw's two halves, Rh) in the K/V ring, on the K tile's barrier, and
//     each thread reads its six words of them.  So S = q.k + (Rw + Rh) /
//     scale exactly (bf16 products of 1 / scale, fp32 sums);
//   - on a tile ragged at the grid's edge (the last column and row blocks;
//     every window) a lane past the grid carries -2^100 in A, finite (-inf
//     times the one-hot's zeros would give NaN), a select on six registers a
//     tile; those keys score at most -2^103 and weigh 0;
//   - the softmax is then the per-key path's unbiased one: one FFMA, ex2,
//     max and sum a score, no key walk, no lookups, no per-tile mask.  The
//     tensor cores do 25% more (QK depth 64 -> 96, PV unchanged), which the
//     softmax side's bound leaves room for;
//   - the terms need 16-byte row strides for TMA: ops/attention.relpos_terms
//     writes them so; the wrapper copies terms that are not;
//   - any grid goes in as it is: the masks above cover a grid narrower or
//     shorter than one tile (a box's slots past the grid, even all of them,
//     come zero-filled), at the cost of the padding.
//
// K2 in bf16 (flash_fwd_d512_sm90, the main path) is built for Hopper as well,
// around what d = 512 forces.  It is bound by the tensor cores alone (2048
// flops per score against one exp2), but O for 64 query rows is 64 x 512 fp32,
// half of the SM's registers, so a CTA holds 64 rows and d is split over its
// two warpgroups: each keeps O[:, 256 columns] (128 registers a thread).  S
// needs all of d, so each warpgroup scores half of the 64-key tile over the
// full d (wgmma m64n32k16, Q and K from swizzled shared memory), the row
// maxima cross shared memory, P is written once as bf16 into a swizzled
// K-major tile (fence.proxy.async before the async proxy reads it), and each
// warpgroup runs O_half += P V[:, half] (m64n256k16, A = P from shared memory,
// V MN-major).  Q, one K tile and one V tile are 64 KB each, so K and V are
// single-buffered and staggered: K of tile j+1 is asked for when QK of tile j
// is done and lands under its softmax and PV, V of tile j+1 when PV of tile j
// is done and lands under QK and the softmax of tile j+1.  There is no
// producer warp: registers go to a block in units of four warps, so a ninth
// warp would leave each thread 168 registers, not the ~190 the consumers
// need; thread 0 issues the TMA loads.  O is rescaled only when a row's
// maximum moved (it rarely does after the first tiles).  The softmax is
// K1's: log2 domain, MASK_VALUE unscaled for keys past Lk against a
// zero-filled K row; without a bias the maximum is taken on the raw scores.
// Measured on an H100 (PERF.md): the L2 does not bind (a cluster of two CTAs
// sharing each K/V tile by TMA multicast ran within 5% of this kernel); the
// serial order QK, softmax, PV inside a tile does.
//
// K2 in fp32 and K1 in fp32 (the check route, not on the main path) use what
// is left of the first design, flash_fwd: plain FMA on the mma.sync fragment
// layout and a cp.async ring, so that a kernel can be held at fp32 tolerance;
// one block per (query tile, batch*head), each warp owns 16 query rows, and
// at d = 512 two warps share a row group: each scores half of the KV tile,
// the row max and P are exchanged through shared memory, and each accumulates
// half of d.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // ops/flash_attention.py MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Lk) fp32 with row stride bias_sb, or nullptr
  void* o;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long bias_sb;
  int H, Lq, Lk;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [row0, row0 + ROWS) of a (rows, D) tile with row stride sl into
// shared memory with row stride LDS; rows at or past nrows are zero-filled.
template <typename T, int ROWS, int D, int LDS, int NTHREADS>
__device__ __forceinline__ void load_rows(T* s, const T* g, long long sl, int row0, int nrows,
                                          int tid) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = D / EPV;
  for (int i = tid; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * EPV;
    const int gr = row0 + r;
    const bool valid = gr < nrows;
    cp_async16(s + r * LDS + c, valid ? g + gr * sl + c : g, valid);
  }
}

template <typename T, int D, int BQ, int BK, int KSPLIT, int STAGES>
struct FlashShape {
  static constexpr int kWarps = (BQ / 16) * KSPLIT;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLds = D + kPad;     // Q/K/V row stride (elements)
  static constexpr int kLdp = BK + kPad;    // P row stride (elements)
  static constexpr size_t kQBytes = size_t(BQ) * kLds * sizeof(T);
  static constexpr size_t kKVBytes = size_t(STAGES) * BK * kLds * sizeof(T);
  static constexpr size_t kPBytes = size_t(BQ) * kLdp * sizeof(T);
  static constexpr size_t kRedBytes = KSPLIT > 1 ? size_t(2) * KSPLIT * BQ * sizeof(float) : 0;
  static constexpr size_t kSmem = kQBytes + 2 * kKVBytes + kPBytes + kRedBytes;
};

template <typename T, int D, int BQ, int BK, int KSPLIT, int STAGES>
__global__ void __launch_bounds__(FlashShape<T, D, BQ, BK, KSPLIT, STAGES>::kThreads)
    flash_fwd(const AttnParams p) {
  using S = FlashShape<T, D, BQ, BK, KSPLIT, STAGES>;
  constexpr int kThreads = S::kThreads;
  constexpr int kLds = S::kLds;
  constexpr int kLdp = S::kLdp;
  constexpr int kRowGroups = BQ / 16;
  constexpr int BKW = BK / KSPLIT;  // keys scored by one warp per tile
  constexpr int DW = D / KSPLIT;    // output columns accumulated by one warp
  constexpr int NT_S = BKW / 8;
  constexpr int NT_O = DW / 8;
  static_assert(BQ % 16 == 0 && BKW % 16 == 0 && DW % 16 == 0 && D % 16 == 0, "tile shape");
  static_assert(STAGES == 1 || STAGES == 2, "stages");

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + S::kQBytes);
  T* Vs = reinterpret_cast<T*>(smem + S::kQBytes + S::kKVBytes);
  T* Ps = reinterpret_cast<T*>(smem + S::kQBytes + 2 * S::kKVBytes);
  float* red_max = reinterpret_cast<float*>(smem + S::kQBytes + 2 * S::kKVBytes + S::kPBytes);
  float* red_sum = red_max + KSPLIT * BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row within the 8-row half
  const int tig = lane & 3;  // fragment column pair
  const int rg = warp % kRowGroups;
  const int kh = warp / kRowGroups;
  const int r_lo = rg * 16 + g;
  const int r_hi = r_lo + 8;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* biasg = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const int Lk = p.Lk;
  const int nk = (Lk + BK - 1) / BK;

  load_rows<T, BQ, D, kLds, kThreads>(Qs, qg, p.q_sl, q0, p.Lq, tid);
  load_rows<T, BK, D, kLds, kThreads>(Ks, kg, p.k_sl, 0, Lk, tid);
  load_rows<T, BK, D, kLds, kThreads>(Vs, vg, p.v_sl, 0, Lk, tid);
  cp_async_commit();

  float o[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int st = (STAGES == 2) ? (t & 1) : 0;
    if constexpr (STAGES == 2) {
      if (t + 1 < nk) {
        const int nst = (t + 1) & 1;
        load_rows<T, BK, D, kLds, kThreads>(Ks + nst * BK * kLds, kg, p.k_sl, (t + 1) * BK, Lk, tid);
        load_rows<T, BK, D, kLds, kThreads>(Vs + nst * BK * kLds, vg, p.v_sl, (t + 1) * BK, Lk, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (t > 0) {
        load_rows<T, BK, D, kLds, kThreads>(Ks, kg, p.k_sl, t * BK, Lk, tid);
        load_rows<T, BK, D, kLds, kThreads>(Vs, vg, p.v_sl, t * BK, Lk, tid);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * kLds;
    const T* Vt = Vs + st * BK * kLds;

    // ---- S = Q K^T for this warp's 16 rows x BKW keys ----
    float s[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const T* qa = Qs + r_lo * kLds;
    const T* qb = Qs + r_hi * kLds;
    for (int d = 0; d < D; ++d) {
      const float xa = qa[d], xb = qb[d];
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const int key = kh * BKW + nt * 8 + tig * 2;
        const float k0 = Kt[key * kLds + d], k1 = Kt[(key + 1) * kLds + d];
        s[nt][0] += xa * k0;
        s[nt][1] += xa * k1;
        s[nt][2] += xb * k0;
        s[nt][3] += xb * k1;
      }
    }

    // ---- scale, bias, ragged-key mask (fp32) ----
    const int kbase = t * BK + kh * BKW;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kbase + nt * 8 + tig * 2 + e;
        const float bv = (key < Lk) ? (biasg ? biasg[key] : 0.f) : 0.f;
        s[nt][e] = (key < Lk) ? s[nt][e] * p.scale + bv : kMaskValue;
        s[nt][e + 2] = (key < Lk) ? s[nt][e + 2] * p.scale + bv : kMaskValue;
      }
    }

    // ---- online softmax ----
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    if constexpr (KSPLIT > 1) {
      if (tig == 0) {
        red_max[kh * BQ + r_lo] = mx_lo;
        red_max[kh * BQ + r_hi] = mx_hi;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < KSPLIT; ++j) {
        mx_lo = fmaxf(mx_lo, red_max[j * BQ + r_lo]);
        mx_hi = fmaxf(mx_hi, red_max[j * BQ + r_hi]);
      }
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float alpha_lo = exp2f((m_lo - mn_lo) * kLog2e);
    const float alpha_hi = exp2f((m_hi - mn_hi) * kLog2e);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = exp2f((s[nt][0] - m_lo) * kLog2e);
      s[nt][1] = exp2f((s[nt][1] - m_lo) * kLog2e);
      s[nt][2] = exp2f((s[nt][2] - m_hi) * kLog2e);
      s[nt][3] = exp2f((s[nt][3] - m_hi) * kLog2e);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;  // per-thread partial; reduced after the loop
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      o[nt][0] *= alpha_lo;
      o[nt][1] *= alpha_lo;
      o[nt][2] *= alpha_hi;
      o[nt][3] *= alpha_hi;
    }

    // ---- O += P V ----
    // P is exchanged through shared memory (the two warps of a row group
    // each scored half of the tile) and read back by plain loads.
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      const int c = kh * BKW + nt * 8 + tig * 2;
      Ps[r_lo * kLdp + c] = s[nt][0];
      Ps[r_lo * kLdp + c + 1] = s[nt][1];
      Ps[r_hi * kLdp + c] = s[nt][2];
      Ps[r_hi * kLdp + c + 1] = s[nt][3];
    }
    __syncthreads();
    for (int key = 0; key < BK; ++key) {
      const float pa = Ps[r_lo * kLdp + key];
      const float pb = Ps[r_hi * kLdp + key];
      const T* vrow = Vt + key * kLds + kh * DW;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const float v0 = vrow[nt * 8 + tig * 2], v1 = vrow[nt * 8 + tig * 2 + 1];
        o[nt][0] += pa * v0;
        o[nt][1] += pa * v1;
        o[nt][2] += pb * v0;
        o[nt][3] += pb * v1;
      }
    }
    __syncthreads();  // the next iteration refills this stage and Ps
  }

  // ---- normalise and store ----
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  if constexpr (KSPLIT > 1) {
    if (tig == 0) {
      red_sum[kh * BQ + r_lo] = l_lo;
      red_sum[kh * BQ + r_hi] = l_hi;
    }
    __syncthreads();
    l_lo = 0.f;
    l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KSPLIT; ++j) {
      l_lo += red_sum[j * BQ + r_lo];
      l_hi += red_sum[j * BQ + r_hi];
    }
  }
  const float inv_lo = l_lo == 0.f ? 1.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 1.f : 1.f / l_hi;
  const int row_lo = q0 + r_lo;
  const int row_hi = q0 + r_hi;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int c = kh * DW + nt * 8 + tig * 2;
    if (row_lo < p.Lq)
      *reinterpret_cast<float2*>(og + row_lo * p.o_sl + c) =
          make_float2(o[nt][0] * inv_lo, o[nt][1] * inv_lo);
    if (row_hi < p.Lq)
      *reinterpret_cast<float2*>(og + row_hi * p.o_sl + c) =
          make_float2(o[nt][2] * inv_hi, o[nt][3] * inv_hi);
  }
}

// ---- K1 on Hopper: TMA, wgmma, warp specialisation (bf16, d = 64 or 128) ----

template <int D, int STAGES>
struct Fa3 {
  static constexpr int kBQ = 128, kBK = 128, kPanels = D / 64;
  static constexpr int kPanelBytes = 128 * 128;  // 128 rows of 64 bf16
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
  static constexpr int kOffK = kTileBytes;  // after Q
  static constexpr int kOffV = kOffK + STAGES * kTileBytes;
  static constexpr int kOffBias = kOffV + STAGES * kTileBytes;
  static constexpr int kOffBar = kOffBias + STAGES * kBK * 4;
  static constexpr int kBars = 1 + 3 * STAGES;
  // setmaxnreg: the producer warpgroup gives its registers to the consumers
  // (384 threads x 168 at launch = 128 x kProducerRegs + 256 x kConsumerRegs)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;  // + slack to align the base
  static_assert(D == 64 || D == 128, "head dim");
};

struct Fa3Params {
  CUtensorMap tq, tk, tv;  // 4-D (d, then the three outer dims by stride)
  int oq[3], ok[3], ov[3];  // logical dim of map dims 1..3: 0 row, 1 head, 2 batch
  const float* bias;
  long long bias_sb;
  void* o;
  long long o_sb, o_sh, o_sl;
  int H, Lq, Lk;
  float scale_log2;  // scale * log2(e)
  int panels;        // K2: 64-column panels of d (a runtime value on purpose, see its QK loop)
};

__device__ __forceinline__ int pick(int which, int row, int h, int b) {
  return which == 0 ? row : (which == 1 ? h : b);
}
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, const int (&ord)[3],
                                         uint64_t* bar, int d0, int row, int h, int b) {
  sm90::tma_load_4d(dst, map, bar, d0, pick(ord[0], row, h, b), pick(ord[1], row, h, b),
                    pick(ord[2], row, h, b));
}

// S (64 rows x N keys) = Q K^T, both K-major with the 128-byte swizzle.
template <int D, int N>
__device__ __forceinline__ void fa3_qk(float (&s)[N / 2], uint32_t q_base, uint32_t k_base) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * 16384 + (kk % 4) * 32;
    const uint64_t da = sm90::desc_kmajor_sw128(q_base + off);
    const uint64_t db = sm90::desc_kmajor_sw128(k_base + off);
    if constexpr (N == 128)
      sm90::wgmma_ss_m64n128(s, da, db, kk > 0);
    else
      sm90::wgmma_ss_m64n64(s, da, db, kk > 0);
  }
  sm90::wgmma_commit();
}

// O (64 rows x D) += P V: P from registers, V (N keys x D) MN-major.
template <int D, int N>
__device__ __forceinline__ void fa3_pv(float (&o)[D / 2], const uint32_t (&pa)[N / 16][4],
                                       uint32_t v_base) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db = sm90::desc_mnmajor_sw128(v_base + kk * 2048, 16384);
    if constexpr (D == 64)
      sm90::wgmma_rs_m64n64<1>(o, pa[kk], db, 1);
    else
      sm90::wgmma_rs_m64n128<1>(o, pa[kk], db, 1);
  }
  sm90::wgmma_commit();
}

// One tile's online softmax in the log2 domain, in place on the S fragment;
// returns the rescale factors of the old sums.
//   kBias: t = s * scale*log2(e) + bias*log2(e) (one FFMA; keys past Lk carry
//     MASK_VALUE as their staged bias and a zero K row, so t is exactly
//     MASK_VALUE), p = 2^(t - m).
//   no bias (scale > 0): the max is taken on the raw scores and p =
//     2^(s * scale*log2(e) - m) is one FFMA; keys past Lk (valid < 128 on the
//     last tile) are set to -inf, so p = 0 for them as for MASK_VALUE.
template <bool kBias, int N>
__device__ __forceinline__ void fa3_softmax(float (&s)[N / 2], const float* bias, float sl2, int tig,
                                            int valid, float& m_lo, float& m_hi, float& l_lo,
                                            float& l_hi, float& a_lo, float& a_hi) {
  float mx_lo, mx_hi;
  if constexpr (kBias) {
    mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + jj * 8 + tig * 2);
      s[4 * jj + 0] = fmaf(s[4 * jj + 0], sl2, bv.x);
      s[4 * jj + 1] = fmaf(s[4 * jj + 1], sl2, bv.y);
      s[4 * jj + 2] = fmaf(s[4 * jj + 2], sl2, bv.x);
      s[4 * jj + 3] = fmaf(s[4 * jj + 3], sl2, bv.y);
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * jj + 0], s[4 * jj + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
  } else {
    if (valid < N) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        if ((i / 4) * 8 + tig * 2 + (i & 1) >= valid) s[i] = -INFINITY;
    }
    mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * jj + 0], s[4 * jj + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  if constexpr (!kBias) {
    mx_lo = fmaxf(m_lo, mx_lo * sl2);
    mx_hi = fmaxf(m_hi, mx_hi * sl2);
  }
  a_lo = sm90::ex2(m_lo - mx_lo);  // m = -inf before the first tile: 2^-inf = 0
  a_hi = sm90::ex2(m_hi - mx_hi);
  m_lo = mx_lo;
  m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
  if constexpr (kBias) {
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      s[4 * jj + 0] = sm90::ex2(s[4 * jj + 0] - mx_lo);
      s[4 * jj + 1] = sm90::ex2(s[4 * jj + 1] - mx_lo);
      s[4 * jj + 2] = sm90::ex2(s[4 * jj + 2] - mx_hi);
      s[4 * jj + 3] = sm90::ex2(s[4 * jj + 3] - mx_hi);
      sum_lo += s[4 * jj + 0] + s[4 * jj + 1];
      sum_hi += s[4 * jj + 2] + s[4 * jj + 3];
    }
  } else {
    const float nm_lo = -mx_lo, nm_hi = -mx_hi;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      s[4 * jj + 0] = sm90::ex2(fmaf(s[4 * jj + 0], sl2, nm_lo));
      s[4 * jj + 1] = sm90::ex2(fmaf(s[4 * jj + 1], sl2, nm_lo));
      s[4 * jj + 2] = sm90::ex2(fmaf(s[4 * jj + 2], sl2, nm_hi));
      s[4 * jj + 3] = sm90::ex2(fmaf(s[4 * jj + 3], sl2, nm_hi));
      sum_lo += s[4 * jj + 0] + s[4 * jj + 1];
      sum_hi += s[4 * jj + 2] + s[4 * jj + 3];
    }
  }
  l_lo = l_lo * a_lo + sum_lo;  // per-thread partial; reduced after the loop
  l_hi = l_hi * a_hi + sum_hi;
}

// P (fp32 S fragment) -> bf16 A fragments of the PV product, one per 16 keys.
template <int N>
__device__ __forceinline__ void fa3_pack(const float (&s)[N / 2], uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = sm90::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = sm90::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = sm90::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = sm90::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, int STAGES, bool kBias>
__global__ void __launch_bounds__(384, 1) flash_fwd_sm90(const __grid_constant__ Fa3Params p) {
  using S = Fa3<D, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* bias_s = reinterpret_cast<float*>(smem + S::kOffBias);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kOffBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;  // K tile and its bias
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* kv_empty = bars + 1 + 2 * STAGES;

  const int q0 = blockIdx.x * S::kBQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int nk = (p.Lk + S::kBK - 1) / S::kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(k_full + s, 32);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(kv_empty + s, 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one warp keeps the TMA loads in flight ----
    sm90::setmaxnreg_dec<S::kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(q_full, S::kTileBytes);
        for (int pn = 0; pn < S::kPanels; ++pn)
          tma_rows(smem + pn * S::kPanelBytes, &p.tq, p.oq, q_full, pn * 64, q0, h, b);
      }
      const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        sm90::mbar_wait(kv_empty + st, ((j / STAGES) & 1) ^ 1);
        if constexpr (kBias) {
          float* bs = bias_s + st * S::kBK;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * S::kBK + lane * 4 + e;
            bs[lane * 4 + e] = key < p.Lk ? (bias_g ? bias_g[key] * kLog2e : 0.f) : kMaskValue;
          }
        }
        if (lane == 0) {
          unsigned char* kt = smem + S::kOffK + st * S::kTileBytes;
          unsigned char* vt = smem + S::kOffV + st * S::kTileBytes;
          sm90::mbar_arrive_expect_tx(k_full + st, S::kTileBytes);
          for (int pn = 0; pn < S::kPanels; ++pn)
            tma_rows(kt + pn * S::kPanelBytes, &p.tk, p.ok, k_full + st, pn * 64, j * S::kBK, h, b);
          sm90::mbar_arrive_expect_tx(v_full + st, S::kTileBytes);
          for (int pn = 0; pn < S::kPanels; ++pn)
            tma_rows(vt + pn * S::kPanelBytes, &p.tv, p.ov, v_full + st, pn * 64, j * S::kBK, h, b);
        } else {
          sm90::mbar_arrive(k_full + st);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    sm90::setmaxnreg_inc<S::kConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
    const uint32_t q_base = sm90::smem_u32(smem) + wg * 64 * 128;
    const uint32_t k_base = sm90::smem_u32(smem + S::kOffK);
    const uint32_t v_base = sm90::smem_u32(smem + S::kOffV);
    // Ping-pong: a warpgroup issues its products only after the other one
    // has issued its own, so one warpgroup's softmax runs under the other's
    // products.  Barrier 1 + wg is this warpgroup's turn.
    const int bar_mine = 1 + wg, bar_other = 2 - wg;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, a_lo, a_hi;

    if (wg == 1) sm90::named_bar_arrive(1, 256);
    sm90::mbar_wait(q_full, 0);

    if constexpr (D == 64) {
      float s[64];
      uint32_t pa[8][4];
      sm90::named_bar_sync(bar_mine, 256);
      sm90::mbar_wait(k_full, 0);
      fa3_qk<D, 128>(s, q_base, k_base);
      sm90::named_bar_arrive(bar_other, 256);
      sm90::wgmma_wait<0>();
      sm90::reg_fence(s);
      fa3_softmax<kBias, 128>(s, bias_s, p.scale_log2, tig, p.Lk, m_lo, m_hi, l_lo, l_hi, a_lo,
                              a_hi);
      fa3_pack<128>(s, pa);

      for (int j = 1; j < nk; ++j) {
        const int st = j % STAGES, pst = (j - 1) % STAGES;
        sm90::named_bar_sync(bar_mine, 256);
        sm90::mbar_wait(k_full + st, (j / STAGES) & 1);
        fa3_qk<D, 128>(s, q_base, k_base + st * S::kTileBytes);  // S_j ...
        sm90::mbar_wait(v_full + pst, ((j - 1) / STAGES) & 1);
        fa3_pv<D, 128>(o, pa, v_base + pst * S::kTileBytes);  // ... and O += P_{j-1} V_{j-1}
        sm90::named_bar_arrive(bar_other, 256);
        sm90::wgmma_wait<1>();  // S_j is ready; the PV product still runs
        sm90::reg_fence(s);
        fa3_softmax<kBias, 128>(s, bias_s + st * S::kBK, p.scale_log2, tig, p.Lk - j * S::kBK,
                                m_lo, m_hi, l_lo, l_hi, a_lo, a_hi);
        sm90::wgmma_wait<0>();
        sm90::reg_fence(o);
        sm90::mbar_arrive(kv_empty + pst);
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          o[4 * jj + 0] *= a_lo;
          o[4 * jj + 1] *= a_lo;
          o[4 * jj + 2] *= a_hi;
          o[4 * jj + 3] *= a_hi;
        }
        fa3_pack<128>(s, pa);
      }
      const int lst = (nk - 1) % STAGES;
      sm90::named_bar_sync(bar_mine, 256);
      sm90::mbar_wait(v_full + lst, ((nk - 1) / STAGES) & 1);
      fa3_pv<D, 128>(o, pa, v_base + lst * S::kTileBytes);
      if (wg == 0) sm90::named_bar_arrive(bar_other, 256);  // warpgroup 1's last turn
      sm90::wgmma_wait<0>();
      sm90::reg_fence(o);
    } else {
      // d = 128: S, P and O of a 128-key tile do not fit 240 registers
      // together, so each tile runs as two 64-key halves, each QK, softmax,
      // PV in turn (the two warpgroups still alternate their products).
      float s[32];
      uint32_t pa[4][4];
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        sm90::mbar_wait(k_full + st, ph);
        sm90::mbar_wait(v_full + st, ph);
#pragma unroll 1
        for (int hf = 0; hf < 2; ++hf) {
          sm90::named_bar_sync(bar_mine, 256);
          fa3_qk<D, 64>(s, q_base, k_base + st * S::kTileBytes + hf * 8192);
          if (wg == 0 || j + 1 < nk || hf == 0) sm90::named_bar_arrive(bar_other, 256);
          sm90::wgmma_wait<0>();
          sm90::reg_fence(s);
          fa3_softmax<kBias, 64>(s, bias_s + st * S::kBK + hf * 64, p.scale_log2, tig,
                                 p.Lk - j * S::kBK - hf * 64, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi);
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            o[4 * jj + 0] *= a_lo;
            o[4 * jj + 1] *= a_lo;
            o[4 * jj + 2] *= a_hi;
            o[4 * jj + 3] *= a_hi;
          }
          fa3_pack<64>(s, pa);
          fa3_pv<D, 64>(o, pa, v_base + st * S::kTileBytes + hf * 8192);
          sm90::wgmma_wait<0>();
          sm90::reg_fence(o);
        }
        sm90::mbar_arrive(kv_empty + st);
      }
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = l_lo == 0.f ? 1.f : 1.f / l_lo;
    const float inv_hi = l_hi == 0.f ? 1.f : 1.f / l_hi;
    const int row_lo = q0 + wg * 64 + warp * 16 + g;
    const int row_hi = row_lo + 8;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = jj * 8 + tig * 2;
      if (row_lo < p.Lq)
        *reinterpret_cast<uint32_t*>(og + row_lo * p.o_sl + c) =
            sm90::pack_bf16(o[4 * jj + 0] * inv_lo, o[4 * jj + 1] * inv_lo);
      if (row_hi < p.Lq)
        *reinterpret_cast<uint32_t*>(og + row_hi * p.o_sl + c) =
            sm90::pack_bf16(o[4 * jj + 2] * inv_hi, o[4 * jj + 3] * inv_hi);
    }
  }
}

// ---- K1's relative-position mode: 2-D key tiles, the terms through QK (bf16, d = 64) ----

namespace rel {
constexpr int kBQ = 128, kBK = 128;
constexpr int kRows = 8, kCols = 16;   // a key tile: 8 grid rows x 16 grid columns, t = 16 r + c
constexpr int kStages = 3;
constexpr int kTileBytes = 128 * 128;  // 128 rows of 64 bf16: Q, a K or V tile, the one-hot B
constexpr int kTermBytes = 128 * 16;   // 128 query rows of 8 bf16 terms
constexpr int kThreads = 384;          // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kOffK = kTileBytes;      // after Q
constexpr int kOffV = kOffK + kStages * kTileBytes;
constexpr int kOffB = kOffV + kStages * kTileBytes;
// per stage three term boxes: Rw of the tile's columns 0-7, Rw of its columns
// 8-15, Rh of its rows
constexpr int kOffT = kOffB + kTileBytes;
constexpr int kOffBar = kOffT + kStages * 3 * kTermBytes;
constexpr int kBars = 1 + 3 * kStages;
constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;  // + slack to align the base
// A term lane of a key past the grid: -2^100 in bf16, finite (a -inf would
// give -inf * 0 = NaN in the other keys' sums) and far below any score.
constexpr uint32_t kMaskBf16 = 0xF180u;
}  // namespace rel

struct RelParams {
  CUtensorMap tq, tk, tv;  // Q 4-D as K1's; K, V 5-D (d, then column, row, head, batch by stride)
  CUtensorMap trh, trw;    // 3-D (term, query row, batch*head)
  int oq[3];
  int ok[4], ov[4];  // logical dim of map dims 1..4: 0 column, 1 row, 2 head, 3 batch
  void* o;
  long long o_sb, o_sh, o_sl;
  int H, Lq, kh, kw;
  int ncb, nk;        // column blocks of the grid, and tiles
  float scale_log2;   // scale * log2(e)
  uint32_t one;       // the one-hot's value, 1 / scale in bf16 (exact)
};

__device__ __forceinline__ int pick4(int which, int c, int r, int h, int b) {
  return which == 0 ? c : which == 1 ? r : which == 2 ? h : b;
}
// The K or V tile of grid rows r0..r0+7 and columns c0..c0+15: the 128-key,
// 128-byte-swizzled tile of the per-key path, key t = 16 (row - r0) + (column
// - c0); TMA zero-fills the slots past the grid.
__device__ __forceinline__ void tma_grid(void* dst, const CUtensorMap* map, const int (&ord)[4],
                                         uint64_t* bar, int c0, int r0, int h, int b) {
  sm90::tma_load_5d(dst, map, bar, 0, pick4(ord[0], c0, r0, h, b), pick4(ord[1], c0, r0, h, b),
                    pick4(ord[2], c0, r0, h, b), pick4(ord[3], c0, r0, h, b));
}

// A bf16 pair with the mask in each lane that is not kept.
__device__ __forceinline__ uint32_t mask_pair(uint32_t x, bool lo, bool hi) {
  return (lo ? x & 0xffffu : rel::kMaskBf16) | (hi ? x & 0xffff0000u : rel::kMaskBf16 << 16);
}

// This thread's A fragments of the two extra k16 steps (rows `row` and row + 8
// of the CTA; lanes 2 tig, 2 tig + 1 and 8 more): aw = Rw of the tile's
// columns, ah = Rh of its rows (lanes 8-15 zero).  t: the stage's term boxes,
// 4 words a query row.  cv, rv: the grid's columns and rows left from the
// tile's first; a lane past them carries the mask.
__device__ __forceinline__ void rel_terms(uint32_t (&aw)[4], uint32_t (&ah)[4],
                                          const uint32_t* t, int row, int tig, int cv, int rv) {
  constexpr int kBox = rel::kTermBytes / 4;
  aw[0] = t[row * 4 + tig];
  aw[1] = t[(row + 8) * 4 + tig];
  aw[2] = t[kBox + row * 4 + tig];
  aw[3] = t[kBox + (row + 8) * 4 + tig];
  ah[0] = t[2 * kBox + row * 4 + tig];
  ah[1] = t[2 * kBox + (row + 8) * 4 + tig];
  ah[2] = ah[3] = 0u;
  if (cv < rel::kCols || rv < rel::kRows) {  // a ragged tile, the same for the whole CTA
    const int c = tig * 2;
    aw[0] = mask_pair(aw[0], c < cv, c + 1 < cv);
    aw[1] = mask_pair(aw[1], c < cv, c + 1 < cv);
    aw[2] = mask_pair(aw[2], c + 8 < cv, c + 9 < cv);
    aw[3] = mask_pair(aw[3], c + 8 < cv, c + 9 < cv);
    ah[0] = mask_pair(ah[0], c < rv, c + 1 < rv);
    ah[1] = mask_pair(ah[1], c < rv, c + 1 < rv);
  }
}

// S (64 rows x 128 keys) = [Q | A] [K | B]^T: Q K^T from shared memory (depth
// 64), then A from registers against the one-hot B (depth 32), so that
// S = q.k + (Rw + Rh) / scale.
__device__ __forceinline__ void rel_qk(float (&s)[64], uint32_t q_base, uint32_t k_base,
                                       uint32_t b_base, const uint32_t (&aw)[4],
                                       const uint32_t (&ah)[4]) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss_m64n128(s, sm90::desc_kmajor_sw128(q_base + kk * 32),
                           sm90::desc_kmajor_sw128(k_base + kk * 32), kk > 0);
  sm90::wgmma_rs_m64n128<0>(s, aw, sm90::desc_kmajor_sw128(b_base), 1);
  sm90::wgmma_rs_m64n128<0>(s, ah, sm90::desc_kmajor_sw128(b_base + 32), 1);
  sm90::wgmma_commit();
}

__global__ void __launch_bounds__(rel::kThreads, 1)
    flash_fwd_relpos_sm90(const __grid_constant__ RelParams p) {
  using namespace rel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;  // the K tile and its three term boxes
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* kv_empty = bars + 1 + 2 * kStages;

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(kv_empty + s, 256);
    }
    sm90::fence_barrier_init();
  }
  // The one-hot B, K-major with the 128-byte swizzle like a K tile: key t =
  // 16 r + c holds 1 / scale at lanes c and 16 + r, 0 elsewhere (lanes 32-63
  // are never read).  Word w is row w / 32, 16-byte chunk (w / 4) % 8, which
  // holds logical chunk ((w / 4) % 8) ^ (row % 8).
  {
    uint32_t* bw = reinterpret_cast<uint32_t*>(smem + kOffB);
    for (int w = threadIdx.x; w < kTileBytes / 4; w += kThreads) {
      const int t = w >> 5;
      const int j = ((((w >> 2) & 7) ^ (t & 7)) << 3) + (w & 3) * 2;  // the word's first lane
      const int c = t % kCols, r = 16 + t / kCols;
      bw[w] = (j == c || j == r ? p.one : 0u) | (j + 1 == c || j + 1 == r ? p.one << 16 : 0u);
    }
    sm90::fence_proxy_async();  // the generic writes of B, before wgmma reads them
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_expect_tx(q_full, kTileBytes);
      tma_rows(smem, &p.tq, p.oq, q_full, 0, q0, h, b);
      int rb = 0, cb = 0;  // row blocks outside, column blocks inside
      for (int j = 0; j < p.nk; ++j) {
        const int st = j % kStages;
        sm90::mbar_wait(kv_empty + st, ((j / kStages) & 1) ^ 1);
        const int c0 = cb * kCols, r0 = rb * kRows;
        unsigned char* tt = smem + kOffT + st * 3 * kTermBytes;
        sm90::mbar_arrive_expect_tx(k_full + st, kTileBytes + 3 * kTermBytes);
        tma_grid(smem + kOffK + st * kTileBytes, &p.tk, p.ok, k_full + st, c0, r0, h, b);
        sm90::tma_load_3d(tt, &p.trw, k_full + st, c0, q0, blockIdx.y);
        sm90::tma_load_3d(tt + kTermBytes, &p.trw, k_full + st, c0 + 8, q0, blockIdx.y);
        sm90::tma_load_3d(tt + 2 * kTermBytes, &p.trh, k_full + st, r0, q0, blockIdx.y);
        sm90::mbar_arrive_expect_tx(v_full + st, kTileBytes);
        tma_grid(smem + kOffV + st * kTileBytes, &p.tv, p.ov, v_full + st, c0, r0, h, b);
        if (++cb == p.ncb) cb = 0, ++rb;
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup, K1's ping-pong ----
    sm90::setmaxnreg_inc<240>();
    const int wg = threadIdx.x >> 7;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // this thread's first query row in the CTA
    const uint32_t q_base = sm90::smem_u32(smem) + wg * 64 * 128;
    const uint32_t k_base = sm90::smem_u32(smem + kOffK);
    const uint32_t v_base = sm90::smem_u32(smem + kOffV);
    const uint32_t b_base = sm90::smem_u32(smem + kOffB);
    const uint32_t* terms = reinterpret_cast<const uint32_t*>(smem + kOffT);
    const int bar_mine = 1 + wg, bar_other = 2 - wg;

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, a_lo, a_hi;
    float s[64];
    uint32_t pa[8][4], aw[4], ah[4];

    if (wg == 1) sm90::named_bar_arrive(1, 256);
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(k_full, 0);
    rel_terms(aw, ah, terms, row, tig, p.kw, p.kh);
    sm90::named_bar_sync(bar_mine, 256);
    rel_qk(s, q_base, k_base, b_base, aw, ah);
    sm90::named_bar_arrive(bar_other, 256);
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    // the scores carry the terms: the unbiased softmax, every key of the tile kept
    fa3_softmax<false, 128>(s, nullptr, p.scale_log2, tig, 128, m_lo, m_hi, l_lo, l_hi, a_lo,
                            a_hi);
    fa3_pack<128>(s, pa);

    int rb = 0, cb = 0;
    for (int j = 1; j < p.nk; ++j) {
      if (++cb == p.ncb) cb = 0, ++rb;
      const int st = j % kStages, pst = (j - 1) % kStages;
      sm90::mbar_wait(k_full + st, (j / kStages) & 1);
      rel_terms(aw, ah, terms + st * 3 * (kTermBytes / 4), row, tig, p.kw - cb * kCols,
                p.kh - rb * kRows);
      sm90::named_bar_sync(bar_mine, 256);
      rel_qk(s, q_base, k_base + st * kTileBytes, b_base, aw, ah);  // S_j ...
      sm90::mbar_wait(v_full + pst, ((j - 1) / kStages) & 1);
      fa3_pv<64, 128>(o, pa, v_base + pst * kTileBytes);  // ... and O += P_{j-1} V_{j-1}
      sm90::named_bar_arrive(bar_other, 256);
      sm90::wgmma_wait<1>();  // S_j is ready; the PV product still runs
      sm90::reg_fence(s);
      fa3_softmax<false, 128>(s, nullptr, p.scale_log2, tig, 128, m_lo, m_hi, l_lo, l_hi, a_lo,
                              a_hi);
      sm90::wgmma_wait<0>();
      sm90::reg_fence(o);
      sm90::mbar_arrive(kv_empty + pst);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        o[4 * jj + 0] *= a_lo;
        o[4 * jj + 1] *= a_lo;
        o[4 * jj + 2] *= a_hi;
        o[4 * jj + 3] *= a_hi;
      }
      fa3_pack<128>(s, pa);
    }
    const int lst = (p.nk - 1) % kStages;
    sm90::named_bar_sync(bar_mine, 256);
    sm90::mbar_wait(v_full + lst, ((p.nk - 1) / kStages) & 1);
    fa3_pv<64, 128>(o, pa, v_base + lst * kTileBytes);
    if (wg == 0) sm90::named_bar_arrive(bar_other, 256);  // warpgroup 1's last turn
    sm90::wgmma_wait<0>();
    sm90::reg_fence(o);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = l_lo == 0.f ? 1.f : 1.f / l_lo;
    const float inv_hi = l_hi == 0.f ? 1.f : 1.f / l_hi;
    const int row_lo = q0 + row, row_hi = row_lo + 8;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = jj * 8 + tig * 2;
      if (row_lo < p.Lq)
        *reinterpret_cast<uint32_t*>(og + row_lo * p.o_sl + c) =
            sm90::pack_bf16(o[4 * jj + 0] * inv_lo, o[4 * jj + 1] * inv_lo);
      if (row_hi < p.Lq)
        *reinterpret_cast<uint32_t*>(og + row_hi * p.o_sl + c) =
            sm90::pack_bf16(o[4 * jj + 2] * inv_hi, o[4 * jj + 3] * inv_hi);
    }
  }
}

// ---- K2 on Hopper: d = 512 in bf16, d split over two warpgroups ----------------

namespace k2 {
constexpr int kBQ = 64, kBK = 64, kD = 512, kPanels = kD / 64;
constexpr int kPanelBytes = 64 * 128;              // 64 rows of 64 bf16, 128-byte swizzle
constexpr int kTileBytes = kPanels * kPanelBytes;  // a Q, K or V tile: 64 KB
constexpr int kOffK = kTileBytes, kOffV = 2 * kTileBytes, kOffP = 3 * kTileBytes;
constexpr int kOffRed = kOffP + kPanelBytes;  // a row maximum (or sum) per warpgroup
constexpr int kOffBar = kOffRed + 2 * kBQ * 4;
constexpr int kBars = 5;
constexpr size_t kSmem = kOffBar + kBars * 8 + 1024;  // + slack to align the base
// Two warpgroups and no producer warp: O, S and the softmax state need ~190
// registers a thread, and registers are allotted to a block in units of four
// warps, so a ninth warp would leave every thread 168 (and the kernel
// spilling) where eight warps leave 255.  Thread 0 issues the TMA loads.
constexpr int kThreads = 256;
}  // namespace k2

// The wgmma reads of a buffer are complete for the whole warp once it is past
// wgmma.wait_group, so lane 0 releases the buffer for it.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) sm90::mbar_arrive(bar);
}

// One K or V tile: eight 64-column panels onto one barrier.
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          const int (&ord)[3], uint64_t* bar, int row, int h,
                                          int b) {
  using namespace k2;
  sm90::mbar_arrive_expect_tx(bar, kTileBytes);
  for (int pn = 0; pn < kPanels; ++pn)
    tma_rows(dst + pn * kPanelBytes, map, ord, bar, pn * 64, row, h, b);
}

// One CTA: 64 query rows against all keys, in tiles of 64.  Both warpgroups
// work on the same rows: warpgroup w scores keys 32w..32w+31 of the tile over
// all of d and accumulates O[:, 256w..256w+255].
template <bool kBias>
__global__ void __launch_bounds__(k2::kThreads, 1)
    flash_fwd_d512_sm90(const __grid_constant__ Fa3Params p) {
  using namespace k2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + kOffRed);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 2;
  uint64_t* v_full = bars + 3;
  uint64_t* v_empty = bars + 4;

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int nk = (p.Lk + kBK - 1) / kBK;
  const bool loader = threadIdx.x == 0;

  if (loader) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(k_full, 1);
    sm90::mbar_init(k_empty, 8);  // lane 0 of each warp
    sm90::mbar_init(v_full, 1);
    sm90::mbar_init(v_empty, 8);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const uint32_t q_base = sm90::smem_u32(smem);
  // this warpgroup's 32 keys of each K panel, and its 4 panels (256 columns) of V
  const uint32_t k_base = sm90::smem_u32(smem + kOffK) + wg * 32 * 128;
  const uint32_t v_base = sm90::smem_u32(smem + kOffV) + wg * 4 * kPanelBytes;
  const uint32_t p_base = sm90::smem_u32(smem + kOffP);
  unsigned char* p_lo = smem + kOffP + r_lo * 128 + tig * 4;
  unsigned char* p_hi = p_lo + 8 * 128;
  const uint64_t dq0 = sm90::desc_kmajor_sw128(q_base), dk0 = sm90::desc_kmajor_sw128(k_base);
  const float sl2 = p.scale_log2;
  const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;

  if (loader) {
    sm90::mbar_arrive_expect_tx(q_full, kTileBytes);
    for (int pn = 0; pn < kPanels; ++pn)
      tma_rows(smem + pn * kPanelBytes, &p.tq, p.oq, q_full, pn * 64, q0, h, b);
    load_tile(smem + kOffK, &p.tk, p.ok, k_full, 0, h, b);
    load_tile(smem + kOffV, &p.tv, p.ov, v_full, 0, h, b);
  }
  __syncwarp();

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  sm90::mbar_wait(q_full, 0);
  for (int j = 0; j < nk; ++j) {
    const uint32_t ph = j & 1;
    // this thread's keys' bias, times log2(e); MASK_VALUE, unscaled, past Lk
    float bv[8];
    if constexpr (kBias) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = j * kBK + wg * 32 + (i / 2) * 8 + tig * 2 + (i & 1);
        bv[i] = key < p.Lk ? (bias_g ? __ldg(bias_g + key) * kLog2e : 0.f) : kMaskValue;
      }
    }

    // ---- S = Q K^T: 64 rows x this warpgroup's 32 keys, over all of d ----
    float s[16];
    sm90::mbar_wait(k_full, ph);
    sm90::wgmma_fence();
    // The descriptors are stepped (the start address is the low field, in
    // 16-byte units) inside a rolled loop over the panels: unrolled, the
    // compiler keeps all 64 of them in registers across the key loop.  The
    // trip count comes from the parameters although it is always kPanels:
    // with a constant one ptxas schedules the loop so that the kernel ran
    // 3.65 ms where this form ran 2.71 ms (2 x 16384 x 16384 x 512 on an H100).
    uint64_t dq = dq0, dk = dk0;
#pragma unroll 1
    for (int pn = 0; pn < p.panels; ++pn) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        sm90::wgmma_ss_m64n32(s, dq + ks * 2, dk + ks * 2, (pn | ks) != 0);
      dq += kPanelBytes >> 4;
      dk += kPanelBytes >> 4;
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    release(k_empty, lane);

    // ---- the tile's row maximum, over both warpgroups' keys ----
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
    if constexpr (kBias) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[4 * jj + 0] = fmaf(s[4 * jj + 0], sl2, bv[2 * jj]);
        s[4 * jj + 1] = fmaf(s[4 * jj + 1], sl2, bv[2 * jj + 1]);
        s[4 * jj + 2] = fmaf(s[4 * jj + 2], sl2, bv[2 * jj]);
        s[4 * jj + 3] = fmaf(s[4 * jj + 3], sl2, bv[2 * jj + 1]);
      }
    } else {
      const int valid = p.Lk - j * kBK - wg * 32;  // this half's keys inside Lk
      if (valid < 32) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if ((i / 4) * 8 + tig * 2 + (i & 1) >= valid) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * jj + 0], s[4 * jj + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    if (tig == 0) {
      red[wg * kBQ + r_lo] = mx_lo;
      red[wg * kBQ + r_hi] = mx_hi;
    }
    __syncthreads();
    // every warp has released K: the next K tile lands under the softmax and
    // the PV product
    if (loader && j + 1 < nk) {
      sm90::mbar_wait(k_empty, ph);
      load_tile(smem + kOffK, &p.tk, p.ok, k_full, (j + 1) * kBK, h, b);
    }
    __syncwarp();
    mx_lo = fmaxf(mx_lo, red[(wg ^ 1) * kBQ + r_lo]);
    mx_hi = fmaxf(mx_hi, red[(wg ^ 1) * kBQ + r_hi]);
    if constexpr (!kBias) {  // raw scores so far (scale > 0)
      mx_lo *= sl2;
      mx_hi *= sl2;
    }
    mx_lo = fmaxf(m_lo, mx_lo);  // finite: key 0 of the first tile is inside Lk
    mx_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = sm90::ex2(m_lo - mx_lo);  // m = -inf before the first tile: 2^-inf = 0
    const float a_hi = sm90::ex2(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

    // ---- P = 2^(t - m), its row sums, and P as bf16 into the K-major tile ----
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if constexpr (kBias) {
        s[4 * jj + 0] = sm90::ex2(s[4 * jj + 0] - mx_lo);
        s[4 * jj + 1] = sm90::ex2(s[4 * jj + 1] - mx_lo);
        s[4 * jj + 2] = sm90::ex2(s[4 * jj + 2] - mx_hi);
        s[4 * jj + 3] = sm90::ex2(s[4 * jj + 3] - mx_hi);
      } else {
        s[4 * jj + 0] = sm90::ex2(fmaf(s[4 * jj + 0], sl2, -mx_lo));
        s[4 * jj + 1] = sm90::ex2(fmaf(s[4 * jj + 1], sl2, -mx_lo));
        s[4 * jj + 2] = sm90::ex2(fmaf(s[4 * jj + 2], sl2, -mx_hi));
        s[4 * jj + 3] = sm90::ex2(fmaf(s[4 * jj + 3], sl2, -mx_hi));
      }
      sum_lo += s[4 * jj + 0] + s[4 * jj + 1];
      sum_hi += s[4 * jj + 2] + s[4 * jj + 3];
      // row r's 16-byte chunk c sits at chunk c ^ (r & 7) (128-byte swizzle); r & 7 = g
      const int chunk = ((wg * 4 + jj) ^ g) << 4;
      *reinterpret_cast<uint32_t*>(p_lo + chunk) = sm90::pack_bf16(s[4 * jj + 0], s[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(p_hi + chunk) = sm90::pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
    }
    l_lo = l_lo * a_lo + sum_lo;  // per-thread partial; reduced after the loop
    l_hi = l_hi * a_hi + sum_hi;
    sm90::fence_proxy_async();  // the generic writes of P, before wgmma reads them
    // O is rescaled only where a row's maximum moved
    if (__any_sync(0xffffffffu, a_lo != 1.f || a_hi != 1.f)) {
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        o[4 * jj + 0] *= a_lo;
        o[4 * jj + 1] *= a_lo;
        o[4 * jj + 2] *= a_hi;
        o[4 * jj + 3] *= a_hi;
      }
    }
    __syncthreads();  // both halves of P are written

    // ---- O[:, this warpgroup's 256 columns] += P V ----
    sm90::mbar_wait(v_full, ph);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      sm90::wgmma_ss_m64n256_tb(o, sm90::desc_kmajor_sw128(p_base + ks * 32),
                                sm90::desc_mnmajor_sw128(v_base + ks * 2048, kPanelBytes), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(o);
    release(v_empty, lane);
    // the next V tile lands under QK and the softmax of the next tile
    if (loader && j + 1 < nk) {
      sm90::mbar_wait(v_empty, ph);
      load_tile(smem + kOffV, &p.tv, p.ov, v_full, (j + 1) * kBK, h, b);
    }
    __syncwarp();
  }

  // ---- the row sums over both warpgroups' keys, normalise, store ----
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  if (tig == 0) {
    red[wg * kBQ + r_lo] = l_lo;
    red[wg * kBQ + r_hi] = l_hi;
  }
  __syncthreads();
  l_lo = red[r_lo] + red[kBQ + r_lo];
  l_hi = red[r_hi] + red[kBQ + r_hi];
  const float inv_lo = l_lo == 0.f ? 1.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 1.f : 1.f / l_hi;
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + wg * 256;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const int c = jj * 8 + tig * 2;
    if (row_lo < p.Lq)
      *reinterpret_cast<uint32_t*>(og + row_lo * p.o_sl + c) =
          sm90::pack_bf16(o[4 * jj + 0] * inv_lo, o[4 * jj + 1] * inv_lo);
    if (row_hi < p.Lq)
      *reinterpret_cast<uint32_t*>(og + row_hi * p.o_sl + c) =
          sm90::pack_bf16(o[4 * jj + 2] * inv_hi, o[4 * jj + 3] * inv_hi);
  }
}

// A 4-D TMA map over a (B, H, L, D) bf16 tensor with (b, h, l) strides in
// elements: d innermost, then the three outer dims in order of stride (the
// U-Net passes (B, L, H, D) memory viewed as (B, H, L, D)), with a box of
// 64 x `rows` rows.  ord[i] names the logical dim of map dim i + 1.
cudaError_t attn_map(CUtensorMap* map, int (&ord)[3], const void* base, const long long* st, int B,
                     int H, int L, int D, uint32_t rows = 128) {
  struct Dim {
    uint64_t n;
    long long stride;
    int logical;
    uint32_t box;
  } dd[3] = {{uint64_t(L), st[2], 0, rows}, {uint64_t(H), st[1], 1, 1}, {uint64_t(B), st[0], 2, 1}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && dd[j].stride < dd[j - 1].stride; --j) {
      const Dim t = dd[j];
      dd[j] = dd[j - 1];
      dd[j - 1] = t;
    }
  const uint64_t dims[4] = {uint64_t(D), dd[0].n, dd[1].n, dd[2].n};
  const uint64_t strides[3] = {uint64_t(dd[0].stride) * 2, uint64_t(dd[1].stride) * 2,
                               uint64_t(dd[2].stride) * 2};
  const uint32_t box[4] = {64, dd[0].box, dd[1].box, dd[2].box};
  for (int i = 0; i < 3; ++i) ord[i] = dd[i].logical;
  return sm90::make_map_bf16(map, 4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, int STAGES, bool kBias>
cudaError_t launch_sm90(const AttnParams& a, const long long* qs, const long long* ks,
                        const long long* vs, int batch, cudaStream_t stream) {
  using S = Fa3<D, STAGES>;
  Fa3Params p;
  cudaError_t err = attn_map(&p.tq, p.oq, a.q, qs, batch, a.H, a.Lq, D);
  if (err == cudaSuccess) err = attn_map(&p.tk, p.ok, a.k, ks, batch, a.H, a.Lk, D);
  if (err == cudaSuccess) err = attn_map(&p.tv, p.ov, a.v, vs, batch, a.H, a.Lk, D);
  if (err != cudaSuccess) return err;
  p.bias = a.bias;
  p.bias_sb = a.bias_sb;
  p.o = a.o;
  p.o_sb = a.o_sb, p.o_sh = a.o_sh, p.o_sl = a.o_sl;
  p.H = a.H, p.Lq = a.Lq, p.Lk = a.Lk;
  p.scale_log2 = a.scale * kLog2e;
  p.panels = 0;
  auto kern = flash_fwd_sm90<D, STAGES, kBias>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + S::kBQ - 1) / S::kBQ, batch * a.H);
  kern<<<grid, S::kThreads, S::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// A 5-D TMA map over a (B, H, kh * kw, 64) bf16 tensor whose keys lie
// row-major on a kh x kw grid, (b, h, key) strides in elements: d innermost,
// then column, row, head and batch in order of stride, with a box of 64 x 16
// columns x 8 rows.  ord[i] names the logical dim of map dim i + 1.
cudaError_t grid_map(CUtensorMap* map, int (&ord)[4], const void* base, const long long* st,
                     int B, int H, int kh, int kw) {
  struct Dim {
    uint64_t n;
    long long stride;
    int logical;
    uint32_t box;
  } dd[4] = {{uint64_t(kw), st[2], 0, uint32_t(rel::kCols)},
             {uint64_t(kh), st[2] * kw, 1, uint32_t(rel::kRows)},
             {uint64_t(H), st[1], 2, 1},
             {uint64_t(B), st[0], 3, 1}};
  for (int i = 1; i < 4; ++i)
    for (int j = i; j > 0 && dd[j].stride < dd[j - 1].stride; --j) {
      const Dim t = dd[j];
      dd[j] = dd[j - 1];
      dd[j - 1] = t;
    }
  uint64_t dims[5] = {64}, strides[4];
  uint32_t box[5] = {64};
  for (int i = 0; i < 4; ++i) {
    dims[i + 1] = dd[i].n;
    strides[i] = uint64_t(dd[i].stride) * 2;
    box[i + 1] = dd[i].box;
    ord[i] = dd[i].logical;
  }
  return sm90::make_map_bf16(map, 5, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A 3-D TMA map over the terms (B*H, Lq, n) bf16, row stride ld (a multiple
// of 8), rows packed: boxes of 8 terms x 128 query rows.
cudaError_t term_map(CUtensorMap* map, const void* base, int BH, int Lq, int n, int ld) {
  const uint64_t dims[3] = {uint64_t(n), uint64_t(Lq), uint64_t(BH)};
  const uint64_t strides[2] = {uint64_t(ld) * 2, uint64_t(ld) * Lq * 2};
  const uint32_t box[3] = {8, 128, 1};
  return sm90::make_map_bf16(map, 3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

cudaError_t launch_relpos_sm90(const AttnParams& a, const void* rh, const void* rw, int kh,
                               int kw, int ldh, int ldw, const long long* qs, const long long* ks,
                               const long long* vs, int batch, cudaStream_t stream) {
  using namespace rel;
  // the one-hot carries 1 / scale, which has to be exact in bf16 (1/8 at d = 64)
  const float inv = 1.f / a.scale;
  const __nv_bfloat16 one = __float2bfloat16(inv);
  if (kw < 1 || kh < 1 || size_t(kh) * kw != size_t(a.Lk) || !(a.scale > 0.f) ||
      __bfloat162float(one) != inv || ldh < kh || ldw < kw || ldh % 8 || ldw % 8)
    return cudaErrorInvalidValue;
  RelParams p;
  const int bh = batch * a.H;
  cudaError_t err = attn_map(&p.tq, p.oq, a.q, qs, batch, a.H, a.Lq, 64);
  if (err == cudaSuccess) err = grid_map(&p.tk, p.ok, a.k, ks, batch, a.H, kh, kw);
  if (err == cudaSuccess) err = grid_map(&p.tv, p.ov, a.v, vs, batch, a.H, kh, kw);
  if (err == cudaSuccess) err = term_map(&p.trh, rh, bh, a.Lq, kh, ldh);
  if (err == cudaSuccess) err = term_map(&p.trw, rw, bh, a.Lq, kw, ldw);
  if (err != cudaSuccess) return err;
  p.o = a.o;
  p.o_sb = a.o_sb, p.o_sh = a.o_sh, p.o_sl = a.o_sl;
  p.H = a.H, p.Lq = a.Lq, p.kh = kh, p.kw = kw;
  p.ncb = (kw + kCols - 1) / kCols;
  p.nk = p.ncb * ((kh + kRows - 1) / kRows);
  p.scale_log2 = a.scale * kLog2e;
  p.one = *reinterpret_cast<const uint16_t*>(&one);
  err = cudaFuncSetAttribute(flash_fwd_relpos_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, bh);
  flash_fwd_relpos_sm90<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t launch_d512_sm90(const AttnParams& a, const long long* qs, const long long* ks,
                             const long long* vs, int batch, cudaStream_t stream) {
  Fa3Params p;
  cudaError_t err = attn_map(&p.tq, p.oq, a.q, qs, batch, a.H, a.Lq, k2::kD, k2::kBQ);
  if (err == cudaSuccess) err = attn_map(&p.tk, p.ok, a.k, ks, batch, a.H, a.Lk, k2::kD, k2::kBK);
  if (err == cudaSuccess) err = attn_map(&p.tv, p.ov, a.v, vs, batch, a.H, a.Lk, k2::kD, k2::kBK);
  if (err != cudaSuccess) return err;
  p.bias = a.bias;
  p.bias_sb = a.bias_sb;
  p.o = a.o;
  p.o_sb = a.o_sb, p.o_sh = a.o_sh, p.o_sl = a.o_sl;
  p.H = a.H, p.Lq = a.Lq, p.Lk = a.Lk;
  p.scale_log2 = a.scale * kLog2e;
  p.panels = k2::kPanels;
  auto kern = flash_fwd_d512_sm90<kBias>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(k2::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + k2::kBQ - 1) / k2::kBQ, batch * a.H);
  kern<<<grid, k2::kThreads, k2::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK, int KSPLIT, int STAGES>
cudaError_t launch(const AttnParams& p, int batch, cudaStream_t stream) {
  using S = FlashShape<T, D, BQ, BK, KSPLIT, STAGES>;
  auto kern = flash_fwd<T, D, BQ, BK, KSPLIT, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, batch * p.H);
  kern<<<grid, S::kThreads, S::kSmem, stream>>>(p);
  return cudaGetLastError();
}

AttnParams make_params(const void* q, const void* k, const void* v, const float* bias, void* o,
                       const long long* qs, const long long* ks, const long long* vs,
                       const long long* os, long long bias_sb, int H, int Lq, int Lk,
                       float scale) {
  AttnParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.o = o;
  p.q_sb = qs[0], p.q_sh = qs[1], p.q_sl = qs[2];
  p.k_sb = ks[0], p.k_sh = ks[1], p.k_sl = ks[2];
  p.v_sb = vs[0], p.v_sh = vs[1], p.v_sl = vs[2];
  p.o_sb = os[0], p.o_sh = os[1], p.o_sl = os[2];
  p.bias_sb = bias_sb;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, head,
// row) for each of q, k, v, o (arrays of three).  rh, rw, kh, kw, ldh, ldw
// (K1 only, appended before the stream): the relative-position terms,
// (B*H, Lq, kh) and (B*H, Lq, kw) bf16 with row strides ldh and ldw (multiples
// of 8, rows packed), or null.  Returns a cudaError_t.
extern "C" int sdm_flash_attention_k1(int dtype, int d, const void* q, const void* k,
                                      const void* v, const float* bias, void* o,
                                      const long long* qs, const long long* ks,
                                      const long long* vs, const long long* os,
                                      long long bias_sb, int B, int H, int Lq, int Lk,
                                      float scale, const void* rh, const void* rw, int kh,
                                      int kw, int ldh, int ldw, void* stream) {
  const AttnParams p = make_params(q, k, v, bias, o, qs, ks, vs, os, bias_sb, H, Lq, Lk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rh != nullptr || rw != nullptr) {
    if (rh == nullptr || rw == nullptr || bias != nullptr || dtype != 1 || d != 64)
      return int(cudaErrorInvalidValue);
    return launch_relpos_sm90(p, rh, rw, kh, kw, ldh, ldw, qs, ks, vs, B, s);
  }
  // Without a bias (and with a positive scale) K1 takes the max on the raw
  // scores and saves one fp32 operation per score.
  const bool biased = bias != nullptr || !(scale > 0.f);
  if (dtype == 1 && d == 64)
    return biased ? launch_sm90<64, 3, true>(p, qs, ks, vs, B, s)
                  : launch_sm90<64, 3, false>(p, qs, ks, vs, B, s);
  if (dtype == 1 && d == 128)
    return biased ? launch_sm90<128, 2, true>(p, qs, ks, vs, B, s)
                  : launch_sm90<128, 2, false>(p, qs, ks, vs, B, s);
  if (dtype == 0 && d == 64) return launch<float, 64, 64, 64, 1, 2>(p, B, s);
  if (dtype == 0 && d == 128) return launch<float, 128, 64, 64, 1, 2>(p, B, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int sdm_flash_attention_k2(int dtype, int d, const void* q, const void* k,
                                      const void* v, const float* bias, void* o,
                                      const long long* qs, const long long* ks,
                                      const long long* vs, const long long* os,
                                      long long bias_sb, int B, int H, int Lq, int Lk,
                                      float scale, void* stream) {
  const AttnParams p = make_params(q, k, v, bias, o, qs, ks, vs, os, bias_sb, H, Lq, Lk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // as K1: without a bias and with a positive scale the max is taken on the raw scores
  const bool biased = bias != nullptr || !(scale > 0.f);
  if (dtype == 1 && d == 512)
    return biased ? launch_d512_sm90<true>(p, qs, ks, vs, B, s)
                  : launch_d512_sm90<false>(p, qs, ks, vs, B, s);
  if (dtype == 0 && d == 512) return launch<float, 512, 32, 32, 2, 1>(p, B, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
