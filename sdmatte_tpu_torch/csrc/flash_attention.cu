// Flash attention with an additive per-key bias, hand-written for Hopper (sm_90a).
//
//   out[b,h,q,:] = softmax_k(scale * q.k + bias[b,k]) @ v[b,h,:,:]
//
// Replaces the Pallas kernels of sdmatte_tpu/ops/flash_attention.py:
//   K1 (d <= 128): ::_kernel_fused_l and ::_kernel_d64_v2, the U-Net's d=64
//      self- and cross-attention;
//   K2 (d = 512):  ::_kernel, the VAE mid-block's single-head attention.
// Both are instantiations of one template (flash_fwd below).
//
// What bounds it on the H100: operations. At the main path's shapes
// (L = 1024..16384 keys, d = 64 or 512) the kernel does 4*L*d flops per query
// row and reads each K/V byte once per 64-row query tile, far above the card's
// ~295 flop/byte ridge. So the design keeps the (Lq, Lk) score matrix out of
// device memory (online softmax, fp32 running max and sum in registers) and
// feeds the tensor cores with mma.sync m16n8k16 bf16 -> fp32; K/V tiles stream
// through a two-stage cp.async ring. wgmma, TMA and warp specialisation are
// not used yet.
//
// Layout: one block per (query tile, batch*head); the KV loop runs inside
// the block in place of the TPU grid's sequential ki axis.  Each warp owns 16
// query rows.  K1 (KSPLIT = 1): a warp computes its rows' scores for the whole
// KV tile, keeps P in registers and feeds it straight into the PV product.
// (Two 16-row m-tiles per warp, which halves the shared-memory reads per
// product, measured no faster at d=64: the kernel is held back by the exp2
// rate as much as by the products, and the larger tile costs resident warps.)
// K2 (KSPLIT = 2): a d=512 accumulator does not fit one warp's registers, so
// two warps share a row group: each scores half of the KV tile, the row max
// and P are exchanged through shared memory, and each accumulates half of d.
//
// Tensors are addressed through (batch, head, row) strides; d is contiguous.
// Keys past Lk score exactly MASK_VALUE, as the TPU kernel's padded keys do;
// query rows past Lq are computed on zeros and not stored.  The bias is
// added, never turned into -inf, so a row whose keys all carry -10000 still
// gives the uniform average.
//
// fp32 inputs run the same tiling, masking and online softmax with the two
// products done by plain FMA on the same fragment layout (no tensor cores), so
// the kernel can be checked at fp32 tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr bool kTensorCores = true;
};
template <>
struct Cfg<float> {
  static constexpr bool kTensorCores = false;
};

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
  static constexpr bool kPInSmem = KSPLIT > 1 || !Cfg<T>::kTensorCores;
  static constexpr size_t kQBytes = size_t(BQ) * kLds * sizeof(T);
  static constexpr size_t kKVBytes = size_t(STAGES) * BK * kLds * sizeof(T);
  static constexpr size_t kPBytes = kPInSmem ? size_t(BQ) * kLdp * sizeof(T) : 0;
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
  constexpr bool kTC = Cfg<T>::kTensorCores;
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
    if constexpr (kTC) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + (rg * 16 + (lane & 15)) * kLds + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          uint32_t bf[4];
          const int key = kh * BKW + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bf, Kt + key * kLds + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    } else {
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
    if constexpr (kTC && !S::kPInSmem) {
      // P goes from the score fragments straight into the A operand.
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int dp = 0; dp < NT_O / 2; ++dp) {
          uint32_t bf[4];
          const int key = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(bf, Vt + key * kLds + kh * DW + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], a, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    } else {
      // P is exchanged through shared memory (the two warps of a row group
      // each scored half of the tile; fp32 reads it back by plain loads).
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const int c = kh * BKW + nt * 8 + tig * 2;
        if constexpr (kTC) {
          *reinterpret_cast<uint32_t*>(Ps + r_lo * kLdp + c) = pack_bf16(s[nt][0], s[nt][1]);
          *reinterpret_cast<uint32_t*>(Ps + r_hi * kLdp + c) = pack_bf16(s[nt][2], s[nt][3]);
        } else {
          Ps[r_lo * kLdp + c] = s[nt][0];
          Ps[r_lo * kLdp + c + 1] = s[nt][1];
          Ps[r_hi * kLdp + c] = s[nt][2];
          Ps[r_hi * kLdp + c + 1] = s[nt][3];
        }
      }
      __syncthreads();
      if constexpr (kTC) {
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          uint32_t a[4];
          ldmatrix_x4(a, Ps + (rg * 16 + (lane & 15)) * kLdp + j * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int dp = 0; dp < NT_O / 2; ++dp) {
            uint32_t bf[4];
            const int key = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(bf, Vt + key * kLds + kh * DW + dp * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], a, bf[0], bf[1]);
            mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
          }
        }
      } else {
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
    if constexpr (kTC) {
      if (row_lo < p.Lq)
        *reinterpret_cast<uint32_t*>(og + row_lo * p.o_sl + c) =
            pack_bf16(o[nt][0] * inv_lo, o[nt][1] * inv_lo);
      if (row_hi < p.Lq)
        *reinterpret_cast<uint32_t*>(og + row_hi * p.o_sl + c) =
            pack_bf16(o[nt][2] * inv_hi, o[nt][3] * inv_hi);
    } else {
      if (row_lo < p.Lq)
        *reinterpret_cast<float2*>(og + row_lo * p.o_sl + c) =
            make_float2(o[nt][0] * inv_lo, o[nt][1] * inv_lo);
      if (row_hi < p.Lq)
        *reinterpret_cast<float2*>(og + row_hi * p.o_sl + c) =
            make_float2(o[nt][2] * inv_hi, o[nt][3] * inv_hi);
    }
  }
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
// row) for each of q, k, v, o (arrays of three).  Returns a cudaError_t.
extern "C" int sdm_flash_attention_k1(int dtype, int d, const void* q, const void* k,
                                      const void* v, const float* bias, void* o,
                                      const long long* qs, const long long* ks,
                                      const long long* vs, const long long* os,
                                      long long bias_sb, int B, int H, int Lq, int Lk,
                                      float scale, void* stream) {
  const AttnParams p = make_params(q, k, v, bias, o, qs, ks, vs, os, bias_sb, H, Lq, Lk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64, 64, 64, 1, 2>(p, B, s);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128, 64, 64, 1, 2>(p, B, s);
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
  if (dtype == 1 && d == 512) return launch<__nv_bfloat16, 512, 64, 32, 2, 2>(p, B, s);
  if (dtype == 0 && d == 512) return launch<float, 512, 32, 32, 2, 1>(p, B, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
