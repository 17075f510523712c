// GroupNorm on NHWC memory as two passes over the activation, hand-written for
// Hopper (sm_90a):
//
//   statistics  (a, d)[b, c] with GroupNorm(x) = x * a + d:
//               a = rsqrt(E[x^2] - E[x]^2 + eps) * gamma[c],  d = beta[c] - E[x] * a,
//               E over the (H, W, channels of c's group) of batch b, in fp32
//   apply       y = x * a + d, then SiLU when asked, in fp32; one rounding to x's dtype
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA
// (sdmatte_tpu/core/nn.py group_norm_stats, group_norm), which fuses it into its
// neighbours.  Before these kernels the port ran the same math as some twenty
// PyTorch ops a site: two strided reductions over the whole input, about
// seventeen tiny ops on (B, C), the apply (addcmul) and the SiLU as passes of their own.
//
// What bounds it on the H100: bytes.  A site reads and writes 2 bytes (bf16) a
// value and does a handful of operations on it, far below the ridge, so the
// designs move each byte once:
//   - gn_stats_sm90 reads the input once.  A thread owns 8 consecutive channels
//     (one 16-byte vector of bf16, two of fp32) and walks rows of a slab of H*W
//     rows, four vectors in flight; a block is R rows of C/8 threads, so its
//     threads read R whole rows, contiguous.  fp32 sums of x and x^2 per channel
//     stay in registers, then fold over the block's R rows in shared memory, in
//     a fixed order, into (B, S, C, 2) fp32 partials.  Bound: the input's bytes
//     at 3.35 TB/s (the partials are at most 4 / rows-a-slab of it).
//   - gn_finish folds the S slabs and the group's channels, in a fixed order
//     (a block of 256 threads a (group, batch): strided sums, then a tree), into
//     the group's E[x] and E[x^2] and writes (a, d) as (B, C) fp32.  It reads the
//     partials once: a few microseconds at the largest shapes.
//   - gn_apply_sm90 reads the input once and writes the output once, with the
//     same thread layout: a thread keeps its 8 channels' a and d in registers
//     while it walks rows.  Bound: twice the input's bytes at 3.35 TB/s.  The
//     SiLU of a bf16 output takes the SFU's exp (__expf), whose error the one
//     bf16 rounding hides, so the pass stays a few instructions a value; an
//     fp32 output takes expf, as torch's silu does.
// No float atomics: every sum is taken in an order fixed by the shape, so a
// launch gives the same bits each time, eagerly and replayed from a CUDA graph.
// The grids are set by the caller (ops/group_norm.py slabs): S slabs of rows a
// batch, so the large shapes put several blocks on each of the 132 SMs and the
// 16^2 ones stay a few blocks.
//
// Memory layout: x and y are NHWC (the port's NCHW tensors in
// torch.channels_last), 16-byte aligned; C a multiple of 8 and C / 8 at most
// kMaxThreads; any group size (10 and 30 channels at C = 320 and 960 too: the
// partials are per channel, the groups meet only in gn_finish).  gamma and beta
// are (C) in bf16 or fp32; a, d (B, C) fp32; part (B, S, C, 2) fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;            // channels a thread owns
constexpr int kRowThreads = 256;   // a block's threads, as near as whole rows allow
constexpr int kMaxThreads = 512;   // C <= 4096
constexpr int kUnroll = 4;         // rows a thread has in flight
constexpr int kFinishThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// rows of a slab or chunk: [r0, r1) of batch blockIdx.y
struct Rows {
  int r0, r1;
};

__device__ __forceinline__ Rows rows_of(int hw, int per_block) {
  const int r0 = blockIdx.x * per_block;
  return {r0, min(r0 + per_block, hw)};
}

// ---- statistics: per-channel partial sums over a slab of rows -------------------

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gn_stats_sm90(const T* __restrict__ x,
                                                              float* __restrict__ part, int hw,
                                                              int c, int rows_per_slab) {
  __shared__ float red[2 * kMaxThreads * kVec];
  const int tpr = c / kVec;
  const int nr = blockDim.x / tpr;  // rows a step
  const int lane_row = threadIdx.x / tpr;
  const int cv = threadIdx.x - lane_row * tpr;
  const Rows rows = rows_of(hw, rows_per_slab);
  const T* xb = x + size_t(blockIdx.y) * hw * c + cv * kVec;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) s1[i] = s2[i] = 0.f;
  int r = rows.r0 + lane_row;
  for (; r + (kUnroll - 1) * nr < rows.r1; r += kUnroll * nr) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(xb + size_t(r + u * nr) * c, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s1[i] += v[u][i];
        s2[i] = fmaf(v[u][i], v[u][i], s2[i]);
      }
  }
  for (; r < rows.r1; r += nr) {
    float v[kVec];
    load8(xb + size_t(r) * c, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
  // red[0, nr*c): sums of x by (row lane, channel); red[nr*c, 2*nr*c): of x^2
  float* r1 = red + lane_row * c + cv * kVec;
  float* r2 = r1 + nr * c;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    r1[i] = s1[i];
    r2[i] = s2[i];
  }
  __syncthreads();
  float* out = part + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * c * 2;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < nr; ++j) {
      t1 += red[j * c + ch];
      t2 += red[(nr + j) * c + ch];
    }
    reinterpret_cast<float2*>(out)[ch] = make_float2(t1, t2);
  }
}

// ---- finish: the group's statistics and the per-channel (a, d) ------------------

__device__ __forceinline__ float param(const void* p, int wdtype, int i) {
  return wdtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kFinishThreads) gn_finish(const float* __restrict__ part,
                                                            const void* gamma, const void* beta,
                                                            int wdtype, float* __restrict__ a,
                                                            float* __restrict__ d, int slabs,
                                                            int c, int groups, float n,
                                                            float eps) {
  __shared__ float red1[kFinishThreads], red2[kFinishThreads];
  __shared__ float stat[2];
  const int g = blockIdx.x, b = blockIdx.y, cg = c / groups;
  const float* pb = part + size_t(b) * slabs * c * 2 + size_t(g) * cg * 2;
  float t1 = 0.f, t2 = 0.f;
  const int items = slabs * cg;
  for (int i = threadIdx.x; i < items; i += kFinishThreads) {
    const int s = i / cg, j = i - s * cg;
    const float2 v = reinterpret_cast<const float2*>(pb + size_t(s) * c * 2)[j];
    t1 += v.x;
    t2 += v.y;
  }
  red1[threadIdx.x] = t1;
  red2[threadIdx.x] = t2;
  __syncthreads();
#pragma unroll
  for (int w = kFinishThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red1[threadIdx.x] += red1[threadIdx.x + w];
      red2[threadIdx.x] += red2[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float mean = red1[0] / n;
    const float sq = red2[0] / n;
    stat[0] = mean;
    stat[1] = rsqrtf(sq - mean * mean + eps);
  }
  __syncthreads();
  const float mean = stat[0], inv = stat[1];
  for (int j = threadIdx.x; j < cg; j += kFinishThreads) {
    const int ch = g * cg + j;
    const float av = inv * param(gamma, wdtype, ch);
    a[size_t(b) * c + ch] = av;
    d[size_t(b) * c + ch] = param(beta, wdtype, ch) - mean * av;
  }
}

// ---- apply: y = x * a + d [then SiLU], one rounding -----------------------------

template <typename T>
__device__ __forceinline__ float silu_of(float t) {
  return t / (1.f + __expf(-t));
}

template <>
__device__ __forceinline__ float silu_of<float>(float t) {
  return t / (1.f + expf(-t));
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kMaxThreads) gn_apply_sm90(const T* __restrict__ x,
                                                              const float* __restrict__ a,
                                                              const float* __restrict__ d,
                                                              T* __restrict__ y, int hw, int c,
                                                              int rows_per_block) {
  const int tpr = c / kVec;
  const int nr = blockDim.x / tpr;
  const int lane_row = threadIdx.x / tpr;
  const int cv = threadIdx.x - lane_row * tpr;
  const Rows rows = rows_of(hw, rows_per_block);
  const size_t base = size_t(blockIdx.y) * hw * c + cv * kVec;
  float av[kVec], dv[kVec];
  {
    const float* ab = a + size_t(blockIdx.y) * c + cv * kVec;
    const float* db = d + size_t(blockIdx.y) * c + cv * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      av[i] = ab[i];
      dv[i] = db[i];
    }
  }
  int r = rows.r0 + lane_row;
  for (; r + (kUnroll - 1) * nr < rows.r1; r += kUnroll * nr) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(x + base + size_t(r + u * nr) * c, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float t = fmaf(v[u][i], av[i], dv[i]);
        v[u][i] = kSilu ? silu_of<T>(t) : t;
      }
      store8(y + base + size_t(r + u * nr) * c, v[u]);
    }
  }
  for (; r < rows.r1; r += nr) {
    float v[kVec];
    load8(x + base + size_t(r) * c, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float t = fmaf(v[i], av[i], dv[i]);
      v[i] = kSilu ? silu_of<T>(t) : t;
    }
    store8(y + base + size_t(r) * c, v);
  }
}

// whole rows of C / 8 threads, as near kRowThreads as they come
int block_threads(int c) {
  const int tpr = c / kVec;
  return tpr >= kRowThreads ? tpr : (kRowThreads / tpr) * tpr;
}

bool bad_shape(int b, int hw, int c, int slabs) {
  return b <= 0 || hw <= 0 || c <= 0 || c % kVec || c / kVec > kMaxThreads || slabs <= 0 ||
         b > 65535;
}

template <typename T>
cudaError_t launch_stats(const T* x, float* part, int b, int hw, int c, int slabs,
                         cudaStream_t s) {
  const int per = (hw + slabs - 1) / slabs;
  gn_stats_sm90<T><<<dim3(slabs, b), block_threads(c), 0, s>>>(x, part, hw, c, per);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const T* x, const float* a, const float* d, T* y, int b, int hw, int c,
                         int chunks, int silu, cudaStream_t s) {
  const int per = (hw + chunks - 1) / chunks;
  const dim3 grid(chunks, b);
  if (silu)
    gn_apply_sm90<T, true><<<grid, block_threads(c), 0, s>>>(x, a, d, y, hw, c, per);
  else
    gn_apply_sm90<T, false><<<grid, block_threads(c), 0, s>>>(x, a, d, y, hw, c, per);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, H*W, C) NHWC; part (B, slabs, C, 2)
// fp32.  Returns a cudaError_t.
extern "C" int sdm_gn_stats(int dtype, const void* x, float* part, int b, int hw, int c,
                            int slabs, void* stream) {
  if (bad_shape(b, hw, c, slabs)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(launch_stats(static_cast<const __nv_bfloat16*>(x), part, b, hw, c, slabs, s));
  if (dtype == 0) return int(launch_stats(static_cast<const float*>(x), part, b, hw, c, slabs, s));
  return int(cudaErrorInvalidValue);
}

// part (B, slabs, C, 2) fp32 -> a, d (B, C) fp32; gamma, beta (C) in wdtype
// (0 = float32, 1 = bfloat16); n = H * W * C / groups.
extern "C" int sdm_gn_finish(const float* part, const void* gamma, const void* beta, int wdtype,
                             float* a, float* d, int b, int c, int groups, int slabs, float n,
                             float eps, void* stream) {
  if (b <= 0 || b > 65535 || groups <= 0 || c % groups || slabs <= 0 || (wdtype != 0 && wdtype != 1))
    return int(cudaErrorInvalidValue);
  gn_finish<<<dim3(groups, b), kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, gamma, beta, wdtype, a, d, slabs, c, groups, n, eps);
  return int(cudaGetLastError());
}

// y = x * a + d [then SiLU] over (B, H*W, C) NHWC in dtype; a, d (B, C) fp32;
// the rows of a batch in `chunks` blocks.
extern "C" int sdm_gn_apply(int dtype, const void* x, const float* a, const float* d, void* y,
                            int b, int hw, int c, int chunks, int silu, void* stream) {
  if (bad_shape(b, hw, c, chunks)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int(launch_apply(static_cast<const __nv_bfloat16*>(x), a, d,
                            static_cast<__nv_bfloat16*>(y), b, hw, c, chunks, silu, s));
  if (dtype == 0)
    return int(launch_apply(static_cast<const float*>(x), a, d, static_cast<float*>(y), b, hw, c,
                            chunks, silu, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* sdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
