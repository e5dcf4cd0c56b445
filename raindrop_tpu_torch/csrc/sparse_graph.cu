// Sparse sensor-graph kernels: the Hopper counterparts of
// raindrop_tpu/ops/sparse_pallas.py:_spmm_kernel (:64) with its backward
// (_spmm_bwd, :110) and :_sddmm_kernel (:195) with its backward (:230).
//
//   spmm_segment_softmax  out[b,n,:] = sum_{e: dst_e = n} w[b,e] * x[b,idx_e,:],
//                         w[b,:] = softmax of gamma[b,:] within each dst segment,
//                         idx = dst (gather_target) or src
//   its backward          dgamma[b,e] = w_e * (s_e - sum_{e' in seg(e)} w_e' s_e'),
//                         s_e = g_out[b,dst_e] . x[b,idx_e] + g_w[b,e];
//                         dx[b,v,:] = sum_{e: idx_e = v} w[b,e] * g_out[b,dst_e,:]
//   sddmm                 alpha[b,e] = scale * q[b,dst_e] . k[b,src_e]
//   its backward          dq[b,n,:] = sum_{e: dst_e = n} scale * dalpha[b,e] * k[b,src_e,:]
//                         dk[b,n,:] = sum_{e: src_e = n} scale * dalpha[b,e] * q[b,dst_e,:]
//
// All f32, x/q/k [B, N, D], gamma/w/alpha [B, E], one topology for the batch.
//
// What bounds them: every one moves its [B, N, D] arrays once (the repeated
// gathers of one row hit L1/L2) and does 2 FLOPs per gathered element, a few
// FLOP per byte at most, so the memory rate is the bound.
//
// Design: the TPU kernels turn gather and scatter into one-hot matrix products
// because that chip gathers badly; nothing of that carries over. Here the
// wrapper sorts the edges once per topology into two CSRs (by dst and by
// src: `perm` [E] the edge ids in segment order, `ptr` [N+1]), so the edges
// may come in any order and every reduction by index becomes a loop over
// one segment inside one CTA, in CSR order: no atomics, the same bits on a
// repeat. Four of the five reductions are one routine, a weighted sum of
// gathered rows (gather_sum_kernel): one CTA per (node, sample, 1024
// columns), the segment's weights and row indices staged through shared
// memory, threads along D so a row is read coalesced. The forward computes
// the segment's softmax in the same CTA before it (max, sum of exp, in a
// fixed order) and writes w back in the caller's edge order. The per-edge
// dot products (sddmm, and s_e of dgamma) take one warp per edge with a
// shuffle reduction. Products are f32 FMAs: a gather must be exact.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int NW = NT / 32;        // warps per CTA
constexpr int CPT = 4;             // columns per thread in gather_sum
constexpr int CH = NT;             // edges staged per pass through shared memory
constexpr float NEG_INF = -1e30f;  // the TPU kernel's floor of a segment's max

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum or max over the CTA, the same order every time; all threads get it.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// out[b, v, c] = scale * sum_{j in [ptr[v], ptr[v+1])} wt(b, perm[j]) * feat[b, gidx[perm[j]], c]
// with wt(b, e) = wt[b * wstride + e], or with SOFTMAX its softmax within
// the segment, which the z == 0 CTA also writes to w_out[b * E + e].
template <bool SOFTMAX>
__global__ void __launch_bounds__(NT)
gather_sum_kernel(const float* __restrict__ feat, const float* __restrict__ wt,
                  long long wstride, const int* __restrict__ gidx,
                  const int* __restrict__ perm, const int* __restrict__ ptr,
                  float* __restrict__ out, float* __restrict__ w_out, int N, int E,
                  int D, float scale) {
  __shared__ float w_s[CH];
  __shared__ int g_s[CH];
  __shared__ float red[NW];
  const int tid = threadIdx.x;
  const int v = blockIdx.x, b = blockIdx.y;
  const int c0 = blockIdx.z * (NT * CPT) + tid;
  const int s0 = ptr[v], s1 = ptr[v + 1];
  const float* wrow = wt + (long long)b * wstride;
  float mx = 0.f, den = 1.f;
  if (SOFTMAX) {
    float m = NEG_INF;
    for (int j = s0 + tid; j < s1; j += NT) m = fmaxf(m, wrow[perm[j]]);
    mx = block_reduce<true>(m, red);
    float s = 0.f;
    for (int j = s0 + tid; j < s1; j += NT) s += expf(wrow[perm[j]] - mx);
    den = block_reduce<false>(s, red);
    if (den == 0.f) den = 1.f;
  }
  float acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0.f;
  const float* fb = feat + (long long)b * N * D;
  for (int j0 = s0; j0 < s1; j0 += CH) {
    const int n = min(CH, s1 - j0);
    __syncthreads();  // the chunk before is consumed
    if (tid < n) {
      const int e = perm[j0 + tid];
      float w = wrow[e];
      if (SOFTMAX) {
        w = expf(w - mx) / den;
        if (blockIdx.z == 0) w_out[(long long)b * E + e] = w;
      }
      w_s[tid] = w;
      g_s[tid] = gidx[e];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float w = w_s[j];
      const float* row = fb + (long long)g_s[j] * D;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = c0 + k * NT;
        if (c < D) acc[k] += w * row[c];
      }
    }
  }
  float* orow = out + ((long long)b * N + v) * D;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = c0 + k * NT;
    if (c < D) orow[c] = scale * acc[k];
  }
}

// dgamma over the dst-CSR, one CTA per (node, sample): a warp per edge for
// the dot product of s_e, kept in dgamma itself; then the segment's sum of
// w * s; then the final value in place. The dot products enter minus the
// segment's first one, and g_w is added to that difference: the weights sum
// to 1 only up to rounding, and a dot product over D can be some hundred
// times larger than the differences that matter, so the uncentred form
// loses about |dot| * 1e-7 (the shift changes nothing in exact arithmetic).
__global__ void __launch_bounds__(NT)
spmm_dgamma_kernel(const float* __restrict__ g_out, const float* __restrict__ x,
                   const float* __restrict__ w, const float* __restrict__ g_w,
                   const int* __restrict__ gidx, const int* __restrict__ perm,
                   const int* __restrict__ ptr, float* dgamma, int N, int E, int D) {
  __shared__ float red[NW];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int v = blockIdx.x, b = blockIdx.y;
  const int s0 = ptr[v], s1 = ptr[v + 1];
  const float* grow = g_out + ((long long)b * N + v) * D;
  const long long eb = (long long)b * E;
  for (int j = s0 + wid; j < s1; j += NW) {
    const int e = perm[j];
    const float* xrow = x + ((long long)b * N + gidx[e]) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += grow[c] * xrow[c];
    s = warp_sum(s);
    if (lane == 0) dgamma[eb + e] = s;
  }
  __syncthreads();
  const float ref = s0 < s1 ? dgamma[eb + perm[s0]] : 0.f;
  float p = 0.f;
  for (int j = s0 + tid; j < s1; j += NT) {
    const int e = perm[j];
    const float s = (dgamma[eb + e] - ref) + (g_w != nullptr ? g_w[eb + e] : 0.f);
    p += w[eb + e] * s;
  }
  const float inner = block_reduce<false>(p, red);  // every read of ref is done
  for (int j = s0 + tid; j < s1; j += NT) {
    const int e = perm[j];
    const float s = (dgamma[eb + e] - ref) + (g_w != nullptr ? g_w[eb + e] : 0.f);
    dgamma[eb + e] = w[eb + e] * (s - inner);
  }
}

// alpha[b, e] = scale * q[b, dst_e] . k[b, src_e], one warp per (sample, edge).
__global__ void __launch_bounds__(NT)
sddmm_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const int* __restrict__ src, const int* __restrict__ dst,
             float* __restrict__ alpha, long long BE, int N, int E, int D,
             float scale) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (item >= BE) return;  // whole warps leave together
  const long long b = item / E;
  const int e = (int)(item - b * E);
  const float* qrow = q + (b * N + dst[e]) * D;
  const float* krow = k + (b * N + src[e]) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += qrow[c] * krow[c];
  s = warp_sum(s);
  if (lane == 0) alpha[item] = scale * s;
}

bool bad_shape(int B, int N, int E, int D) {
  return B <= 0 || B > 65535 || N <= 0 || E <= 0 || D <= 0;
}

dim3 node_grid(int B, int N, int D) {
  return dim3(N, B, (D + NT * CPT - 1) / (NT * CPT));
}

template <bool SOFTMAX>
int launch_gather_sum(const void* feat, const void* wt, long long wstride,
                      const void* gidx, const void* perm, const void* ptr, void* out,
                      void* w_out, int B, int N, int E, int D, float scale,
                      cudaStream_t stream) {
  gather_sum_kernel<SOFTMAX><<<node_grid(B, N, D), NT, 0, stream>>>(
      (const float*)feat, (const float*)wt, wstride, (const int*)gidx,
      (const int*)perm, (const int*)ptr, (float*)out, (float*)w_out, N, E, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// gamma [B, E] with row stride gamma_stride (0 for one row broadcast over the
// batch); gidx [E] the gathered node of each edge; dst_perm/dst_ptr the CSR by
// dst. Writes out [B, N, D] and w [B, E] (the caller's edge order).
extern "C" int rd_spmm_fwd(const void* x, const void* gamma, long long gamma_stride,
                           const void* gidx, const void* dst_perm,
                           const void* dst_ptr, void* out, void* w, int B, int N,
                           int E, int D, void* stream) {
  if (bad_shape(B, N, E, D) || gamma_stride < 0) return (int)cudaErrorInvalidValue;
  return launch_gather_sum<true>(x, gamma, gamma_stride, gidx, dst_perm, dst_ptr, out,
                                 w, B, N, E, D, 1.f, (cudaStream_t)stream);
}

// dgamma (skipped when it is null) over the dst-CSR, then dx over the CSR of
// gidx (idx_perm/idx_ptr). g_w may be null (no cotangent on the weights).
extern "C" int rd_spmm_bwd(const void* g_out, const void* g_w, const void* x,
                           const void* w, const void* gidx, const void* dst,
                           const void* dst_perm, const void* dst_ptr,
                           const void* idx_perm, const void* idx_ptr, void* dx,
                           void* dgamma, int B, int N, int E, int D, void* stream) {
  if (bad_shape(B, N, E, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dgamma != nullptr) {
    spmm_dgamma_kernel<<<dim3(N, B), NT, 0, s>>>(
        (const float*)g_out, (const float*)x, (const float*)w, (const float*)g_w,
        (const int*)gidx, (const int*)dst_perm, (const int*)dst_ptr, (float*)dgamma,
        N, E, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_gather_sum<false>(g_out, w, E, dst, idx_perm, idx_ptr, dx, nullptr, B,
                                  N, E, D, 1.f, s);
}

extern "C" int rd_sddmm_fwd(const void* q, const void* k, const void* src,
                            const void* dst, void* alpha, int B, int N, int E, int D,
                            float scale, void* stream) {
  if (bad_shape(B, N, E, D)) return (int)cudaErrorInvalidValue;
  const long long BE = (long long)B * E;
  const long long blocks = (BE + NW - 1) / NW;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  sddmm_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const int*)src, (const int*)dst,
      (float*)alpha, BE, N, E, D, scale);
  return (int)cudaGetLastError();
}

// dq over the dst-CSR (gathering k at src), dk over the src-CSR (gathering q
// at dst); d_alpha [B, E] contiguous.
extern "C" int rd_sddmm_bwd(const void* d_alpha, const void* q, const void* k,
                            const void* src, const void* dst, const void* dst_perm,
                            const void* dst_ptr, const void* src_perm,
                            const void* src_ptr, void* dq, void* dk, int B, int N,
                            int E, int D, float scale, void* stream) {
  if (bad_shape(B, N, E, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_gather_sum<false>(k, d_alpha, E, src, dst_perm, dst_ptr, dq, nullptr,
                                     B, N, E, D, scale, s);
  if (err != 0) return err;
  return launch_gather_sum<false>(q, d_alpha, E, dst, src_perm, src_ptr, dk, nullptr, B,
                                  N, E, D, scale, s);
}
