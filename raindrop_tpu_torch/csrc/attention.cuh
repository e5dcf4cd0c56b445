// Device code shared by the forward kernels: streaming packed-heads
// attention over one 64-row query block, a row-block matrix product
// against a weight in global memory, a row LayerNorm, and the counter
// hash of the dropout masks. Scalar f32 FMA throughout; tensor cores are
// later work.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rd {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BK = 64;    // keys per streamed tile
constexpr int NT = 256;   // threads per CTA: 4 per query row
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round to bf16 and back when the operands are bf16 (the TPU kernels cast
// each matrix-product operand to the operand dtype; accumulation is f32).
template <bool BF>
__device__ __forceinline__ float opnd(float x) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// Dropout keep bits: a counter hash of (seed, bh, row, col), the same
// bits the plain version and the reference draw (xorshift-multiply
// finalizer). `base` folds the seed and bh terms; an element is kept when
// its hash is >= thr = rate * 2^32, and kept values are scaled by inv =
// 1 / (1 - rate).
struct Drop {
  uint32_t base;
  uint32_t thr;
  float inv;
};

__host__ __device__ __forceinline__ uint32_t drop_base(int seed, uint32_t bh) {
  return (uint32_t)seed * 0x9E3779B9u ^ (bh + 1u) * 0x85EBCA6Bu;
}

__device__ __forceinline__ bool keep_bit(const Drop& dr, uint32_t row, uint32_t col) {
  uint32_t x = dr.base ^ row * 0xC2B2AE35u ^ col * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= dr.thr;
}

inline Drop make_drop(double rate) {
  Drop dr;
  dr.base = 0u;
  dr.thr = (uint32_t)(rate * 4294967296.0);
  dr.inv = (float)(1.0 / (1.0 - rate));
  return dr;
}

// Shared floats attend_rows needs for head dim hd.
inline int attn_smem_floats(int hd) { return 3 * BQ * (hd + 1) + BQ * (BK + 1); }

// Attention of query rows q0 .. q0+63 of one (sample, head) against keys
// 0 .. length-1, softmax in base 2 (scale2 = log2(e)/sqrt(hd)).
//   q, k, v: element (t, c) of this head at [t * row_stride + c], c < hd
//   out:     local row r, column c at [r * out_stride + c]  (o = pv / l)
//   lse:     [T] for this (sample, head), base 2
// Thread (r = tid/4, j = tid%4) owns query row r, the keys j, j+4, ... of
// each tile for the scores, and the output columns j, j+4, ... . Keys
// past `length` are never read. A sample with length 0 gives o = 0 and
// lse = NEG_INF, as the TPU kernel does. ROUND_P rounds the
// probabilities to bf16 before the PV product (the TPU kernel's
// p.astype(v.dtype)); the row sum l uses the unrounded values. With DROP
// the PV operand is p * keep / (1 - rate), keyed on (query row, key
// column) under dr.base; l still sums the undropped p.
template <int MAXD, bool ROUND_P, bool DROP, typename TIn>
__device__ void attend_rows(const TIn* __restrict__ q, const TIn* __restrict__ k,
                            const TIn* __restrict__ v, long row_stride, int T,
                            int length, int q0, int hd, float scale2,
                            float* smem, float* out, long out_stride,
                            float* lse, Drop dr) {
  const int tid = threadIdx.x, r = tid >> 2, j = tid & 3;
  const int HP = hd + 1, PP = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * HP;
  float* Vs = Ks + BK * HP;
  float* Ps = Vs + BK * HP;
  const int nrows = min(BQ, T - q0);
  __syncthreads();  // the caller may still read smem from a previous head
  if (length <= 0) {
    for (int idx = tid; idx < nrows * hd; idx += NT) {
      const int rr = idx / hd;
      out[rr * out_stride + (idx - rr * hd)] = 0.f;
    }
    for (int rr = tid; rr < nrows; rr += NT) lse[q0 + rr] = NEG_INF;
    return;
  }
  for (int idx = tid; idx < BQ * hd; idx += NT) {
    const int rr = idx / hd, c = idx - rr * hd;
    Qs[rr * HP + c] = rr < nrows ? to_f(q[(long)(q0 + rr) * row_stride + c]) : 0.f;
  }
  float m = NEG_INF, l = 0.f;
  float acc[MAXD];
#pragma unroll
  for (int i = 0; i < MAXD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < length; k0 += BK) {
    const int nk = min(BK, length - k0);
    __syncthreads();  // previous tile consumed
    for (int idx = tid; idx < BK * hd; idx += NT) {
      const int kk = idx / hd, c = idx - kk * hd;
      const bool ok = kk < nk;
      const long g = (long)(k0 + kk) * row_stride + c;
      Ks[kk * HP + c] = ok ? to_f(k[g]) : 0.f;
      Vs[kk * HP + c] = ok ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
    const float* qr = Qs + r * HP;
    for (int c = 0; c < hd; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) s[i] = fmaf(qv, Ks[(j + 4 * i) * HP + c], s[i]);
    }
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      s[i] *= scale2;
      if (j + 4 * i < nk) tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int kk = j + 4 * i;
      const float p = kk < nk ? exp2f(s[i] - m_new) : 0.f;
      psum += p;
      float pw = p;
      if constexpr (DROP) {
        pw = keep_bit(dr, (uint32_t)(q0 + r), (uint32_t)(k0 + kk)) ? p * dr.inv : 0.f;
      }
      Ps[r * PP + kk] = opnd<ROUND_P>(pw);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // row r's probabilities come from the 4 lanes of its group
#pragma unroll
    for (int i = 0; i < MAXD; ++i) acc[i] *= alpha;
    const float* pr = Ps + r * PP;
    for (int kk = 0; kk < nk; ++kk) {
      const float p = pr[kk];
      const float* vr = Vs + kk * HP;
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        const int c = j + 4 * i;
        if (c < hd) acc[i] = fmaf(p, vr[c], acc[i]);
      }
    }
  }
  if (r < nrows) {
#pragma unroll
    for (int i = 0; i < MAXD; ++i) {
      const int c = j + 4 * i;
      if (c < hd) out[r * out_stride + c] = acc[i] / l;
    }
    if (j == 0) lse[q0 + r] = m + log2f(l);
  }
}

// C[r][n] = resid[r][n] + relu?(sum_k rd(A[r][k]) * rd(W[n][k]) + bias[n])
// for the rows r < nrows of a 64-row block. A lies in shared memory with
// an odd row stride; W is a torch-layout [N, K] weight in global memory
// (it stays in L2 across the grid). Thread t owns row t % 64 and columns
// 4 at a time; the 32 lanes of a warp share their columns, so each weight
// load is one broadcast. resid may be null. With DROP the value is dropped
// (after the bias and relu, before the residual) by the keep bit of
// (drop_row0 + r, n) under dr.
template <bool BF, bool RELU, bool DROP = false>
__device__ void row_gemm(const float* A, int lda, int K,
                         const float* __restrict__ W,
                         const float* __restrict__ bias, int N, float* C,
                         long ldc, const float* resid, long ldr, int nrows,
                         Drop dr = Drop{}, uint32_t drop_row0 = 0) {
  constexpr int NG = NT / BQ;
  const int r = threadIdx.x % BQ, g = threadIdx.x / BQ;
  const float* a = A + r * lda;
  for (int n0 = 4 * g; n0 < N; n0 += 4 * NG) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < K; ++kk) {
      const float av = opnd<BF>(a[kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n0 + u < N) acc[u] = fmaf(av, opnd<BF>(__ldg(W + (long)(n0 + u) * K + kk)), acc[u]);
      }
    }
    if (r < nrows) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + u;
        if (n < N) {
          float y = acc[u] + bias[n];
          if (RELU) y = fmaxf(y, 0.f);
          if constexpr (DROP) {
            y = keep_bit(dr, drop_row0 + (uint32_t)r, (uint32_t)n) ? y * dr.inv : 0.f;
          }
          if (resid != nullptr) y = resid[r * ldr + n] + y;
          C[r * ldc + n] = y;
        }
      }
    }
  }
}

// out[r] = LayerNorm(in[r]) * gamma + beta over d columns (biased
// variance, eps 1e-5), one warp per row. in and out may alias.
__device__ inline void layer_norm_rows(const float* in, long ldi, int d,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       int nrows, float* out, long ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += NT / 32) {
    const float* x = in + r * ldi;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += x[c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / d;
    float vs = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = x[c] - mu;
      vs += t * t;
    }
    for (int o = 16; o > 0; o >>= 1) vs += __shfl_xor_sync(0xffffffffu, vs, o);
    const float rstd = rsqrtf(vs / d + 1e-5f);
    for (int c = lane; c < d; c += 32) out[r * ldo + c] = (x[c] - mu) * rstd * gamma[c] + beta[c];
  }
}

}  // namespace rd

// Instantiate F<MAXD> for the per-thread column count of head dim hd
// (columns j, j+4, ... of hd), up to hd = 128.
#define RD_DISPATCH_HD(hd, ...)                       \
  do {                                                \
    const int rd_nd_ = ((hd) + 3) / 4;                \
    if (rd_nd_ <= 12) {                               \
      constexpr int MAXD = 12;                        \
      __VA_ARGS__;                                    \
    } else if (rd_nd_ <= 20) {                        \
      constexpr int MAXD = 20;                        \
      __VA_ARGS__;                                    \
    } else if (rd_nd_ <= 32) {                        \
      constexpr int MAXD = 32;                        \
      __VA_ARGS__;                                    \
    } else {                                          \
      return (int)cudaErrorInvalidValue;              \
    }                                                 \
  } while (0)
