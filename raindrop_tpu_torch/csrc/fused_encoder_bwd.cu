// Post-LN transformer encoder layer backward: the Hopper counterpart of
// raindrop_tpu/ops/fused_encoder.py:_bwd_kernel (:183).
//
// From x, the saved attention output attn and its base-2 lse, and the
// incoming gradient g, it recomputes the forward (every dropout mask is
// regenerated from the counter hash) and gives dx [B, T, d] and the
// gradients of the 12 weights, summed over all B*T rows, in torch layout.
//
// What bounds it: per sample about 2.5x the forward's operations (every
// forward product has two backward products, the attention five against
// two, plus the recompute) against x, attn, g, dx and lse; on tensor cores
// operations and bytes would weigh about equally. These first kernels run
// every product in scalar f32 FMA, so the FMA and load throughput bound
// them, and the intermediates below add device-memory traffic on top.
//
// Design: the TPU kernel is one program per sample that keeps the whole
// sample in VMEM and adds its weight gradients into shared outputs across
// a sequential grid. A sample does not fit an SM, blocks run in no order,
// and float atomics would change the sums' order from run to run. So the
// backward is a chain of launches, each with a fixed summation order:
//   A  qkv = x W_in^T + b_in again (as the forward's first launch);
//   B  per 32-row block, row-local: recompute x1, the FFN hidden f and
//      both LayerNorms' statistics; LN2 backward, FFN backward, LN1
//      backward, out-projection backward; write the row-wise operands of
//      the weight gradients (x1, f, df2, dfpre, dao), dh1, d_attn and
//      delta = sum_head(d_attn * attn); write per-CTA column sums for the
//      bias and LayerNorm gradients;
//   C  attention backward on the recomputed q, k, v with do = d_attn (the
//      two kernels of attention_bwd.cuh) into dqkv;
//   D  per 32-row block: dx = dh1 + dqkv W_in, and the column sums of dqkv;
//   E  weight gradients dW = G^T A over a fixed split of the B*T rows into
//      512-row chunks, one partial per chunk, then one pass that adds the
//      partials (and the per-CTA column sums) in chunk order.
// No atomics anywhere: two runs give the same bits. The buffers that reach
// device memory between launches are allocated by the wrapper, which lists
// their sizes (ops/fused_encoder.py: bwd_scratch_floats).
#include "attention_bwd.cuh"

namespace {

constexpr int BR = 32;      // rows per CTA of the row-local kernels
constexpr int WT = 64;      // weight-gradient tile (WT x WT outputs per CTA)
constexpr int WM = 16;      // rows staged per step of the weight gradient
constexpr float LN_EPS = 1e-5f;

// epi(r, n, sum_k rd(A[r][k]) * rd(w(n, k))) for the rows r < nrows of a
// BR-row block in shared memory. WKN = false: W is [N, K] (y = a W^T, a
// forward product); WKN = true: W is [K, N] (y = a W, the backward product
// through the same torch-layout weight). Thread t owns row t % BR and
// columns 4 at a time; the lanes of a warp share their columns, so a
// weight load is one broadcast.
template <bool BF, bool WKN, typename Epi>
__device__ __forceinline__ void row_gemm_br(const float* A, int lda, int K,
                                            const float* __restrict__ W, int N,
                                            int nrows, Epi epi) {
  constexpr int NG = rd::NT / BR;
  const int r = threadIdx.x % BR, g = threadIdx.x / BR;
  const float* a = A + r * lda;
  for (int n0 = 4 * g; n0 < N; n0 += 4 * NG) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < K; ++kk) {
      const float av = rd::opnd<BF>(a[kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n0 + u < N) {
          const float* w = WKN ? W + (long)kk * N + (n0 + u) : W + (long)(n0 + u) * K + kk;
          acc[u] = fmaf(av, rd::opnd<BF>(__ldg(w)), acc[u]);
        }
      }
    }
    if (r < nrows) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n0 + u < N) epi(r, n0 + u, acc[u]);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// In place y = LN(h) * gamma + beta on H (when gamma is given; else H
// becomes xhat), xhat into XH (may alias H), 1/std into rs. One warp per row.
__device__ void ln_fwd_rows(float* H, float* XH, float* rs, int ld, int d,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, int nrows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += rd::NT / 32) {
    float* h = H + r * ld;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += h[c];
    const float mu = warp_sum(s) / d;
    float vs = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = h[c] - mu;
      vs += t * t;
    }
    const float rstd = rsqrtf(warp_sum(vs) / d + LN_EPS);
    for (int c = lane; c < d; c += 32) {
      const float xh = (h[c] - mu) * rstd;
      XH[r * ld + c] = xh;
      if (gamma != nullptr) h[c] = xh * gamma[c] + beta[c];
    }
    if (lane == 0) rs[r] = rstd;
  }
}

// In place G <- dL/dh of y = xhat * gamma + beta, given G = dL/dy.
__device__ void ln_bwd_rows(float* G, const float* XH, const float* rs, int ld,
                            int d, const float* __restrict__ gamma, int nrows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += rd::NT / 32) {
    float* g = G + r * ld;
    const float* xh = XH + r * ld;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = g[c] * gamma[c];
      s1 += dxh;
      s2 += dxh * xh[c];
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    const float rstd = rs[r];
    for (int c = lane; c < d; c += 32) {
      g[c] = (g[c] * gamma[c] - m1 - xh[c] * m2) * rstd;
    }
  }
}

// dst[c] = sum over the block's rows of P[r][c] (* Q[r][c] when Q is
// given), rows in index order: a fixed order.
__device__ void col_sums(float* __restrict__ dst, const float* P, const float* Q,
                         int ld, int ncols, int nrows) {
  for (int c = threadIdx.x; c < ncols; c += rd::NT) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) {
      s += Q != nullptr ? P[r * ld + c] * Q[r * ld + c] : P[r * ld + c];
    }
    dst[c] = s;
  }
}

// Launch A: qkv = rd(x) rd(W_in)^T + b_in, rounded to the operand type.
template <bool BF>
__global__ void __launch_bounds__(rd::NT)
qkv_rows_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
                const float* __restrict__ b_in, float* __restrict__ qkv, long M,
                int d) {
  extern __shared__ float smem[];
  const int DP = d + 1;
  const long row0 = (long)blockIdx.x * BR;
  const long rest = M - row0;
  const int nrows = rest < BR ? (int)rest : BR;
  for (int idx = threadIdx.x; idx < BR * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    smem[r * DP + c] = r < nrows ? x[(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();
  row_gemm_br<BF, false>(smem, DP, d, w_in, 3 * d, nrows, [&](int r, int n, float acc) {
    qkv[(row0 + r) * 3 * d + n] = rd::opnd<BF>(acc + b_in[n]);
  });
}

// Per-CTA column sums: [dg2 d][dbe2 d][dbf2 d][dbf1 ffn][dg1 d][dbe1 d]
// [dbo d][dbqkv 3d]; launch B fills the first 6d + ffn, launch D the rest.
__host__ __device__ inline int part_floats(int d, int ffn) { return 9 * d + ffn; }

// Launch B: the row-local recompute and backward of one 32-row block.
template <bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
layer_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ attn,
                      const float* __restrict__ g, const float* __restrict__ wo,
                      const float* __restrict__ bo, const float* __restrict__ g1,
                      const float* __restrict__ be1, const float* __restrict__ w1,
                      const float* __restrict__ bf1, const float* __restrict__ w2,
                      const float* __restrict__ bf2, const float* __restrict__ g2,
                      float* __restrict__ x1buf, float* __restrict__ fbuf,
                      float* __restrict__ df2buf, float* __restrict__ dfprebuf,
                      float* __restrict__ daobuf, float* __restrict__ dattnbuf,
                      float* __restrict__ dh1buf, float* __restrict__ delta,
                      float* __restrict__ partials, int T, int d, int ffn,
                      int nhead, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BR, b = blockIdx.y;
  const int nrows = min(BR, T - q0);
  const int DP = d + 1, FP = ffn + 1;
  float* A = smem;             // attn rows
  float* X = A + BR * DP;      // x + ao, then x1, then d_attn
  float* XH1 = X + BR * DP;    // xhat1
  float* H2 = XH1 + BR * DP;   // h2, xhat2, df2, dx1, dh1
  float* G = H2 + BR * DP;     // g, dh2, dao
  float* F = G + BR * DP;      // f, then dfpre
  float* rs1 = F + BR * FP;
  float* rs2 = rs1 + BR;
  const long row0 = (long)b * T + q0;
  float* part = partials + ((long)b * gridDim.x + blockIdx.x) * part_floats(d, ffn);
  dr.base = rd::drop_base(seed, (uint32_t)b);
  const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
  const uint32_t r101 = 101u * t8 + q0, r102 = 102u * t8 + q0, r103 = 103u * t8 + q0;
  auto keep = [&](uint32_t row_base, int r, int n) -> float {
    if constexpr (DROP) {
      return rd::keep_bit(dr, row_base + (uint32_t)r, (uint32_t)n) ? dr.inv : 0.f;
    } else {
      return 1.f;
    }
  };

  for (int idx = threadIdx.x; idx < 5 * BR * DP + BR * FP + 2 * BR; idx += rd::NT) {
    smem[idx] = 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    A[r * DP + c] = attn[(row0 + r) * d + c];
    G[r * DP + c] = g[(row0 + r) * d + c];
  }
  __syncthreads();

  // ---- recompute the forward's row-local part ----
  row_gemm_br<BF, false>(A, DP, d, wo, d, nrows, [&](int r, int n, float acc) {
    X[r * DP + n] = x[(row0 + r) * d + n] + (acc + bo[n]) * keep(r101, r, n);
  });
  __syncthreads();
  ln_fwd_rows(X, XH1, rs1, DP, d, g1, be1, nrows);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    x1buf[(row0 + r) * d + c] = X[r * DP + c];
  }
  row_gemm_br<BF, false>(X, DP, d, w1, ffn, nrows, [&](int r, int n, float acc) {
    const float y = fmaxf(acc + bf1[n], 0.f) * keep(r102, r, n);
    F[r * FP + n] = y;
    fbuf[(row0 + r) * ffn + n] = y;
  });
  __syncthreads();
  row_gemm_br<BF, false>(F, FP, ffn, w2, d, nrows, [&](int r, int n, float acc) {
    H2[r * DP + n] = X[r * DP + n] + (acc + bf2[n]) * keep(r103, r, n);
  });
  __syncthreads();
  ln_fwd_rows(H2, H2, rs2, DP, d, nullptr, nullptr, nrows);  // H2 = xhat2
  __syncthreads();

  // ---- backward ----
  col_sums(part, G, H2, DP, d, nrows);                 // dg2 = sum g * xhat2
  col_sums(part + d, G, nullptr, DP, d, nrows);        // dbe2 = sum g
  __syncthreads();
  ln_bwd_rows(G, H2, rs2, DP, d, g2, nrows);           // G = dh2
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    const float v = G[r * DP + c] * keep(r103, r, c);  // df2
    H2[r * DP + c] = v;
    df2buf[(row0 + r) * d + c] = v;
  }
  __syncthreads();
  col_sums(part + 2 * d, H2, nullptr, DP, d, nrows);   // dbf2
  // dfpre = (df2 W2) * keep3 * (f_pre > 0); f > 0 exactly where the mask
  // kept the value and f_pre > 0
  row_gemm_br<BF, true>(H2, DP, d, w2, ffn, nrows, [&](int r, int n, float acc) {
    const float v = F[r * FP + n] > 0.f ? (DROP ? acc * dr.inv : acc) : 0.f;
    F[r * FP + n] = v;
    dfprebuf[(row0 + r) * ffn + n] = v;
  });
  __syncthreads();
  col_sums(part + 3 * d, F, nullptr, FP, ffn, nrows);  // dbf1
  row_gemm_br<BF, true>(F, FP, ffn, w1, d, nrows, [&](int r, int n, float acc) {
    H2[r * DP + n] = G[r * DP + n] + acc;              // dx1 = dh2 + dfpre W1
  });
  __syncthreads();
  col_sums(part + 3 * d + ffn, H2, XH1, DP, d, nrows);      // dg1
  col_sums(part + 4 * d + ffn, H2, nullptr, DP, d, nrows);  // dbe1
  __syncthreads();
  ln_bwd_rows(H2, XH1, rs1, DP, d, g1, nrows);         // H2 = dh1
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    const float dh1 = H2[r * DP + c];
    const float dao = dh1 * keep(r101, r, c);
    dh1buf[(row0 + r) * d + c] = dh1;
    daobuf[(row0 + r) * d + c] = dao;
    G[r * DP + c] = dao;
  }
  __syncthreads();
  col_sums(part + 5 * d + ffn, G, nullptr, DP, d, nrows);   // dbo
  row_gemm_br<BF, true>(G, DP, d, wo, d, nrows, [&](int r, int n, float acc) {
    X[r * DP + n] = acc;                               // d_attn = dao Wo
    dattnbuf[(row0 + r) * d + n] = acc;
  });
  __syncthreads();
  const int hd = d / nhead;
  for (int idx = threadIdx.x; idx < nrows * nhead; idx += rd::NT) {
    const int r = idx / nhead, h = idx - r * nhead;
    float s = 0.f;
    for (int c = h * hd; c < (h + 1) * hd; ++c) s += X[r * DP + c] * A[r * DP + c];
    delta[((long)b * nhead + h) * T + q0 + r] = s;
  }
}

// Launch C: the attention backward on qkv [B, T, 3d] with do = d_attn.
template <int MAXD, bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lengths, float* __restrict__ dqkv, int T,
                int d, int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::attn_dq_rows<MAXD, BF, DROP, float>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d,
      lse + stat, delta + stat, T, length, q0, hd, scale * 1.4426950408889634f,
      scale, dr, smem, dqkv + (long)b * T * 3 * d + h * hd, 3 * d);
}

template <int MAXD, bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, float* __restrict__ dqkv, int T,
                 int d, int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  float* out = dqkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::attn_dkv_rows<MAXD, BF, DROP, float>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d,
      lse + stat, delta + stat, T, length, k0, hd, scale * 1.4426950408889634f,
      scale, dr, smem, out + d, out + 2 * d, 3 * d);
}

// Launch D: dx = dh1 + rd(dqkv) rd(W_in), and the column sums of dqkv.
template <bool BF>
__global__ void __launch_bounds__(rd::NT)
dx_rows_kernel(const float* __restrict__ dqkv, const float* __restrict__ dh1,
               const float* __restrict__ w_in, float* __restrict__ dx,
               float* __restrict__ partials, int T, int d, int ffn) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BR, b = blockIdx.y;
  const int nrows = min(BR, T - q0);
  const int N3 = 3 * d, QP = 3 * d + 1;
  const long row0 = (long)b * T + q0;
  float* part = partials + ((long)b * gridDim.x + blockIdx.x) * part_floats(d, ffn)
                + 6 * d + ffn;
  for (int idx = threadIdx.x; idx < BR * N3; idx += rd::NT) {
    const int r = idx / N3, c = idx - r * N3;
    smem[r * QP + c] = r < nrows ? dqkv[(row0 + r) * N3 + c] : 0.f;
  }
  __syncthreads();
  col_sums(part, smem, nullptr, QP, N3, nrows);        // dbq, dbk, dbv
  row_gemm_br<BF, true>(smem, QP, N3, w_in, d, nrows, [&](int r, int n, float acc) {
    dx[(row0 + r) * d + n] = dh1[(row0 + r) * d + n] + acc;
  });
}

// Launch E1: part[s][n][k] = sum over the rows m of chunk s of
// rd(G[m][n]) * rd(A[m][k]); one CTA per (64 n, 64 k, chunk).
template <bool BF>
__global__ void __launch_bounds__(rd::NT)
wgrad_kernel(const float* __restrict__ G, int ldg, const float* __restrict__ A,
             int lda, long M, int N, int K, int chunk, float* __restrict__ part) {
  __shared__ __align__(16) float Gs[WM][WT];
  __shared__ __align__(16) float As[WM][WT];
  const int n0 = blockIdx.x * WT, k0 = blockIdx.y * WT;
  const int tn = threadIdx.x / 16, tk = threadIdx.x % 16;
  const long m_begin = (long)blockIdx.z * chunk;
  const long m_end = m_begin + chunk < M ? m_begin + chunk : M;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;
  for (long m0 = m_begin; m0 < m_end; m0 += WM) {
#pragma unroll
    for (int it = 0; it < WM * WT / rd::NT; ++it) {
      const int idx = threadIdx.x + it * rd::NT;
      const int mm = idx / WT, cc = idx % WT;
      const long m = m0 + mm;
      const bool ok = m < m_end;
      Gs[mm][cc] = ok && n0 + cc < N ? rd::opnd<BF>(G[m * ldg + n0 + cc]) : 0.f;
      As[mm][cc] = ok && k0 + cc < K ? rd::opnd<BF>(A[m * lda + k0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < WM; ++mm) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[mm][tn * 4]);
      const float4 av = *reinterpret_cast<const float4*>(&As[mm][tk * 4]);
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(g4[u], a4[w], acc[u][w]);
    }
    __syncthreads();
  }
  float* dst = part + (long)blockIdx.z * N * K;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = n0 + tn * 4 + u;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int k = k0 + tk * 4 + w;
      if (n < N && k < K) dst[(long)n * K + k] = acc[u][w];
    }
  }
}

// Launch E2: out[i] = sum_s part[s * stride + i], s in index order.
__global__ void __launch_bounds__(rd::NT)
reduce_kernel(const float* __restrict__ part, int S, long stride, int n,
              float* __restrict__ out) {
  const int i = blockIdx.x * rd::NT + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(long)k * stride + i];
  out[i] = s;
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > rd::MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const float *x, *w_in, *b_in, *wo, *bo, *g1, *be1, *w1, *bf1, *w2, *bf2, *g2;
  const int* lengths;
  const float *attn, *lse, *g;
  float *qkv, *x1, *f, *df2, *dfpre, *dao, *dattn, *dh1, *dqkv, *delta, *rowpart,
      *wpart;
  float *dx, *dw_in, *dwo, *dw1, *dw2, *vec;
  int B, T, d, ffn, nhead, seed, chunk;
  float scale;
  rd::Drop dr;
  cudaStream_t stream;
};

#define RD_TRY(expr)                          \
  do {                                        \
    cudaError_t rd_e_ = (expr);               \
    if (rd_e_ != cudaSuccess) return (int)rd_e_; \
  } while (0)

template <bool BF>
int weight_grad(const Args& a, const float* G, int ldg, int N, const float* A,
                int lda, int K, float* out) {
  const long M = (long)a.B * a.T;
  const int S = (int)((M + a.chunk - 1) / a.chunk);
  dim3 grid((N + WT - 1) / WT, (K + WT - 1) / WT, S);
  wgrad_kernel<BF><<<grid, rd::NT, 0, a.stream>>>(G, ldg, A, lda, M, N, K, a.chunk,
                                                  a.wpart);
  RD_TRY(cudaGetLastError());
  const int n = N * K;
  reduce_kernel<<<(n + rd::NT - 1) / rd::NT, rd::NT, 0, a.stream>>>(
      a.wpart, S, (long)n, n, out);
  return (int)cudaGetLastError();
}

template <int MAXD, bool BF, bool DROP>
int launch(const Args& a) {
  const int d = a.d, ffn = a.ffn, T = a.T, B = a.B, hd = a.d / a.nhead;
  const long M = (long)B * T;
  const int bytes_a = BR * (d + 1) * (int)sizeof(float);
  const int bytes_b = (5 * BR * (d + 1) + BR * (ffn + 1) + 2 * BR) * (int)sizeof(float);
  const int bytes_q = rd::attn_dq_smem_floats(hd) * (int)sizeof(float);
  const int bytes_kv = rd::attn_dkv_smem_floats(hd) * (int)sizeof(float);
  const int bytes_d = BR * (3 * d + 1) * (int)sizeof(float);
  auto ka = qkv_rows_kernel<BF>;
  auto kb = layer_bwd_rows_kernel<BF, DROP>;
  auto kq = fused_dq_kernel<MAXD, BF, DROP>;
  auto kkv = fused_dkv_kernel<MAXD, BF, DROP>;
  auto kd = dx_rows_kernel<BF>;
  RD_TRY(allow_smem(ka, bytes_a));
  RD_TRY(allow_smem(kb, bytes_b));
  RD_TRY(allow_smem(kq, bytes_q));
  RD_TRY(allow_smem(kkv, bytes_kv));
  RD_TRY(allow_smem(kd, bytes_d));

  ka<<<(unsigned)((M + BR - 1) / BR), rd::NT, bytes_a, a.stream>>>(
      a.x, a.w_in, a.b_in, a.qkv, M, d);
  RD_TRY(cudaGetLastError());
  dim3 rows((T + BR - 1) / BR, B);
  kb<<<rows, rd::NT, bytes_b, a.stream>>>(
      a.x, a.attn, a.g, a.wo, a.bo, a.g1, a.be1, a.w1, a.bf1, a.w2, a.bf2, a.g2,
      a.x1, a.f, a.df2, a.dfpre, a.dao, a.dattn, a.dh1, a.delta, a.rowpart, T, d,
      ffn, a.nhead, a.seed, a.dr);
  RD_TRY(cudaGetLastError());
  dim3 blocks((T + rd::BQ - 1) / rd::BQ, a.nhead, B);
  kq<<<blocks, rd::NT, bytes_q, a.stream>>>(a.qkv, a.dattn, a.lse, a.delta,
                                            a.lengths, a.dqkv, T, d, a.nhead,
                                            a.scale, a.seed, a.dr);
  RD_TRY(cudaGetLastError());
  kkv<<<blocks, rd::NT, bytes_kv, a.stream>>>(a.qkv, a.dattn, a.lse, a.delta,
                                              a.lengths, a.dqkv, T, d, a.nhead,
                                              a.scale, a.seed, a.dr);
  RD_TRY(cudaGetLastError());
  kd<<<rows, rd::NT, bytes_d, a.stream>>>(a.dqkv, a.dh1, a.w_in, a.dx, a.rowpart,
                                          T, d, ffn);
  RD_TRY(cudaGetLastError());

  int err = weight_grad<BF>(a, a.dqkv, 3 * d, 3 * d, a.x, d, d, a.dw_in);
  if (err) return err;
  err = weight_grad<BF>(a, a.dao, d, d, a.attn, d, d, a.dwo);
  if (err) return err;
  err = weight_grad<BF>(a, a.dfpre, ffn, ffn, a.x1, d, d, a.dw1);
  if (err) return err;
  err = weight_grad<BF>(a, a.df2, d, d, a.f, ffn, ffn, a.dw2);
  if (err) return err;
  const int nv = part_floats(d, ffn);
  const int nparts = (int)rows.x * B;
  reduce_kernel<<<(nv + rd::NT - 1) / rd::NT, rd::NT, 0, a.stream>>>(
      a.rowpart, nparts, (long)nv, nv, a.vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: x, the 12 weights (in_proj_w, in_proj_b, out_proj w, b, ln1
// scale, bias, lin1 w, b, lin2 w, b, ln2 scale, bias), lengths, attn, lse,
// g; 12 scratch buffers (qkv, x1, f, df2, dfpre, dao, d_attn, dh1, dqkv,
// delta, row partials, weight-gradient partials); outputs dx, dw_in, dwo,
// dw1, dw2 and vec = [dg2, dbe2, dbf2, dbf1, dg1, dbe1, dbo, db_in].
// scale = 1/sqrt(hd); chunk = rows per weight-gradient partial.
extern "C" int rd_fused_layer_bwd(
    const void* x, const void* w_in, const void* b_in, const void* wo,
    const void* bo, const void* g1, const void* be1, const void* w1,
    const void* bf1, const void* w2, const void* bf2, const void* g2,
    const void* be2, const void* lengths, const void* attn, const void* lse,
    const void* g, void* qkv, void* x1, void* f, void* df2, void* dfpre,
    void* dao, void* dattn, void* dh1, void* dqkv, void* delta, void* rowpart,
    void* wpart, void* dx, void* dw_in, void* dwo, void* dw1, void* dw2,
    void* vec, int B, int T, int d, int ffn, int nhead, int chunk, float scale,
    int bf16, int seed, double rate, void* stream) {
  (void)be2;  // LN2's bias has no part in any gradient but its own
  if (B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 ||
      d % nhead != 0 || ffn <= 0 || chunk <= 0 || !(rate >= 0.0 && rate < 1.0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x; a.w_in = (const float*)w_in; a.b_in = (const float*)b_in;
  a.wo = (const float*)wo; a.bo = (const float*)bo; a.g1 = (const float*)g1;
  a.be1 = (const float*)be1; a.w1 = (const float*)w1; a.bf1 = (const float*)bf1;
  a.w2 = (const float*)w2; a.bf2 = (const float*)bf2; a.g2 = (const float*)g2;
  a.lengths = (const int*)lengths; a.attn = (const float*)attn;
  a.lse = (const float*)lse; a.g = (const float*)g;
  a.qkv = (float*)qkv; a.x1 = (float*)x1; a.f = (float*)f; a.df2 = (float*)df2;
  a.dfpre = (float*)dfpre; a.dao = (float*)dao; a.dattn = (float*)dattn;
  a.dh1 = (float*)dh1; a.dqkv = (float*)dqkv; a.delta = (float*)delta;
  a.rowpart = (float*)rowpart; a.wpart = (float*)wpart;
  a.dx = (float*)dx; a.dw_in = (float*)dw_in; a.dwo = (float*)dwo;
  a.dw1 = (float*)dw1; a.dw2 = (float*)dw2; a.vec = (float*)vec;
  a.B = B; a.T = T; a.d = d; a.ffn = ffn; a.nhead = nhead; a.seed = seed;
  a.chunk = chunk; a.scale = scale; a.dr = rd::make_drop(rate);
  a.stream = (cudaStream_t)stream;
  RD_DISPATCH_HD(d / nhead, {
    if (rate > 0.0) {
      return bf16 ? launch<MAXD, true, true>(a) : launch<MAXD, false, true>(a);
    }
    return bf16 ? launch<MAXD, true, false>(a) : launch<MAXD, false, false>(a);
  });
}
