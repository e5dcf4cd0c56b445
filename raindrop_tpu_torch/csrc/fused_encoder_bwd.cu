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
// operations and bytes weigh about equally. The first kernels ran every
// product in scalar f32 FMA, so FMA and load issue bounded them (at PAM's
// sensor-wise width 104.0 ms against 8.1 for nn.TransformerEncoderLayer's
// backward, dx_rows_kernel alone 79.7 ms a training step), and the
// intermediates below add device-memory traffic on top.
//
// Design: the TPU kernel is one program per sample that keeps the whole
// sample in VMEM and adds its weight gradients into shared outputs across
// a sequential grid. A sample does not fit an SM, blocks run in no order,
// and float atomics would change the sums' order from run to run. So the
// backward is a chain of launches, each with a fixed summation order:
//   A  qkv = x W_in^T + b_in again (as the forward's first launch);
//   B  per block of rows, row-local: recompute x1, the FFN hidden f and
//      both LayerNorms' statistics; LN2 backward, FFN backward, LN1
//      backward, out-projection backward; write the row-wise operands of
//      the weight gradients (x1, f, df2, dfpre, dao), dh1, d_attn and
//      delta = sum_head(d_attn * attn); write per-CTA column sums for the
//      bias and LayerNorm gradients;
//   C  attention backward on the recomputed q, k, v with do = d_attn into
//      dqkv;
//   D  per block of rows: dx = dh1 + dqkv W_in, and the column sums of dqkv;
//   E  weight gradients dW = G^T A over a fixed split of the B*T rows into
//      512-row chunks, one partial per chunk, then one pass that adds the
//      partials (and the per-CTA column sums) in chunk order.
// Two routes, by the wrapper's launch plan (fused_plan.cuh), which the
// entry point checks:
// - tensor cores (bf16, the model's default): the eight packed weights,
//   A, B (64-row tiles, six products), D and E (G^T A with both operands
//   staged transposed into K-major tiles) on wgmma (rows_tc.cuh); C on the
//   tensor-core attention, one warpgroup a CTA up to a padded head dim of
//   144 (attention_tc.cuh, in the units fused_encoder_{dq,dkv}_tc.cu) and
//   two past it (attention_tc_wide.cuh, in fused_encoder_{dq,dkv}_wide.cu),
//   to hd 192, where the route stops;
// - scalar (f32, and bf16 on request): B and D in 32-row blocks (five
//   [32, d] buffers in shared memory, 218,496 bytes at d = 340), C the two
//   kernels of attention_bwd.cuh in the geometry of the head dim (Narrow up
//   to hd 192, Wide to 368), E a 64 x 64 scalar tile; every product scalar
//   FMA. The f32 route keeps these kernels bit for bit;
// - stream (every width the two above do not take; rows_stream.cuh): A, B's
//   six products and D are products of one kernel over rows in device
//   memory (tensor cores in bf16, scalar in f32), B's LayerNorms, dropout
//   sites, relu and delta row kernels, the column sums a column a thread
//   over the 512-row chunks; C the attention of the plan (in bf16 on the
//   tensor cores to hd 368, past it attn_dq_rows_hs and attn_dkv_rows_hs,
//   in fused_encoder_bwd_hds.cu), E as on the other routes.
// No atomics anywhere: two runs give the same bits. The buffers that reach
// device memory between launches are allocated by the wrapper, which lists
// them (ops/fused_encoder.py: bwd_scratch).
#include "fused_plan.cuh"
#include "rows_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rd::BR;
using rd::fused::Plan;
using rd::fused::bwd_rows_floats;
using rd::fused::part_floats;
using rd::qkv_rows_kernel;
using rd::row_gemm_br;

constexpr int WT = 64;      // weight-gradient tile (WT x WT outputs per CTA)
constexpr int WM = 16;      // rows staged per step of the weight gradient
constexpr float LN_EPS = 1e-5f;

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

// Per-CTA column sums (rd::fused::part_floats): [dg2 d][dbe2 d][dbf2 d]
// [dbf1 ffn][dg1 d][dbe1 d][dbo d][dbqkv 3d]; launch B fills the first
// 6d + ffn, launch D the rest. Launch B's shared floats:
// rd::fused::bwd_rows_floats.

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
  // A is read by the out-projection alone (delta reads attn again from
  // device memory), so the FFN hidden takes its place after it: at PAM's
  // sensor-wise width (d=340) a sixth buffer would not fit.
  float* A = smem;             // attn rows
  float* F = A;                // f, then dfpre (after the out-projection)
  float* X = A + BR * max(DP, FP);  // x + ao, then x1, then d_attn
  float* XH1 = X + BR * DP;    // xhat1
  float* H2 = XH1 + BR * DP;   // h2, xhat2, df2, dx1, dh1
  float* G = H2 + BR * DP;     // g, dh2, dao
  float* rs1 = G + BR * DP;
  float* rs2 = rs1 + BR;
  const long row0 = (long)b * T + q0;
  float* part = partials + ((long)b * gridDim.x + blockIdx.x) * part_floats(d, ffn);
  dr.base = rd::drop_base(seed, dr.row(b));
  const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
  const uint32_t r101 = 101u * t8 + q0, r102 = 102u * t8 + q0, r103 = 103u * t8 + q0;
  auto keep = [&](uint32_t row_base, int r, int n) -> float {
    if constexpr (DROP) {
      return rd::keep_bit(dr, row_base + (uint32_t)r, (uint32_t)n) ? dr.inv : 0.f;
    } else {
      return 1.f;
    }
  };

  for (int idx = threadIdx.x; idx < bwd_rows_floats(d, ffn); idx += rd::NT) {
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
    const float* a = attn + (row0 + r) * d;
    for (int c = h * hd; c < (h + 1) * hd; ++c) s += X[r * DP + c] * a[c];
    delta[((long)b * nhead + h) * T + q0 + r] = s;
  }
}

// Launch C: the attention backward on qkv [B, T, 3d] with do = d_attn, in
// the geometry G of the head dim (attention.cuh).
template <int MAXD, typename G, bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lengths, float* __restrict__ dqkv, int T,
                int d, int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attn_dq_rows<MAXD, BF, DROP, float, G>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d,
      lse + stat, delta + stat, T, length, q0, hd, scale * 1.4426950408889634f,
      scale, dr, smem, dqkv + (long)b * T * 3 * d + h * hd, 3 * d);
}

template <int MAXD, typename G, bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, float* __restrict__ dqkv, int T,
                 int d, int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  float* out = dqkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attn_dkv_rows<MAXD, BF, DROP, float, G>(
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

// ----------------------------------------------------- tensor-core route
// Launches B, D and E on wgmma (rows_tc.cuh), bf16 operands: the same
// chain and the same fixed summation orders (column sums over a tile's
// rows in index order, weight-gradient partials over 512-row chunks added
// in chunk order), 64-row tiles. What a product alone reads (x1, f, df2,
// dfpre, dao, d_attn) reaches device memory in bf16, each value already
// rounded to it; what a sum reads unrounded stays f32 (dh1, delta, dqkv,
// h1 = x + the attention projection, whose LN1 statistics the row kernel
// recomputes xhat1 from).

// Mean and 1/std of rows r < nrows of the f32 [64, d] buffer H (one warp a
// row), the arithmetic of ln_fwd_rows.
__device__ void ln_stats_tc(const float* H, int d, int nrows, float* mu, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += rd::rows::NTH / 32) {
    const float* h = H + r * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += h[c];
    const float m = warp_sum(s) / d;
    float vs = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = h[c] - m;
      vs += t * t;
    }
    const float rstd = rsqrtf(warp_sum(vs) / d + LN_EPS);
    if (lane == 0) {
      mu[r] = m;
      rs[r] = rstd;
    }
  }
}

// Launch B on the tensor cores: the row-local recompute and backward of one
// (64 rows, sample). Shared memory (rows_tc.cuh bwd_rows_smem): H f32 [64,
// d] holds h1, x1, h2, dh2, dx1, dh1, d_attn in turn; At the d-wide bf16
// operand (attn, x1, df2, dao); Ft the FFN's (f, then dfpre); P f32 dfpre
// for its column sums. h1 goes to device memory (h1buf) for LN1's
// backward: a second [64, d] f32 buffer would not fit at d = 340.
template <bool DROP>
__global__ void __launch_bounds__(rd::rows::NTH)
layer_bwd_rows_tc(const float* __restrict__ x, const float* __restrict__ attn,
                  const float* __restrict__ g, const bf16* __restrict__ wo_f,
                  const float* __restrict__ bo, const float* __restrict__ g1,
                  const float* __restrict__ be1, const bf16* __restrict__ w1_f,
                  const float* __restrict__ bf1, const bf16* __restrict__ w2_f,
                  const float* __restrict__ bf2, const float* __restrict__ g2,
                  const bf16* __restrict__ w2_t, const bf16* __restrict__ w1_t,
                  const bf16* __restrict__ wo_t, float* h1buf, bf16* __restrict__ x1buf,
                  bf16* __restrict__ fbuf, bf16* __restrict__ df2buf,
                  bf16* __restrict__ dfprebuf, bf16* __restrict__ daobuf,
                  bf16* __restrict__ dattnbuf, float* __restrict__ dh1buf,
                  float* __restrict__ delta, float* __restrict__ partials, int T, int d,
                  int ffn, int nhead, int seed, rd::Drop dr) {
  using namespace rd::rows;
  extern __shared__ __align__(128) uint8_t smem_rows[];
  const int q0 = blockIdx.x * R, b = blockIdx.y;
  const int nrows = min(R, T - q0);
  const int KPd = pad64(d), KPf = pad64(ffn);
  float* H = reinterpret_cast<float*>(smem_rows);
  uint8_t* At = smem_rows + f32_rows_bytes(d);
  uint8_t* Ft = At + tile_bytes(d);
  float* P = reinterpret_cast<float*>(Ft + tile_bytes(ffn));
  uint8_t* ring = reinterpret_cast<uint8_t*>(P) + f32_rows_bytes(ffn);
  float* mu1 = reinterpret_cast<float*>(ring + RING_BYTES);
  float* rs1 = mu1 + R;
  float* mu2 = rs1 + R;
  float* rs2 = mu2 + R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row0 = (long)b * T + q0;
  const float* xr = x + row0 * d;
  const float* ar = attn + row0 * d;
  const float* gr = g + row0 * d;
  float* h1r = h1buf + row0 * d;
  float* part = partials + ((long)b * gridDim.x + blockIdx.x) * part_floats(d, ffn);
  dr.base = rd::drop_base(seed, dr.row(b));
  const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
  const uint32_t r101 = 101u * t8 + q0, r102 = 102u * t8 + q0, r103 = 103u * t8 + q0;
  auto keep = [&](uint32_t row_base, int r, int n) -> float {
    if constexpr (DROP) {
      return rd::keep_bit(dr, row_base + (uint32_t)r, (uint32_t)n) ? dr.inv : 0.f;
    } else {
      return 1.f;
    }
  };

  zero_smem(Ft, tile_bytes(ffn));  // rows past nrows stay zero throughout
  stage_rows(At, ar, d, nrows, d, KPd);
  // ---- recompute the forward's row-local part ----
  rows_tc(At, KPd, wo_f, d, nrows, ring, [&](int r, int n, float acc) {
    H[r * d + n] = xr[(long)r * d + n] + (acc + bo[n]) * keep(r101, r, n);
  });
  ln_stats_tc(H, d, nrows, mu1, rs1);
  __syncthreads();
  for (int r = warp; r < nrows; r += NTH / 32) {  // h1 out, x1 in: H, At, x1buf
    for (int c = lane; c < d; c += 32) {
      const float h = H[r * d + c];
      h1r[(long)r * d + c] = h;
      const float y = (h - mu1[r]) * rs1[r] * g1[c] + be1[c];
      H[r * d + c] = y;
      put(At, r, c, y);
      x1buf[(row0 + r) * d + c] = __float2bfloat16(y);
    }
  }
  __syncthreads();
  rows_tc(At, KPd, w1_f, ffn, nrows, ring, [&](int r, int n, float acc) {
    const bf16 y = __float2bfloat16(fmaxf(acc + bf1[n], 0.f) * keep(r102, r, n));
    *reinterpret_cast<bf16*>(Ft + rd::tc::tile_off(r, n)) = y;
    fbuf[(row0 + r) * ffn + n] = y;
  });

  rows_tc(Ft, KPf, w2_f, d, nrows, ring, [&](int r, int n, float acc) {
    H[r * d + n] += (acc + bf2[n]) * keep(r103, r, n);  // h2 = x1 + ...
  });
  ln_stats_tc(H, d, nrows, mu2, rs2);
  __syncthreads();

  // ---- backward ----
  for (int c = tid; c < d; c += NTH) {  // dg2 = sum g * xhat2, dbe2 = sum g
    float s1 = 0.f, s2 = 0.f;
    for (int r0 = 0; r0 < nrows; r0 += 16) {  // sixteen rows' loads, then their sums
      float gv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) gv[i] = r0 + i < nrows ? gr[(long)(r0 + i) * d + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = r0 + i;
        if (r < nrows) {
          s1 += gv[i] * ((H[r * d + c] - mu2[r]) * rs2[r]);
          s2 += gv[i];
        }
      }
    }
    part[c] = s1;
    part[d + c] = s2;
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += NTH / 32) {  // H <- dh2
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = gr[(long)r * d + c] * g2[c];
      s1 += dxh;
      s2 += dxh * ((H[r * d + c] - mu2[r]) * rs2[r]);
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float xh = (H[r * d + c] - mu2[r]) * rs2[r];
      H[r * d + c] = (gr[(long)r * d + c] * g2[c] - m1 - xh * m2) * rs2[r];
    }
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += NTH / 32) {  // df2 = dh2 * keep3 -> At, df2buf
    for (int c = lane; c < d; c += 32) {
      const float v = H[r * d + c] * keep(r103, r, c);
      put(At, r, c, v);
      df2buf[(row0 + r) * d + c] = __float2bfloat16(v);
    }
  }
  for (int c = tid; c < d; c += NTH) {  // dbf2
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += H[r * d + c] * keep(r103, r, c);
    part[2 * d + c] = s;
  }
  __syncthreads();
  // dfpre = (df2 W2) * keep2 * (f_pre > 0); f > 0 exactly where the mask
  // kept the value and f_pre > 0
  rows_tc(At, KPd, w2_t, ffn, nrows, ring, [&](int r, int n, float acc) {
    const float v = get(Ft, r, n) > 0.f ? (DROP ? acc * dr.inv : acc) : 0.f;
    P[r * ffn + n] = v;
    const bf16 vb = __float2bfloat16(v);
    *reinterpret_cast<bf16*>(Ft + rd::tc::tile_off(r, n)) = vb;
    dfprebuf[(row0 + r) * ffn + n] = vb;
  });
  for (int c = tid; c < ffn; c += NTH) {  // dbf1
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += P[r * ffn + c];
    part[3 * d + c] = s;
  }
  rows_tc(Ft, KPf, w1_t, d, nrows, ring, [&](int r, int n, float acc) {
    H[r * d + n] += acc;  // dx1 = dh2 + dfpre W1
  });
  for (int c = tid; c < d; c += NTH) {  // dg1 = sum dx1 * xhat1, dbe1 = sum dx1
    float s1 = 0.f, s2 = 0.f;
    for (int r0 = 0; r0 < nrows; r0 += 16) {  // sixteen rows' loads, then their sums
      float hv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) hv[i] = r0 + i < nrows ? h1r[(long)(r0 + i) * d + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = r0 + i;
        if (r < nrows) {
          const float v = H[r * d + c];
          s1 += v * ((hv[i] - mu1[r]) * rs1[r]);
          s2 += v;
        }
      }
    }
    part[3 * d + ffn + c] = s1;
    part[4 * d + ffn + c] = s2;
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += NTH / 32) {  // H <- dh1
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = H[r * d + c] * g1[c];
      s1 += dxh;
      s2 += dxh * ((h1r[(long)r * d + c] - mu1[r]) * rs1[r]);
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float xh = (h1r[(long)r * d + c] - mu1[r]) * rs1[r];
      H[r * d + c] = (H[r * d + c] * g1[c] - m1 - xh * m2) * rs1[r];
    }
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += NTH / 32) {  // dh1 out; dao = dh1 * keep1
    for (int c = lane; c < d; c += 32) {
      const float v = H[r * d + c];
      dh1buf[(row0 + r) * d + c] = v;
      const float a = v * keep(r101, r, c);
      put(At, r, c, a);
      daobuf[(row0 + r) * d + c] = __float2bfloat16(a);
    }
  }
  for (int c = tid; c < d; c += NTH) {  // dbo
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += H[r * d + c] * keep(r101, r, c);
    part[5 * d + ffn + c] = s;
  }
  __syncthreads();
  rows_tc(At, KPd, wo_t, d, nrows, ring, [&](int r, int n, float acc) {
    H[r * d + n] = acc;  // d_attn = dao Wo
    dattnbuf[(row0 + r) * d + n] = __float2bfloat16(acc);
  });
  const int hd = d / nhead;
  for (int idx = tid; idx < nrows * nhead; idx += NTH) {
    const int r = idx / nhead, h = idx - r * nhead;
    float s = 0.f;
    for (int c = h * hd; c < (h + 1) * hd; ++c) s += H[r * d + c] * ar[(long)r * d + c];
    delta[((long)b * nhead + h) * T + q0 + r] = s;
  }
}

// Launch D on the tensor cores: dx = dh1 + rd(dqkv) rd(W_in) for one (64
// rows, sample), and the column sums of the unrounded dqkv (a thread a
// column, rows in index order, sixteen rows' loads issued before their
// use) as the tile is staged; dx leaves through the staged chunk, a warp a
// row.
__global__ void __launch_bounds__(rd::rows::NTH)
dx_rows_tc(const float* __restrict__ dqkv, const float* __restrict__ dh1,
           const bf16* __restrict__ w_in_t, float* __restrict__ dx,
           float* __restrict__ partials, int T, int d, int ffn) {
  using namespace rd::rows;
  extern __shared__ __align__(128) uint8_t smem_rows[];
  const int q0 = blockIdx.x * R, b = blockIdx.y;
  const int nrows = min(R, T - q0);
  const int N3 = 3 * d, KP = pad64(N3);
  uint8_t* A = smem_rows;
  uint8_t* ring = A + tile_bytes(N3);
  float* stage = reinterpret_cast<float*>(ring + RING_BYTES);
  const long row0 = (long)b * T + q0;
  float* part = partials + ((long)b * gridDim.x + blockIdx.x) * part_floats(d, ffn)
                + 6 * d + ffn;
  const float* src = dqkv + row0 * N3;
  for (int c = threadIdx.x; c < KP; c += NTH) {
    float s = 0.f;
    for (int r0 = 0; r0 < R; r0 += 16) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i] = (r0 + i < nrows && c < N3) ? src[(long)(r0 + i) * N3 + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s += v[i];
        put(A, r0 + i, c, v[i]);
      }
    }
    if (c < N3) part[c] = s;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  rows_tc<true>(A, KP, w_in_t, d, nrows, ring, [&](int c0, int n) {
    for (int r = warp; r < nrows; r += NTH / 32) {
      const long o = (row0 + r) * d + c0;
      for (int j = lane; j < n; j += 32) dx[o + j] = dh1[o + j] + stage[r * SST + j];
    }
  }, stage);
}

// Launch E1 on the tensor cores: part[s][n][k] = sum over the rows m of
// chunk s of rd(G[m][n]) rd(A[m][k]); one warpgroup per (64 n, 64 k,
// chunk) (a 64 x 128 tile for two warpgroups, the G strip read once for
// both, measured slower: fewer loads in flight a thread). Each 64-row step stages G^T and A^T as K-major tiles (the rows m
// are the products' K), the next step's while the current one's wgmma
// runs.
template <typename TG, typename TA>
__global__ void __launch_bounds__(rd::rows::WG)
wgrad_tc(const TG* __restrict__ G, int ldg, const TA* __restrict__ A, int lda, long M,
         int N, int K, int chunk, float* __restrict__ part) {
  using namespace rd::rows;
  __shared__ __align__(128) uint8_t buf[2][2][R * KC * 2];
  const int n0 = blockIdx.x * R, k0 = blockIdx.y * R;
  const long m_begin = (long)blockIdx.z * chunk;
  const long m_end = m_begin + chunk < M ? m_begin + chunk : M;
  const int steps = (int)((m_end - m_begin + KC - 1) / KC);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  // element (i, m) of each tile: rows i of 64 n (or k), m a pair of rows
  // a thread's 16 (i, m pair) elements of each tile, eight at a time: the
  // loads of eight issued before their stores
  auto stage = [&](int s, uint8_t* gt, uint8_t* at) {
    const long m0 = m_begin + (long)s * KC;
    constexpr int U = 8;
    for (int base = tid; base < R * (KC / 2); base += U * WG) {
      float g0[U], g1[U], a0[U], a1[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * WG;
        const int i = idx & (R - 1), mp = 2 * (idx >> 6);
        const long m = m0 + mp;
        const bool ok0 = m < m_end, ok1 = m + 1 < m_end;
        g0[u] = g1[u] = a0[u] = a1[u] = 0.f;
        if (n0 + i < N) {
          if (ok0) g0[u] = rd::to_f(G[m * ldg + n0 + i]);
          if (ok1) g1[u] = rd::to_f(G[(m + 1) * ldg + n0 + i]);
        }
        if (k0 + i < K) {
          if (ok0) a0[u] = rd::to_f(A[m * lda + k0 + i]);
          if (ok1) a1[u] = rd::to_f(A[(m + 1) * lda + k0 + i]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * WG;
        const int i = idx & (R - 1), mp = 2 * (idx >> 6);
        *reinterpret_cast<uint32_t*>(gt + rd::tc::tile_off(i, mp)) =
            rd::tc::pack_bf16(g0[u], g1[u]);
        *reinterpret_cast<uint32_t*>(at + rd::tc::tile_off(i, mp)) =
            rd::tc::pack_bf16(a0[u], a1[u]);
      }
    }
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  stage(0, buf[0][0], buf[0][1]);
  for (int s = 0; s < steps; ++s) {
    rd::tc::proxy_fence();
    __syncthreads();  // step s staged by every thread; step s - 1's wgmma done
    const uint32_t ga = rd::tc::smem_addr(buf[s & 1][0]), aa = rd::tc::smem_addr(buf[s & 1][1]);
    rd::tc::reg_fence(acc);
    rd::tc::mma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      rd::tc::mma_ss_n64(acc, rd::tc::desc_k(ga, kk), rd::tc::desc_k(aa, kk), 1);
    }
    rd::tc::mma_commit();
    if (s + 1 < steps) stage(s + 1, buf[(s + 1) & 1][0], buf[(s + 1) & 1][1]);
    rd::tc::mma_wait();
    rd::tc::reg_fence(acc);
  }
  float* dst = part + (long)blockIdx.z * N * K;
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int n = n0 + 16 * w + g + 8 * ((x >> 1) & 1);
    const int k = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
    if (n < N && k < K) dst[(long)n * K + k] = acc[x];
  }
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
  // bf16 on the tensor-core route: qkv, x1, f, df2, dfpre, dao, dattn
  float *qkv, *x1, *f, *df2, *dfpre, *dao, *dattn, *dh1, *dqkv, *delta, *rowpart,
      *wpart, *h1;
  bf16* wpack;
  // the "stream" route's: xhat1, xhat2, 1/std of both LayerNorms ([2, M]),
  // dh2, dx1, d_attn in bf16 (where its attention runs on the tensor cores)
  float *xhat1, *xhat2, *rstd, *dh2, *dx1;
  bf16* dattn_op;
  float *dx, *dw_in, *dwo, *dw1, *dw2, *vec;
  int B, T, d, ffn, nhead, seed, chunk, bf;  // bf: bf16 operands
  float scale;
  double rate;
  rd::Origin org;
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

template <typename TG, typename TA>
int weight_grad_tc(const Args& a, const rd::fused::Launch& l, const TG* G, int ldg, int N,
                   const TA* A, int lda, int K, float* out) {
  const long M = (long)a.B * a.T;
  const int S = (int)((M + a.chunk - 1) / a.chunk);
  dim3 grid((N + l.rows - 1) / l.rows, (K + l.rows - 1) / l.rows, S);
  wgrad_tc<TG, TA><<<grid, l.threads, 0, a.stream>>>(G, ldg, A, lda, M, N, K, a.chunk,
                                                     a.wpart);
  RD_TRY(cudaGetLastError());
  const int n = N * K;
  reduce_kernel<<<(n + rd::NT - 1) / rd::NT, rd::NT, 0, a.stream>>>(
      a.wpart, S, (long)n, n, out);
  return (int)cudaGetLastError();
}

// Launch C on the scalar kernels in the geometry of the head dim (up to hd
// 368), on f32 qkv and d_attn.
template <bool BF, bool DROP>
int attn_bwd_scalar(const Args& a, const Plan& p) {
  using namespace rd::fused;
  RD_DISPATCH_GEOM(a.d / a.nhead, {
    auto kq = fused_dq_kernel<MAXD, G, BF, DROP>;
    auto kkv = fused_dkv_kernel<MAXD, G, BF, DROP>;
    RD_TRY(allow_smem(kq, p.l[ATTN_DQ].smem));
    RD_TRY(allow_smem(kkv, p.l[ATTN_DKV].smem));
    dim3 blocks((a.T + G::ROWS - 1) / G::ROWS, a.nhead, a.B);
    kq<<<blocks, rd::NT, p.l[ATTN_DQ].smem, a.stream>>>(a.qkv, a.dattn, a.lse, a.delta,
                                                        a.lengths, a.dqkv, a.T, a.d,
                                                        a.nhead, a.scale, a.seed, a.dr);
    RD_TRY(cudaGetLastError());
    kkv<<<blocks, rd::NT, p.l[ATTN_DKV].smem, a.stream>>>(a.qkv, a.dattn, a.lse, a.delta,
                                                          a.lengths, a.dqkv, a.T, a.d,
                                                          a.nhead, a.scale, a.seed, a.dr);
    return (int)cudaGetLastError();
  });
}

// The scalar route: launches A-E of PRs 2-7, shared bytes from the plan.
template <bool BF, bool DROP>
int launch(const Args& a, const Plan& p) {
  using namespace rd::fused;
  const int d = a.d, ffn = a.ffn, T = a.T, B = a.B;
  const long M = (long)B * T;
  const int bytes_a = p.l[QKV].smem, bytes_b = p.l[BWD_ROWS].smem, bytes_d = p.l[DX].smem;
  auto ka = qkv_rows_kernel<BF>;
  auto kb = layer_bwd_rows_kernel<BF, DROP>;
  auto kd = dx_rows_kernel<BF>;
  RD_TRY(allow_smem(ka, bytes_a));
  RD_TRY(allow_smem(kb, bytes_b));
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
  int err = attn_bwd_scalar<BF, DROP>(a, p);
  if (err) return err;
  kd<<<rows, rd::NT, bytes_d, a.stream>>>(a.dqkv, a.dh1, a.w_in, a.dx, a.rowpart,
                                          T, d, ffn);
  RD_TRY(cudaGetLastError());

  err = weight_grad<BF>(a, a.dqkv, 3 * d, 3 * d, a.x, d, d, a.dw_in);
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

// The tensor-core route: pack the eight weights, then A-E.
template <bool DROP>
int launch_tc(const Args& a, const Plan& p) {
  using namespace rd::fused;
  const int d = a.d, ffn = a.ffn, T = a.T, B = a.B;
  const long M = (long)B * T;
  const Packed pk = packed_layout(d, ffn);
  const float* w[NPACK] = {a.w_in, a.wo, a.w1, a.w2, a.w2, a.w1, a.wo, a.w_in};
  RD_TRY(pack_weights(pack_jobs(pk, w, NPACK), a.wpack, a.stream));
  const bf16* wp = a.wpack;
  bf16* qkv = reinterpret_cast<bf16*>(a.qkv);
  bf16* dattn = reinterpret_cast<bf16*>(a.dattn);

  const Launch& la = p.l[QKV];
  RD_TRY(allow_smem(qkv_rows_tc_kernel, la.smem));
  qkv_rows_tc_kernel<<<(unsigned)((M + la.rows - 1) / la.rows), la.threads, la.smem,
                       a.stream>>>(a.x, wp + pk.off[P_IN], a.b_in, qkv, M, d);
  RD_TRY(cudaGetLastError());

  const Launch& lb = p.l[BWD_ROWS];
  auto kb = layer_bwd_rows_tc<DROP>;
  RD_TRY(allow_smem(kb, lb.smem));
  const dim3 rows((T + lb.rows - 1) / lb.rows, B);
  kb<<<rows, lb.threads, lb.smem, a.stream>>>(
      a.x, a.attn, a.g, wp + pk.off[P_WO], a.bo, a.g1, a.be1, wp + pk.off[P_W1], a.bf1,
      wp + pk.off[P_W2], a.bf2, a.g2, wp + pk.off[P_W2T], wp + pk.off[P_W1T],
      wp + pk.off[P_WOT], a.h1, reinterpret_cast<bf16*>(a.x1), reinterpret_cast<bf16*>(a.f),
      reinterpret_cast<bf16*>(a.df2), reinterpret_cast<bf16*>(a.dfpre),
      reinterpret_cast<bf16*>(a.dao), dattn, a.dh1, a.delta, a.rowpart, T, d, ffn, a.nhead,
      a.seed, a.dr);
  RD_TRY(cudaGetLastError());

  const bool one_wg = p.l[ATTN_DQ].route == 1;
  int err = (one_wg ? launch_dq_tc : launch_dq_wide)(qkv, dattn, a.lse, a.delta, a.lengths,
                                                     a.dqkv, p.l[ATTN_DQ], B, T, d, a.nhead,
                                                     a.scale, a.seed, a.rate, a.org, a.stream);
  if (err) return err;
  err = (one_wg ? launch_dkv_tc : launch_dkv_wide)(qkv, dattn, a.lse, a.delta, a.lengths,
                                                   a.dqkv, p.l[ATTN_DKV], B, T, d, a.nhead,
                                                   a.scale, a.seed, a.rate, a.org, a.stream);
  if (err) return err;

  const Launch& ld = p.l[DX];
  RD_TRY(allow_smem(dx_rows_tc, ld.smem));
  dx_rows_tc<<<dim3((T + ld.rows - 1) / ld.rows, B), ld.threads, ld.smem, a.stream>>>(
      a.dqkv, a.dh1, wp + pk.off[P_INT], a.dx, a.rowpart, T, d, ffn);
  RD_TRY(cudaGetLastError());

  const Launch& le = p.l[WGRAD];
  const bf16* dao = reinterpret_cast<const bf16*>(a.dao);
  const bf16* dfpre = reinterpret_cast<const bf16*>(a.dfpre);
  const bf16* df2 = reinterpret_cast<const bf16*>(a.df2);
  const bf16* x1 = reinterpret_cast<const bf16*>(a.x1);
  const bf16* f = reinterpret_cast<const bf16*>(a.f);
  err = weight_grad_tc(a, le, (const float*)a.dqkv, 3 * d, 3 * d, a.x, d, d, a.dw_in);
  if (err) return err;
  err = weight_grad_tc(a, le, dao, d, d, a.attn, d, d, a.dwo);
  if (err) return err;
  err = weight_grad_tc(a, le, dfpre, ffn, ffn, x1, d, d, a.dw1);
  if (err) return err;
  err = weight_grad_tc(a, le, df2, d, d, f, ffn, ffn, a.dw2);
  if (err) return err;
  const int nv = part_floats(d, ffn);
  const int nparts = (int)rows.x * B;
  reduce_kernel<<<(nv + rd::NT - 1) / rd::NT, rd::NT, 0, a.stream>>>(
      a.rowpart, nparts, (long)nv, nv, a.vec);
  return (int)cudaGetLastError();
}

// vec[off ..] = the column sums of P (* Q) [M, n] over every row: partials
// over the 512-row chunks into the weight-gradient partials' buffer, added
// in chunk order.
int col_sum(const Args& a, const float* P, const float* Q, int n, int off) {
  const long M = (long)a.B * a.T;
  const int S = (int)((M + a.chunk - 1) / a.chunk);
  stream_col_sums<<<dim3((n + rd::NT - 1) / rd::NT, S), rd::NT, 0, a.stream>>>(
      P, Q, n, M, a.chunk, a.wpart);
  RD_TRY(cudaGetLastError());
  reduce_kernel<<<(n + rd::NT - 1) / rd::NT, rd::NT, 0, a.stream>>>(a.wpart, S, (long)n, n,
                                                                     a.vec + off);
  return (int)cudaGetLastError();
}

// The "stream" route: the eight weights packed (bf16: the products on the
// tensor cores; f32 reads them as given), then A, B's recompute and
// backward, C, D, E and the column sums, in the order of the plain
// backward (ops/fused_encoder.py _fused_bwd_plain).
template <bool DROP>
int launch_stream(const Args& a, const Plan& p) {
  using namespace rd::fused;
  const int d = a.d, ffn = a.ffn, T = a.T, B = a.B, bf = a.bf;
  const long M = (long)B * T;
  const Packed pk = packed_layout(d, ffn);
  const float* w[NPACK] = {a.w_in, a.wo, a.w1, a.w2, a.w2, a.w1, a.wo, a.w_in};
  if (bf) RD_TRY(pack_weights(pack_jobs(pk, w, NPACK), a.wpack, a.stream));
  // out [M, N] = A [M, K] times the weight of `slot` (+ bias) (+ add); the
  // backward's slots read their weight transposed
  auto prod = [&](const float* A, int K, int slot, int N, const float* bias, const float* add,
                  void* out, int out_bf16, int round) {
    return stream_product(A, M, K, bf ? a.wpack + pk.off[slot] : nullptr, w[slot],
                          slot >= P_W2T, N, bias, add, out, out_bf16, round, a.stream);
  };
  const Launch& lq = p.l[ATTN_DQ];
  const bool attn_tc = lq.route == R_TC || lq.route == R_TC_WIDE || lq.route == R_TC_CLUSTER;
  const dim3 rows = stream_row_grid(M);
  float* rstd1 = a.rstd;
  float* rstd2 = a.rstd + M;
  const int sd = a.seed;
  // A: qkv; the forward's row-local part: ao (in dh1) -> x1, xhat1; the FFN
  // hidden f; f2 (in dh2) -> xhat2
  RD_TRY(prod(a.x, d, P_IN, 3 * d, a.b_in, nullptr, a.qkv, attn_tc, bf && !attn_tc));
  RD_TRY(prod(a.attn, d, P_WO, d, a.bo, nullptr, a.dh1, 0, 0));
  stream_ln_rows<DROP><<<rows, rd::NT, 0, a.stream>>>(a.x, a.dh1, 101u, a.g1, a.be1, a.x1,
                                                      a.xhat1, rstd1, M, T, d, sd, a.dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(a.x1, d, P_W1, ffn, a.bf1, nullptr, a.f, 0, 0));
  stream_relu<DROP><<<stream_elem_grid(M * ffn), rd::NT, 0, a.stream>>>(
      a.f, nullptr, M * ffn, ffn, T, sd, a.dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(a.f, ffn, P_W2, d, a.bf2, nullptr, a.dh2, 0, 0));
  stream_ln_rows<DROP><<<rows, rd::NT, 0, a.stream>>>(a.x1, a.dh2, 103u, nullptr, nullptr,
                                                      nullptr, a.xhat2, rstd2, M, T, d, sd,
                                                      a.dr);
  RD_TRY(cudaGetLastError());
  // B: LN2 backward -> dh2, df2; df = df2 W2 -> dfpre; dx1 = dh2 + dfpre W1;
  // LN1 backward -> dh1, dao; d_attn = dao Wo; delta
  stream_ln_bwd_rows<DROP><<<rows, rd::NT, 0, a.stream>>>(a.g, a.xhat2, rstd2, a.g2, 103u,
                                                          a.dh2, a.df2, M, T, d, sd, a.dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(a.df2, d, P_W2T, ffn, nullptr, nullptr, a.dfpre, 0, 0));
  stream_relu<DROP><<<stream_elem_grid(M * ffn), rd::NT, 0, a.stream>>>(
      a.dfpre, a.f, M * ffn, ffn, T, sd, a.dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(a.dfpre, ffn, P_W1T, d, nullptr, a.dh2, a.dx1, 0, 0));
  stream_ln_bwd_rows<DROP><<<rows, rd::NT, 0, a.stream>>>(a.dx1, a.xhat1, rstd1, a.g1, 101u,
                                                          a.dh1, a.dao, M, T, d, sd, a.dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(a.dao, d, P_WOT, d, nullptr, nullptr, a.dattn, 0, 0));
  stream_delta_rows<<<rows, rd::NT, 0, a.stream>>>(a.dattn, a.attn, a.delta,
                                                   attn_tc ? a.dattn_op : nullptr, M, T, d,
                                                   a.nhead);
  RD_TRY(cudaGetLastError());
  // C
  int err;
  if (lq.route == R_TC_CLUSTER) {
    err = launch_dq_tcc(a.qkv, a.dattn_op, a.lse, a.delta, a.lengths, a.dqkv, lq, B, T, d,
                        a.nhead, a.scale, a.seed, a.rate, a.org, a.stream);
    if (err) return err;
    err = launch_dkv_tcc(a.qkv, a.dattn_op, a.lse, a.delta, a.lengths, a.dqkv, p.l[ATTN_DKV],
                         B, T, d, a.nhead, a.scale, a.seed, a.rate, a.org, a.stream);
  } else if (attn_tc) {
    const bool one_wg = lq.route == R_TC;
    bf16* qkv = reinterpret_cast<bf16*>(a.qkv);
    err = (one_wg ? launch_dq_tc : launch_dq_wide)(qkv, a.dattn_op, a.lse, a.delta, a.lengths,
                                                   a.dqkv, lq, B, T, d, a.nhead, a.scale,
                                                   a.seed, a.rate, a.org, a.stream);
    if (err) return err;
    err = (one_wg ? launch_dkv_tc : launch_dkv_wide)(qkv, a.dattn_op, a.lse, a.delta,
                                                     a.lengths, a.dqkv, p.l[ATTN_DKV], B, T, d,
                                                     a.nhead, a.scale, a.seed, a.rate, a.org,
                                                     a.stream);
  } else if (lq.route == R_HD_STREAM) {
    err = launch_dq_hds(a.qkv, a.dattn, a.lse, a.delta, a.lengths, a.dqkv, lq, B, T, d,
                        a.nhead, a.scale, bf, a.seed, a.rate, a.org, a.stream);
    if (err) return err;
    err = launch_dkv_hds(a.qkv, a.dattn, a.lse, a.delta, a.lengths, a.dqkv, p.l[ATTN_DKV], B,
                         T, d, a.nhead, a.scale, bf, a.seed, a.rate, a.org, a.stream);
  } else {
    err = (bf ? attn_bwd_scalar<true, DROP> : attn_bwd_scalar<false, DROP>)(a, p);
  }
  if (err) return err;
  // D: dx = dh1 + dqkv W_in
  RD_TRY(prod(a.dqkv, 3 * d, P_INT, d, nullptr, a.dh1, a.dx, 0, 0));
  // E: the weight gradients, then the bias and LayerNorm gradients
  const Launch& le = p.l[WGRAD];
  const float* ga[4][2] = {{a.dqkv, a.x}, {a.dao, a.attn}, {a.dfpre, a.x1}, {a.df2, a.f}};
  const int gn[4][2] = {{3 * d, d}, {d, d}, {ffn, d}, {d, ffn}};
  float* gout[4] = {a.dw_in, a.dwo, a.dw1, a.dw2};
  for (int i = 0; i < 4; ++i) {
    const int N = gn[i][0], K = gn[i][1];
    err = bf ? weight_grad_tc(a, le, ga[i][0], N, N, ga[i][1], K, K, gout[i])
             : weight_grad<false>(a, ga[i][0], N, N, ga[i][1], K, K, gout[i]);
    if (err) return err;
  }
  // [dg2 d][dbe2 d][dbf2 d][dbf1 ffn][dg1 d][dbe1 d][dbo d][db_in 3d]
  const struct { const float *P, *Q; int n, off; } sums[] = {
      {a.g, a.xhat2, d, 0}, {a.g, nullptr, d, d}, {a.df2, nullptr, d, 2 * d},
      {a.dfpre, nullptr, ffn, 3 * d}, {a.dx1, a.xhat1, d, 3 * d + ffn},
      {a.dx1, nullptr, d, 4 * d + ffn}, {a.dao, nullptr, d, 5 * d + ffn},
      {a.dqkv, nullptr, 3 * d, 6 * d + ffn}};
  for (const auto& c : sums) {
    err = col_sum(a, c.P, c.Q, c.n, c.off);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// Pointers: x, the 12 weights (in_proj_w, in_proj_b, out_proj w, b, ln1
// scale, bias, lin1 w, b, lin2 w, b, ln2 scale, bias), lengths, attn, lse,
// g; 20 scratch buffers (qkv, x1, f, df2, dfpre, dao, d_attn, dh1, dqkv,
// delta, row partials, weight-gradient partials, h1, the packed weights;
// h1 on the tensor-core route only, which keeps the first seven in bf16;
// the packed weights on it and on the "stream" route in bf16; then the
// "stream" route's xhat1, xhat2, rstd, dh2, dx1 and bf16 d_attn, Args
// says which); outputs dx, dw_in, dwo, dw1, dw2 and vec = [dg2, dbe2, dbf2,
// dbf1, dg1, dbe1, dbo, db_in]. scale = 1/sqrt(hd); chunk = rows per
// weight-gradient partial; plan: the wrapper's PLAN_INTS ints.
extern "C" int rd_fused_layer_bwd(
    const void* x, const void* w_in, const void* b_in, const void* wo,
    const void* bo, const void* g1, const void* be1, const void* w1,
    const void* bf1, const void* w2, const void* bf2, const void* g2,
    const void* be2, const void* lengths, const void* attn, const void* lse,
    const void* g, void* qkv, void* x1, void* f, void* df2, void* dfpre,
    void* dao, void* dattn, void* dh1, void* dqkv, void* delta, void* rowpart,
    void* wpart, void* h1, void* wpack, void* xhat1, void* xhat2, void* rstd, void* dh2,
    void* dx1, void* dattn_op, void* dx, void* dw_in, void* dwo, void* dw1,
    void* dw2, void* vec, int B, int T, int d, int ffn, int nhead, int chunk, float scale,
    int bf16, int seed, double rate, int b0, int h0, int heads, const int* plan,
    void* stream) {
  (void)be2;  // LN2's bias has no part in any gradient but its own
  const rd::Origin org{b0, h0, heads};
  if (B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 ||
      d % nhead != 0 || ffn <= 0 || chunk <= 0 || !(rate >= 0.0 && rate < 1.0) ||
      rd::bad_origin(org, B, nhead))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const bool stream_route = plan[0] == rd::fused::R_STREAM;
  if (!rd::fused::check_plan(plan, d, ffn, nhead, bf16,
                             {qkv, stream_route ? dattn_op : dattn}, &p))
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
  a.rowpart = (float*)rowpart; a.wpart = (float*)wpart; a.h1 = (float*)h1;
  a.wpack = (__nv_bfloat16*)wpack;
  a.xhat1 = (float*)xhat1; a.xhat2 = (float*)xhat2; a.rstd = (float*)rstd;
  a.dh2 = (float*)dh2; a.dx1 = (float*)dx1; a.dattn_op = (__nv_bfloat16*)dattn_op;
  a.dx = (float*)dx; a.dw_in = (float*)dw_in; a.dwo = (float*)dwo;
  a.dw1 = (float*)dw1; a.dw2 = (float*)dw2; a.vec = (float*)vec;
  a.B = B; a.T = T; a.d = d; a.ffn = ffn; a.nhead = nhead; a.seed = seed;
  a.chunk = chunk; a.scale = scale; a.rate = rate; a.org = org; a.bf = bf16;
  a.dr = rd::make_drop(rate, org);
  a.stream = (cudaStream_t)stream;
  if (stream_route) {
    const int ar = p.l[rd::fused::ATTN_DQ].route;
    const bool attn_tc = ar == rd::fused::R_TC || ar == rd::fused::R_TC_WIDE ||
                         ar == rd::fused::R_TC_CLUSTER;
    for (const void* ptr : {xhat1, xhat2, rstd, dh2, dx1, x1, f, df2, dfpre, dao, dattn, dh1,
                            dqkv, delta, wpart, qkv}) {
      if (ptr == nullptr) return (int)cudaErrorInvalidValue;
    }
    if ((bf16 && wpack == nullptr) || (attn_tc && dattn_op == nullptr))
      return (int)cudaErrorInvalidValue;
    return rate > 0.0 ? launch_stream<true>(a, p) : launch_stream<false>(a, p);
  }
  if (p.l[rd::fused::QKV].route == 1) {
    return rate > 0.0 ? launch_tc<true>(a, p) : launch_tc<false>(a, p);
  }
  if (rate > 0.0) return bf16 ? launch<true, true>(a, p) : launch<false, true>(a, p);
  return bf16 ? launch<true, false>(a, p) : launch<false, false>(a, p);
}
