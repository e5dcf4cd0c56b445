// Row-block device code of the fused encoder layer's kernels, forward
// (fused_encoder.cu) and backward (fused_encoder_bwd.cu): a matrix product
// of a BR-row block in shared memory against a torch-layout weight in
// global memory with an epilogue per element, and the qkv projection built
// on it, which both directions launch first.
#pragma once

#include "attention.cuh"

namespace rd {

constexpr int BR = 32;      // rows per CTA of the row-local kernels

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
  constexpr int NG = NT / BR;
  const int r = threadIdx.x % BR, g = threadIdx.x / BR;
  const float* a = A + r * lda;
  for (int n0 = 4 * g; n0 < N; n0 += 4 * NG) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < K; ++kk) {
      const float av = opnd<BF>(a[kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n0 + u < N) {
          const float* w = WKN ? W + (long)kk * N + (n0 + u) : W + (long)(n0 + u) * K + kk;
          acc[u] = fmaf(av, opnd<BF>(__ldg(w)), acc[u]);
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

// qkv = rd(x) rd(W_in)^T + b_in for a BR-row block of [B*T, d], rounded to
// the operand type: the first launch of the forward and of the backward.
template <bool BF>
__global__ void __launch_bounds__(NT)
qkv_rows_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
                const float* __restrict__ b_in, float* __restrict__ qkv, long M,
                int d) {
  extern __shared__ float smem[];
  const int DP = d + 1;
  const long row0 = (long)blockIdx.x * BR;
  const long rest = M - row0;
  const int nrows = rest < BR ? (int)rest : BR;
  for (int idx = threadIdx.x; idx < BR * d; idx += NT) {
    const int r = idx / d, c = idx - r * d;
    smem[r * DP + c] = r < nrows ? x[(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();
  row_gemm_br<BF, false>(smem, DP, d, w_in, 3 * d, nrows, [&](int r, int n, float acc) {
    qkv[(row0 + r) * 3 * d + n] = opnd<BF>(acc + b_in[n]);
  });
}

}  // namespace rd
