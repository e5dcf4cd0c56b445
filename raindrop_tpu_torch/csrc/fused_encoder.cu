// Post-LN transformer encoder layer forward: the Hopper counterpart of
// raindrop_tpu/ops/fused_encoder.py:_fwd_kernel (:131).
//
//   attn = MHA(x)                          (packed heads, base-2 softmax)
//   x1   = LN1(x + attn Wo^T + bo)
//   out  = LN2(x1 + W2 relu(W1 x1 + b1) + b2)
//
// x [B, T, d] f32, torch-layout weights (in_proj_w [3d, d], out_proj
// [d, d], lin1 [ffn, d], lin2 [d, ffn]) f32, lengths [B] int32 ->
// out, attn [B, T, d] f32, lse [B, nhead, T] f32 (base 2).
//
// What bounds it: at PAM (T=600, d=84, ffn=136) a sample needs about
// 182 MFLOP against 3 * T * d * 4 bytes of x, out and attn, about
// 300 FLOP/byte: at the bf16 ridge, so on tensor cores the operations
// and the bytes weigh about equally. This first kernel runs every
// product in scalar f32 FMA, so the FMA and load issue rates bound it.
//
// Design: the TPU kernel keeps a whole sample (x, q, k, v, the [T, T]
// scores and every weight) in one core's VMEM; at PAM that is over
// 400 KB, past an SM's 227 KB. So the layer takes two launches:
//   A  qkv = x W_in^T + b_in for 64-row blocks of [B*T, d] -> [B*T, 3d]
//      in device memory (the one intermediate that reaches it);
//   B  one CTA per (64 query rows, sample) streams that sample's K/V with
//      the same online-softmax code as the packed attention kernel, then
//      runs the out-projection, residual, LN1, FFN with relu, residual and
//      LN2 on its own rows, which are row-local. Scores, probabilities,
//      x1 and the FFN hidden stay in shared memory.
// Weights are read from global memory by every CTA; they stay in L2.
// No atomics, no score in device memory. With bf16 operands every product
// operand is rounded to bf16 (q, k, v after their bias, as the TPU kernel
// casts them), accumulation stays f32.
#include "attention.cuh"

namespace {

template <bool BF>
__global__ void __launch_bounds__(rd::NT)
qkv_proj_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
                const float* __restrict__ b_in, float* __restrict__ qkv,
                long M, int d) {
  extern __shared__ float smem[];
  const int DP = d + 1, N = 3 * d, CP = 3 * d + 1;
  float* Xs = smem;
  float* Cs = Xs + rd::BQ * DP;
  const long row0 = (long)blockIdx.x * rd::BQ;
  const long rest = M - row0;
  const int nrows = rest < rd::BQ ? (int)rest : rd::BQ;
  for (int idx = threadIdx.x; idx < rd::BQ * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    Xs[r * DP + c] = r < nrows ? x[(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();
  rd::row_gemm<BF, false>(Xs, DP, d, w_in, b_in, N, Cs, CP, nullptr, 0, nrows);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * N; idx += rd::NT) {
    const int r = idx / N, c = idx - r * N;
    qkv[(row0 + r) * N + c] = rd::opnd<BF>(Cs[r * CP + c]);
  }
}

template <int MAXD, bool BF>
__global__ void __launch_bounds__(rd::NT)
layer_rows_kernel(const float* __restrict__ x, const float* __restrict__ qkv,
                  const int* __restrict__ lengths, const float* __restrict__ wo,
                  const float* __restrict__ bo, const float* __restrict__ g1,
                  const float* __restrict__ be1, const float* __restrict__ w1,
                  const float* __restrict__ bf1, const float* __restrict__ w2,
                  const float* __restrict__ bf2, const float* __restrict__ g2,
                  const float* __restrict__ be2, float* __restrict__ out,
                  float* __restrict__ attn, float* __restrict__ lse, int T,
                  int d, int ffn, int nhead, float scale2) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, b = blockIdx.y;
  const int nrows = min(rd::BQ, T - q0);
  const int hd = d / nhead, DP = d + 1, FP = ffn + 1;
  float* As = smem;             // attention rows, later x1 + FFN
  float* Xs = As + rd::BQ * DP; // x + attention projection, then x1
  float* U = Xs + rd::BQ * DP;  // attention scratch, then the FFN hidden
  const int length = min(max(lengths[b], 0), T);
  const long row0 = (long)b * T + q0;

  const float* qs = qkv + (long)b * T * 3 * d;
  for (int h = 0; h < nhead; ++h) {
    const float* qh = qs + h * hd;
    rd::attend_rows<MAXD, BF, float>(qh, qh + d, qh + 2 * d, 3 * d, T, length,
                                     q0, hd, scale2, U, As + h * hd, DP,
                                     lse + ((long)b * nhead + h) * T);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    attn[(row0 + r) * d + c] = As[r * DP + c];
  }
  rd::row_gemm<BF, false>(As, DP, d, wo, bo, d, Xs, DP, x + row0 * d, d, nrows);
  __syncthreads();
  rd::layer_norm_rows(Xs, DP, d, g1, be1, nrows, Xs, DP);
  __syncthreads();
  rd::row_gemm<BF, true>(Xs, DP, d, w1, bf1, ffn, U, FP, nullptr, 0, nrows);
  __syncthreads();
  rd::row_gemm<BF, false>(U, FP, ffn, w2, bf2, d, As, DP, Xs, DP, nrows);
  __syncthreads();
  rd::layer_norm_rows(As, DP, d, g2, be2, nrows, out + row0 * d, d);
}

template <int MAXD, bool BF>
int launch(const float* x, const float* w_in, const float* b_in,
           const float* wo, const float* bo, const float* g1, const float* be1,
           const float* w1, const float* bf1, const float* w2, const float* bf2,
           const float* g2, const float* be2, const int* lengths, float* qkv,
           float* out, float* attn, float* lse, int B, int T, int d, int ffn,
           int nhead, float scale2, cudaStream_t stream) {
  const long M = (long)B * T;
  const int bytes_a = rd::BQ * ((d + 1) + (3 * d + 1)) * (int)sizeof(float);
  const int u = max(rd::attn_smem_floats(d / nhead), rd::BQ * (ffn + 1));
  const int bytes_b = (2 * rd::BQ * (d + 1) + u) * (int)sizeof(float);
  if (bytes_a > rd::MAX_SMEM || bytes_b > rd::MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto ka = qkv_proj_kernel<BF>;
  auto kb = layer_rows_kernel<MAXD, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_b);
  if (err != cudaSuccess) return (int)err;
  ka<<<(unsigned)((M + rd::BQ - 1) / rd::BQ), rd::NT, bytes_a, stream>>>(
      x, w_in, b_in, qkv, M, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + rd::BQ - 1) / rd::BQ, B);
  kb<<<grid, rd::NT, bytes_b, stream>>>(x, qkv, lengths, wo, bo, g1, be1, w1,
                                        bf1, w2, bf2, g2, be2, out, attn, lse,
                                        T, d, ffn, nhead, scale2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rd_fused_layer_fwd(
    const void* x, const void* w_in, const void* b_in, const void* wo,
    const void* bo, const void* g1, const void* be1, const void* w1,
    const void* bf1, const void* w2, const void* bf2, const void* g2,
    const void* be2, const void* lengths, void* qkv, void* out, void* attn,
    void* lse, int B, int T, int d, int ffn, int nhead, float scale2, int bf16,
    void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || d % nhead != 0 || ffn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RD_ARGS                                                            \
  (const float*)x, (const float*)w_in, (const float*)b_in,                 \
      (const float*)wo, (const float*)bo, (const float*)g1,                \
      (const float*)be1, (const float*)w1, (const float*)bf1,              \
      (const float*)w2, (const float*)bf2, (const float*)g2,               \
      (const float*)be2, (const int*)lengths, (float*)qkv, (float*)out,    \
      (float*)attn, (float*)lse, B, T, d, ffn, nhead, scale2, s
  RD_DISPATCH_HD(d / nhead, {
    return bf16 ? launch<MAXD, true>(RD_ARGS) : launch<MAXD, false>(RD_ARGS);
  });
#undef RD_ARGS
}
