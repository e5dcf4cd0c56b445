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
// and the bytes weigh about equally; at PAM's sensor-wise width (d=340,
// ffn=136, hd=170) about 1.5 GFLOP a sample, past the ridge. This first
// kernel runs every product in scalar f32 FMA, so the FMA and load issue
// rates bound it.
//
// Design: the TPU kernel keeps a whole sample (x, q, k, v, the [T, T]
// scores and every weight) in one core's VMEM; at PAM that is over
// 400 KB, past an SM's 227 KB. So the layer takes three launches:
//   A  qkv = x W_in^T + b_in for 32-row blocks of [B*T, d] -> [B*T, 3d]
//      in device memory (fused_rows.cuh, the backward's first launch too);
//   B  one CTA per (block of query rows, head, sample) streams that
//      sample's K/V with the same online-softmax code as the packed
//      attention kernel (attend_rows, in the geometry of the head dim)
//      and writes attn and lse, which the backward reads anyway;
//   C  one CTA per (64 rows, sample) runs the out-projection, residual,
//      LN1, FFN with relu, residual and LN2 on its own rows, which are
//      row-local. x1 and the FFN hidden stay in shared memory.
// The attention and the row-local tail once shared one CTA; at PAM's
// sensor-wise width the two together need 322,560 bytes of shared memory
// (the tail alone 209,664, the attention at hd 170 147,968), and apart the
// attention gets a CTA per head. Weights are read from global memory by
// every CTA; they stay in L2. No atomics, no score in device memory. With
// bf16 operands every product operand is rounded to bf16 (q, k, v after
// their bias, as the TPU kernel casts them), accumulation stays f32.
//
// Dropout (training) is a template flag; with rate 0 the kernels carry no
// mask code. The attention probabilities are keyed (seed, b * nhead + h),
// the three site masks (seed, b) with the row term site * t8 + row, t8 = T
// padded to 8 (the reference's padded row count), sites 101 (attention
// out), 102 (FFN hidden, after relu) and 103 (FFN out).
#include <algorithm>

#include "fused_rows.cuh"

namespace {

template <int MAXD, typename G, bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
attn_rows_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
                 float* __restrict__ attn, float* __restrict__ lse, int T, int d,
                 int nhead, float scale2, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::attend_rows<MAXD, BF, DROP, float, G>(
      qh, qh + d, qh + 2 * d, 3 * d, T, length, q0, hd, scale2, smem,
      attn + ((long)b * T + q0) * d + h * hd, d, lse + ((long)b * nhead + h) * T, dr);
}

// Shared floats of the row-local tail: attn rows (later x1 + FFN), x +
// attention projection (later x1), the FFN hidden.
inline int tail_floats(int d, int ffn) { return 2 * rd::BQ * (d + 1) + rd::BQ * (ffn + 1); }

template <bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
layer_tail_kernel(const float* __restrict__ x, const float* __restrict__ attn,
                  const float* __restrict__ wo, const float* __restrict__ bo,
                  const float* __restrict__ g1, const float* __restrict__ be1,
                  const float* __restrict__ w1, const float* __restrict__ bf1,
                  const float* __restrict__ w2, const float* __restrict__ bf2,
                  const float* __restrict__ g2, const float* __restrict__ be2,
                  float* __restrict__ out, int T, int d, int ffn, int seed,
                  rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, b = blockIdx.y;
  const int nrows = min(rd::BQ, T - q0);
  const int DP = d + 1, FP = ffn + 1;
  float* As = smem;             // attention rows, later x1 + FFN
  float* Xs = As + rd::BQ * DP; // x + attention projection, then x1
  float* U = Xs + rd::BQ * DP;  // the FFN hidden
  const long row0 = (long)b * T + q0;
  for (int idx = threadIdx.x; idx < rd::BQ * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    As[r * DP + c] = r < nrows ? attn[(row0 + r) * d + c] : 0.f;
  }
  dr.base = rd::drop_base(seed, (uint32_t)b);
  const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
  __syncthreads();
  rd::row_gemm<BF, false, DROP>(As, DP, d, wo, bo, d, Xs, DP, x + row0 * d, d,
                                nrows, dr, 101u * t8 + q0);
  __syncthreads();
  rd::layer_norm_rows(Xs, DP, d, g1, be1, nrows, Xs, DP);
  __syncthreads();
  rd::row_gemm<BF, true, DROP>(Xs, DP, d, w1, bf1, ffn, U, FP, nullptr, 0, nrows,
                               dr, 102u * t8 + q0);
  __syncthreads();
  rd::row_gemm<BF, false, DROP>(U, FP, ffn, w2, bf2, d, As, DP, Xs, DP, nrows,
                                dr, 103u * t8 + q0);
  __syncthreads();
  rd::layer_norm_rows(As, DP, d, g2, be2, nrows, out + row0 * d, d);
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > rd::MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Shared bytes of the three launches at one width: the qkv projection, the
// attention (the scalar routine in geometry G), the row-local tail.
template <typename G>
int fwd_smem(int d, int ffn, int nhead, int* bytes) {
  bytes[0] = rd::BR * (d + 1) * (int)sizeof(float);
  bytes[1] = rd::attn_smem_floats<G>(d / nhead) * (int)sizeof(float);
  bytes[2] = tail_floats(d, ffn) * (int)sizeof(float);
  return std::max({bytes[0], bytes[1], bytes[2]}) > rd::MAX_SMEM
             ? (int)cudaErrorInvalidValue : 0;
}

template <int MAXD, typename G, bool BF, bool DROP>
int launch(const float* x, const float* w_in, const float* b_in,
           const float* wo, const float* bo, const float* g1, const float* be1,
           const float* w1, const float* bf1, const float* w2, const float* bf2,
           const float* g2, const float* be2, const int* lengths, float* qkv,
           float* out, float* attn, float* lse, int B, int T, int d, int ffn,
           int nhead, float scale2, int seed, rd::Drop dr, cudaStream_t stream) {
  const long M = (long)B * T;
  int bytes[3];
  if (fwd_smem<G>(d, ffn, nhead, bytes) != 0) return (int)cudaErrorInvalidValue;
  const int bytes_a = bytes[0], bytes_b = bytes[1], bytes_c = bytes[2];
  auto ka = rd::qkv_rows_kernel<BF>;
  auto kb = attn_rows_kernel<MAXD, G, BF, DROP>;
  auto kc = layer_tail_kernel<BF, DROP>;
  cudaError_t err = allow_smem(ka, bytes_a);
  if (err == cudaSuccess) err = allow_smem(kb, bytes_b);
  if (err == cudaSuccess) err = allow_smem(kc, bytes_c);
  if (err != cudaSuccess) return (int)err;
  ka<<<(unsigned)((M + rd::BR - 1) / rd::BR), rd::NT, bytes_a, stream>>>(
      x, w_in, b_in, qkv, M, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 blocks((T + G::ROWS - 1) / G::ROWS, nhead, B);
  kb<<<blocks, rd::NT, bytes_b, stream>>>(qkv, lengths, attn, lse, T, d, nhead, scale2,
                                          seed, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 rows((T + rd::BQ - 1) / rd::BQ, B);
  kc<<<rows, rd::NT, bytes_c, stream>>>(x, attn, wo, bo, g1, be1, w1, bf1, w2, bf2, g2,
                                        be2, out, T, d, ffn, seed, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared bytes of the forward's launches (qkv projection, attention,
// row-local tail) at one width; cudaErrorInvalidValue where one would not
// fit a block or no geometry takes the head dim.
extern "C" int rd_fused_layer_fwd_smem(int d, int ffn, int nhead, int* bytes) {
  if (nhead <= 0 || d % nhead != 0 || ffn <= 0) return (int)cudaErrorInvalidValue;
  RD_DISPATCH_GEOM(d / nhead, {
    (void)MAXD;
    return fwd_smem<G>(d, ffn, nhead, bytes);
  });
}

extern "C" int rd_fused_layer_fwd(
    const void* x, const void* w_in, const void* b_in, const void* wo,
    const void* bo, const void* g1, const void* be1, const void* w1,
    const void* bf1, const void* w2, const void* bf2, const void* g2,
    const void* be2, const void* lengths, void* qkv, void* out, void* attn,
    void* lse, int B, int T, int d, int ffn, int nhead, float scale2, int bf16,
    int seed, double rate, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 ||
      d % nhead != 0 || ffn <= 0 || !(rate >= 0.0 && rate < 1.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::Drop dr = rd::make_drop(rate);
#define RD_ARGS                                                            \
  (const float*)x, (const float*)w_in, (const float*)b_in,                 \
      (const float*)wo, (const float*)bo, (const float*)g1,                \
      (const float*)be1, (const float*)w1, (const float*)bf1,              \
      (const float*)w2, (const float*)bf2, (const float*)g2,               \
      (const float*)be2, (const int*)lengths, (float*)qkv, (float*)out,    \
      (float*)attn, (float*)lse, B, T, d, ffn, nhead, scale2, seed, dr, s
  RD_DISPATCH_GEOM(d / nhead, {
    if (rate > 0.0) {
      return bf16 ? launch<MAXD, G, true, true>(RD_ARGS)
                  : launch<MAXD, G, false, true>(RD_ARGS);
    }
    return bf16 ? launch<MAXD, G, true, false>(RD_ARGS)
                : launch<MAXD, G, false, false>(RD_ARGS);
  });
#undef RD_ARGS
}
