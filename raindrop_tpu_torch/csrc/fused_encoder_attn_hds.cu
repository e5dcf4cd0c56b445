// The fused layer's attention forward past head dim 368 (route 3,
// "hd_stream"): attend_rows_hs (attention_hd_stream.cuh) on the head's
// strided view of the layer's f32 qkv rows [B, T, 3d], one CTA per (32-row
// query block and 256-column slice of the output, head, sample), and its
// launcher. The JAX kernel (raindrop_tpu/ops/fused_encoder.py:131) keeps a
// whole head in VMEM; no scalar tile of a head past 368 columns fits an
// SM, so the head dim streams in 32-column chunks through the scores
// (attention_hd_stream.cuh says how). A unit of its own so that nvcc builds
// it beside fused_encoder.cu; with bf16 operands qkv holds values already
// rounded to bf16 and the probabilities are rounded as the kernels of the
// other routes round them.
#include "fused_plan.cuh"

namespace {

template <bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_attn_fwd_hds(const float* __restrict__ qkv, const int* __restrict__ lengths,
                   float* __restrict__ attn, float* __restrict__ lse, int T, int d, int nhead,
                   float scale2, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int hd = d / nhead, ns = rd::hs::slices(hd);
  const int q0 = (int)(blockIdx.x / ns) * rd::hs::ROWS;
  const int c0 = (int)(blockIdx.x % ns) * rd::hs::HS_SLICE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::hs::attend_rows_hs<BF, DROP, float>(
      qh, qh + d, qh + 2 * d, 3 * d, T, length, q0, c0, hd, scale2, smem,
      attn + ((long)b * T + q0) * d + h * hd, d, lse + ((long)b * nhead + h) * T, dr);
}

}  // namespace

int rd::fused::launch_attn_fwd_hds(const void* qkv, const void* lengths, void* attn,
                                   void* lse, const Launch& l, int B, int T, int d, int nhead,
                                   float scale2, int bf16, int seed, double rate,
                                   rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  auto kern = bf16 ? (rate > 0.0 ? fused_attn_fwd_hds<true, true> : fused_attn_fwd_hds<true, false>)
                   : (rate > 0.0 ? fused_attn_fwd_hds<false, true>
                                 : fused_attn_fwd_hds<false, false>);
  cudaError_t err = packed::allow_smem(kern, l.smem);
  if (err != cudaSuccess) return (int)err;
  const int x = (T + l.rows - 1) / l.rows * hs::slices(d / nhead);
  kern<<<dim3(x, nhead, B), l.threads, l.smem, stream>>>(
      (const float*)qkv, (const int*)lengths, (float*)attn, (float*)lse, T, d, nhead, scale2,
      seed, dr);
  return (int)cudaGetLastError();
}
