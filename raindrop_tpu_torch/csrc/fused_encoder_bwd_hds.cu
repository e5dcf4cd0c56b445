// The fused layer's attention backward past head dim 368 (route 3,
// "hd_stream"): attn_dq_rows_hs and attn_dkv_rows_hs
// (attention_hd_stream.cuh) on the layer's f32 qkv [B, T, 3d] and d_attn
// [B, T, d] into dqkv [B, T, 3d] f32, one CTA per (32-row block and
// 256-column slice, head, sample), and their launchers. A unit of its own
// so that nvcc builds it beside fused_encoder_bwd.cu, which says what the
// backward replaces; fused_encoder_attn_hds.cu says why the head dim
// streams. With bf16 operands d_attn is rounded as it is loaded.
#include "fused_plan.cuh"

namespace {

template <bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_dq_hds(const float* __restrict__ qkv, const float* __restrict__ dattn,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ lengths, float* __restrict__ dqkv, int T, int d,
             int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int hd = d / nhead, ns = rd::hs::slices(hd);
  const int q0 = (int)(blockIdx.x / ns) * rd::hs::ROWS;
  const int c0 = (int)(blockIdx.x % ns) * rd::hs::HS_SLICE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::hs::attn_dq_rows_hs<BF, DROP, float>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d, lse + stat,
      delta + stat, T, length, q0, c0, hd, scale * 1.4426950408889634f, scale, dr, smem,
      dqkv + (long)b * T * 3 * d + h * hd, 3 * d);
}

template <bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
fused_dkv_hds(const float* __restrict__ qkv, const float* __restrict__ dattn,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lengths, float* __restrict__ dqkv, int T, int d,
              int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int hd = d / nhead, ns = rd::hs::slices(hd);
  const int k0 = (int)(blockIdx.x / ns) * rd::hs::ROWS;
  const int c0 = (int)(blockIdx.x % ns) * rd::hs::HS_SLICE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  float* out = dqkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::hs::attn_dkv_rows_hs<BF, DROP, float>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d, lse + stat,
      delta + stat, T, length, k0, c0, hd, scale * 1.4426950408889634f, scale, dr, smem,
      out + d, out + 2 * d, 3 * d);
}

template <typename K>
int launch(K kern, const void* qkv, const void* dattn, const void* lse, const void* delta,
           const void* lengths, void* dqkv, const rd::fused::Launch& l, int B, int T, int d,
           int nhead, float scale, int seed, rd::Drop dr, cudaStream_t stream) {
  cudaError_t err = rd::packed::allow_smem(kern, l.smem);
  if (err != cudaSuccess) return (int)err;
  const int x = (T + l.rows - 1) / l.rows * rd::hs::slices(d / nhead);
  kern<<<dim3(x, nhead, B), l.threads, l.smem, stream>>>(
      (const float*)qkv, (const float*)dattn, (const float*)lse, (const float*)delta,
      (const int*)lengths, (float*)dqkv, T, d, nhead, scale, seed, dr);
  return (int)cudaGetLastError();
}

}  // namespace

int rd::fused::launch_dq_hds(const void* qkv, const void* dattn, const void* lse,
                             const void* delta, const void* lengths, void* dqkv,
                             const Launch& l, int B, int T, int d, int nhead, float scale,
                             int bf16, int seed, double rate, rd::Origin org,
                             cudaStream_t stream) {
  const bool drop = rate > 0.0;
  auto kern = bf16 ? (drop ? fused_dq_hds<true, true> : fused_dq_hds<true, false>)
                   : (drop ? fused_dq_hds<false, true> : fused_dq_hds<false, false>);
  return launch(kern, qkv, dattn, lse, delta, lengths, dqkv, l, B, T, d, nhead, scale, seed,
                make_drop(rate, org), stream);
}

int rd::fused::launch_dkv_hds(const void* qkv, const void* dattn, const void* lse,
                              const void* delta, const void* lengths, void* dqkv,
                              const Launch& l, int B, int T, int d, int nhead, float scale,
                              int bf16, int seed, double rate, rd::Origin org,
                              cudaStream_t stream) {
  const bool drop = rate > 0.0;
  auto kern = bf16 ? (drop ? fused_dkv_hds<true, true> : fused_dkv_hds<true, false>)
                   : (drop ? fused_dkv_hds<false, true> : fused_dkv_hds<false, false>);
  return launch(kern, qkv, dattn, lse, delta, lengths, dqkv, l, B, T, d, nhead, scale, seed,
                make_drop(rate, org), stream);
}
