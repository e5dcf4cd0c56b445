// The fused layer's attention dq pass on the tensor cores (bf16 qkv [B, T,
// 3d] and d_attn [B, T, d]): one warpgroup per (64-row query block, head,
// sample) running attn_dq_rows_tc (attention_tc.cuh) into dqkv [B, T, 3d]
// f32, and its launcher. A unit of its own (18 instantiations) so that
// nvcc builds it beside fused_encoder_bwd.cu, which says what the backward
// replaces and what bounds it.
#include "fused_plan.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WG)
fused_dq_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ lengths, float* __restrict__ dqkv, int T, int d,
            int nhead, float scale, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int q0 = blockIdx.x * rd::tc::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const bf16* qh = qkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::tc::attn_dq_rows_tc<HDK, DROP>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d, lse + stat,
      delta + stat, T, length, q0, hd, W, scale * 1.4426950408889634f, scale, dr, smem_tc,
      dqkv + (long)b * T * 3 * d + h * hd, 3 * d);
}

}  // namespace

int rd::fused::launch_dq_tc(const void* qkv, const void* dattn, const void* lse,
                            const void* delta, const void* lengths, void* dqkv,
                            const Launch& l, int B, int T, int d, int nhead, float scale,
                            int seed, double rate, cudaStream_t stream) {
  const Drop dr = make_drop(rate);
  return packed::with_hd_pad(tc::pad16(d / nhead), [&](auto n) {
    constexpr int HDK = decltype(n)::value;
    auto kern = rate > 0.0 ? fused_dq_tc<HDK, true> : fused_dq_tc<HDK, false>;
    cudaError_t err = packed::allow_smem(kern, l.smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((T + l.rows - 1) / l.rows, nhead, B), l.threads, l.smem, stream>>>(
        (const bf16*)qkv, (const bf16*)dattn, (const float*)lse, (const float*)delta,
        (const int*)lengths, (float*)dqkv, T, d, nhead, scale, seed, dr, l.copy_bytes);
    return (int)cudaGetLastError();
  });
}
