// The fused layer's attention dk/dv pass past hd_pad 144 on the tensor
// cores (bf16 qkv [B, T, 3d] and d_attn [B, T, d], route 2 "tc_wide"): per
// (64-row key block, head, sample) two CTAs of two warpgroups each, dv and
// dk (blockIdx.x = 2 * block + role), running attn_dkv_rows_tc_wide
// (attention_tc_wide.cuh) into dqkv [B, T, 3d] f32, and its launcher. A
// unit of its own (14 instantiations, hd_pad 176-368); fused_encoder_bwd.cu says what the
// backward replaces and what bounds it.
#include "fused_plan.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WIDE_THREADS)
fused_dkv_wide(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lengths, float* __restrict__ dqkv, int T, int d,
               int nhead, float scale, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int k0 = (blockIdx.x >> 1) * rd::tc::ROWS, role = blockIdx.x & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const bf16* qh = qkv + (long)b * T * 3 * d + h * hd;
  const long stat = ((long)b * nhead + h) * T;
  float* out = dqkv + (long)b * T * 3 * d + h * hd + (role == 0 ? 2 * d : d);
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::tc::attn_dkv_rows_tc_wide<HDK, DROP>(
      qh, qh + d, qh + 2 * d, 3 * d, dattn + (long)b * T * d + h * hd, d, lse + stat,
      delta + stat, T, length, k0, hd, W, scale * 1.4426950408889634f, scale, dr, smem_tc,
      role, out, 3 * d, hd);
}

}  // namespace

int rd::fused::launch_dkv_wide(const void* qkv, const void* dattn, const void* lse,
                               const void* delta, const void* lengths, void* dqkv,
                               const Launch& l, int B, int T, int d, int nhead, float scale,
                               int seed, double rate, rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return packed::with_wide_pad<tc::WIDE_MIN_HD_PAD, WIDE_MAX_HD_PAD>(
      tc::wide_pad(d / nhead), [&](auto n) {
        constexpr int HDK = decltype(n)::value;
        auto kern = rate > 0.0 ? fused_dkv_wide<HDK, true> : fused_dkv_wide<HDK, false>;
        cudaError_t err = packed::allow_smem(kern, l.smem);
        if (err != cudaSuccess) return (int)err;
        kern<<<dim3(2 * ((T + l.rows - 1) / l.rows), nhead, B), l.threads, l.smem, stream>>>(
            (const bf16*)qkv, (const bf16*)dattn, (const float*)lse, (const float*)delta,
            (const int*)lengths, (float*)dqkv, T, d, nhead, scale, seed, dr, l.copy_bytes);
        return (int)cudaGetLastError();
      });
}
