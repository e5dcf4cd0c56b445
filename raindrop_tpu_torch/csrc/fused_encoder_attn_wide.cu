// The fused layer's attention forward past hd_pad 144 on the tensor cores
// (bf16 qkv [B, T, 3d], route 2 "tc_wide"): two warpgroups per (64-row
// query block, head, sample) running attend_rows_tc_wide
// (attention_tc_wide.cuh) on the head's strided view of qkv, and its
// launcher. A unit of its own (14 instantiations: hd_pad 176, 208, ...,
// 368, with and without dropout; past 208 the "stream" route's) so that
// nvcc builds it beside fused_encoder.cu;
// fused_encoder.cu says what the layer replaces and what bounds it.
#include "fused_plan.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WIDE_THREADS)
fused_attn_fwd_wide(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
                    float* __restrict__ attn, float* __restrict__ lse, int T, int d,
                    int nhead, float scale2, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int q0 = blockIdx.x * rd::tc::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const bf16* qh = qkv + (long)b * T * 3 * d + h * hd;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::tc::attend_rows_tc_wide<HDK, DROP>(
      qh, qh + d, qh + 2 * d, 3 * d, T, length, q0, hd, W, scale2, smem_tc,
      attn + ((long)b * T + q0) * d + h * hd, d, lse + ((long)b * nhead + h) * T, dr, hd);
}

}  // namespace

int rd::fused::launch_attn_fwd_wide(const void* qkv, const void* lengths, void* attn,
                                    void* lse, const Launch& l, int B, int T, int d,
                                    int nhead, float scale2, int seed, double rate, rd::Origin org,
                                    cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return packed::with_wide_pad<tc::WIDE_MIN_HD_PAD, WIDE_MAX_HD_PAD>(
      tc::wide_pad(d / nhead), [&](auto n) {
        constexpr int HDK = decltype(n)::value;
        auto kern = rate > 0.0 ? fused_attn_fwd_wide<HDK, true> : fused_attn_fwd_wide<HDK, false>;
        cudaError_t err = packed::allow_smem(kern, l.smem);
        if (err != cudaSuccess) return (int)err;
        kern<<<dim3((T + l.rows - 1) / l.rows, nhead, B), l.threads, l.smem, stream>>>(
            (const bf16*)qkv, (const int*)lengths, (float*)attn, (float*)lse, T, d, nhead,
            scale2, seed, dr, l.copy_bytes);
        return (int)cudaGetLastError();
      });
}
