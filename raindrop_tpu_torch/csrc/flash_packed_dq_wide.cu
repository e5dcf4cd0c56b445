// flash_mha_packed's tensor-core dq pass past hd_pad 144 (bf16 operands,
// the "tc_wide" route): the kernel over one (64-row query block, head,
// sample) on two warpgroups, and its launcher. flash_packed.cu holds the
// entry point; attention_tc_wide.cuh the device code and what bounds it.
#include "flash_packed.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WIDE_THREADS)
packed_dq_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ d_o,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lengths, float* __restrict__ dq, int T, int d,
               int nhead, float scale, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int q0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::tc::attn_dq_rows_tc_wide<HDK, DROP>(q + base, k + base, v + base, d, d_o + base, d,
                                          lse + stat, delta + stat, T, length, q0, hd, W,
                                          scale * 1.4426950408889634f, scale, dr, smem_tc,
                                          dq + base, d);
}

}  // namespace

int rd::packed::launch_dq_wide(const void* q, const void* k, const void* v, const void* d_o,
                               const void* lse, const void* delta, const void* lengths,
                               void* dq, const Plan& p, int T, int d, int nhead, float scale,
                               int seed, double rate, cudaStream_t stream) {
  const Drop dr = make_drop(rate);
  return with_wide_pad(p.hd_pad, [&](auto n) {
    constexpr int HDK = decltype(n)::value;
    auto kern = rate > 0.0 ? packed_dq_wide<HDK, true> : packed_dq_wide<HDK, false>;
    cudaError_t err = allow_smem(kern, p.smem_dq);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_dq, p.smem_dq, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)delta, (const int*)lengths, (float*)dq, T, d, nhead, scale, seed, dr,
        p.copy_bytes);
    return (int)cudaGetLastError();
  });
}
