// flash_mha_packed's tensor-core forward past hd_pad 144 (bf16 operands,
// the "tc_wide" route): the kernel over one (64-row query block, head,
// sample) on two warpgroups, and its launcher. flash_packed.cu holds the
// entry point; attention_tc_wide.cuh the device code and what bounds it.
#include "flash_packed.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WIDE_THREADS)
packed_fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ lengths,
                float* __restrict__ o, float* __restrict__ lse, int T, int d, int nhead,
                float scale2, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int q0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::tc::attend_rows_tc_wide<HDK, DROP>(q + base, k + base, v + base, d, T, length, q0, hd,
                                         W, scale2, smem_tc, o + base + (long)q0 * d, d,
                                         lse + ((long)b * nhead + h) * T, dr);
}

}  // namespace

int rd::packed::launch_fwd_wide(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* lse, const Plan& p,
                                int T, int d, int nhead, float scale2, int seed, double rate,
                                cudaStream_t stream) {
  const Drop dr = make_drop(rate);
  return with_wide_pad(p.hd_pad, [&](auto n) {
    constexpr int HDK = decltype(n)::value;
    auto kern = rate > 0.0 ? packed_fwd_wide<HDK, true> : packed_fwd_wide<HDK, false>;
    cudaError_t err = allow_smem(kern, p.smem_fwd);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_fwd, p.smem_fwd, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (float*)o,
        (float*)lse, T, d, nhead, scale2, seed, dr, p.copy_bytes);
    return (int)cudaGetLastError();
  });
}
