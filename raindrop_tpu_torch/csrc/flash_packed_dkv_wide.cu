// flash_mha_packed's tensor-core dk/dv pass past hd_pad 144 (bf16
// operands, the "tc_wide" route): the kernel over one (64-row key block,
// head, sample) and one of dv, dk (two CTAs a key block, blockIdx.x = 2 *
// block + role), each on two warpgroups, and its launcher. flash_packed.cu
// holds the entry point; attention_tc_wide.cuh the device code and what
// bounds it.
#include "flash_packed.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WIDE_THREADS)
packed_dkv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lengths, float* __restrict__ dk,
                float* __restrict__ dv, int T, int d, int nhead, float scale, int seed,
                rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int k0 = (blockIdx.x >> 1) * rd::BQ, role = blockIdx.x & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  const long stat = ((long)b * nhead + h) * T;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::tc::attn_dkv_rows_tc_wide<HDK, DROP>(q + base, k + base, v + base, d, d_o + base, d,
                                           lse + stat, delta + stat, T, length, k0, hd, W,
                                           scale * 1.4426950408889634f, scale, dr, smem_tc,
                                           role, (role == 0 ? dv : dk) + base, d);
}

}  // namespace

int rd::packed::launch_dkv_wide(const void* q, const void* k, const void* v, const void* d_o,
                                const void* lse, const void* delta, const void* lengths,
                                void* dk, void* dv, const Plan& p, int T, int d, int nhead,
                                float scale, int seed, double rate, cudaStream_t stream) {
  const Drop dr = make_drop(rate);
  return with_wide_pad(p.hd_pad, [&](auto n) {
    constexpr int HDK = decltype(n)::value;
    auto kern = rate > 0.0 ? packed_dkv_wide<HDK, true> : packed_dkv_wide<HDK, false>;
    cudaError_t err = allow_smem(kern, p.smem_dkv);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(2 * p.grid_x, p.grid_y, p.grid_z), p.threads_dkv, p.smem_dkv, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)delta, (const int*)lengths, (float*)dk, (float*)dv, T, d, nhead, scale,
        seed, dr, p.copy_bytes);
    return (int)cudaGetLastError();
  });
}
