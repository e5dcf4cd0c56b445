// The tensor-core dk/dv pass of flash_mha_packed and flash_mha (bf16
// operands, hd_pad <= 144): the kernel over one (64-row key block, head,
// sample) and one of dv, dk (two CTAs a key block, blockIdx.x = 2 * block +
// role) on strided operands, as in flash_packed_fwd_tc.cu, and its launcher.
// attention_tc.cuh holds the device code.
#include "flash_packed.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rd::packed::Strides;
using rd::packed::head_base;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WG)
packed_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lengths, float* __restrict__ dk, float* __restrict__ dv,
              Strides s_in, Strides s_do, Strides s_out, int H, int T, int D, int cols,
              float scale, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int k0 = (blockIdx.x >> 1) * rd::tc::ROWS, role = blockIdx.x & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  const long stat = ((long)b * H + h) * T;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::tc::attn_dkv_rows_tc<HDK, DROP>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t, lse + stat,
      delta + stat, T, length, k0, D, W, scale * 1.4426950408889634f, scale, dr, smem_tc, role,
      (role == 0 ? dv : dk) + head_base(s_out, b, h), s_out.t, cols);
}

}  // namespace

int rd::packed::launch_dkv_tc(const void* q, const void* k, const void* v, const void* d_o,
                              const void* lse, const void* delta, const void* lengths,
                              void* dk, void* dv, Strides s_in, Strides s_do, Strides s_out,
                              const Plan& p, int H, int T, int D, float scale, int seed,
                              double rate, rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return with_hd_pad(p.hd_pad, [&](auto n) {
    constexpr int HDK = decltype(n)::value;
    auto kern = rate > 0.0 ? packed_dkv_tc<HDK, true> : packed_dkv_tc<HDK, false>;
    cudaError_t err = allow_smem(kern, p.smem_dkv);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(2 * p.grid_x, p.grid_y, p.grid_z), p.threads_dkv, p.smem_dkv, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)delta, (const int*)lengths, (float*)dk, (float*)dv, s_in, s_do, s_out,
        H, T, D, p.cols, scale, seed, dr, p.copy_bytes);
    return (int)cudaGetLastError();
  });
}
