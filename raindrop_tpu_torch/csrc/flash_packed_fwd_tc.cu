// The tensor-core forward of flash_mha_packed and flash_mha (bf16
// operands, hd_pad <= 144): the kernel over one (64-row query block, head,
// sample) of [B, H, T, hd] operands with the given (batch, head, row)
// strides (flash_mha_packed's [B, T, d] is (T * d, hd, d)), and its
// launcher. flash_packed.cu and flash_split.cu hold the entry points and say
// what the kernels replace and what bounds them; attention_tc.cuh the device
// code.
#include "flash_packed.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rd::packed::Strides;
using rd::packed::head_base;

template <int HDK, bool DROP>
__global__ void __launch_bounds__(rd::tc::WG)
packed_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ o, float* __restrict__ lse, Strides s_in, Strides s_out,
              int H, int T, int D, int cols, float scale2, int seed, rd::Drop dr, int W) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int q0 = blockIdx.x * rd::tc::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::tc::attend_rows_tc<HDK, DROP>(
      q + in, k + in, v + in, s_in.t, T, length, q0, D, W, scale2, smem_tc,
      o + head_base(s_out, b, h) + (long)q0 * s_out.t, s_out.t, lse + ((long)b * H + h) * T, dr,
      cols);
}

}  // namespace

int rd::packed::launch_fwd_tc(const void* q, const void* k, const void* v,
                              const void* lengths, void* o, void* lse, Strides s_in,
                              Strides s_out, const Plan& p, int H, int T, int D, float scale2,
                              int seed, double rate, rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return with_hd_pad(p.hd_pad, [&](auto n) {
    constexpr int HDK = decltype(n)::value;
    auto kern = rate > 0.0 ? packed_fwd_tc<HDK, true> : packed_fwd_tc<HDK, false>;
    cudaError_t err = allow_smem(kern, p.smem_fwd);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_fwd, p.smem_fwd, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (float*)o,
        (float*)lse, s_in, s_out, H, T, D, p.cols, scale2, seed, dr, p.copy_bytes);
    return (int)cudaGetLastError();
  });
}
