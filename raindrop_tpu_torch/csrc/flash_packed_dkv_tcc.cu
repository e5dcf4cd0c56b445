// The tensor-core dk/dv pass past head dim 368 (bf16 operands, the
// "tc_cluster" route) of flash_mha_packed, flash_mha and the fused layer's
// attention: the kernel over one (64-row key block, head, sample) and one
// column slice, both outputs on two warpgroups, in clusters of
// tcc::cluster_size(D) CTAs, on strided operands as in
// flash_packed_dkv_tc.cu, and its launcher. A unit of its own (6
// instantiations) so that nvcc builds it beside the others;
// attention_tc_cluster.cuh holds the device code and says what bounds it.
#include "flash_packed.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rd::packed::Strides;
using rd::packed::head_base;

template <int W, bool DROP>
__global__ void __launch_bounds__(rd::tcc::DKV_THREADS)
packed_dkv_tcc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ d_o,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lengths, float* __restrict__ dk, float* __restrict__ dv,
               Strides s_in, Strides s_do, Strides s_out, int H, int T, int D, int cols,
               float scale, int seed, rd::Drop dr, int CW) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const int k0 = (int)(blockIdx.x / rd::tcc::cluster_size(D)) * rd::tc::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  const long out = head_base(s_out, b, h);
  const long stat = ((long)b * H + h) * T;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::tcc::attn_dkv_rows_cluster<W, DROP>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t, lse + stat,
      delta + stat, T, length, k0, D, CW, scale * 1.4426950408889634f, scale, dr, smem_tc,
      dk + out, dv + out, s_out.t, cols);
}

}  // namespace

int rd::packed::launch_dkv_tcc(const void* q, const void* k, const void* v, const void* d_o,
                               const void* lse, const void* delta, const void* lengths,
                               void* dk, void* dv, Strides s_in, Strides s_do, Strides s_out,
                               const Plan& p, int H, int T, int D, float scale, int seed,
                               double rate, rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return with_slice(tcc::slice_cols(D), [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto kern = rate > 0.0 ? packed_dkv_tcc<W, true> : packed_dkv_tcc<W, false>;
    return launch_cluster(kern, dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_dkv,
                          p.smem_dkv, tcc::cluster_size(D), stream, (const bf16*)q,
                          (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
                          (const float*)delta, (const int*)lengths, (float*)dk, (float*)dv,
                          s_in, s_do, s_out, H, T, D, p.cols, scale, seed, dr, p.copy_bytes);
  });
}

int rd::packed::clusters_dkv_tcc(int D, int* out) {
  return with_slice(tcc::slice_cols(D), [&](auto w) {
    constexpr int W = decltype(w)::value;
    return max_clusters(packed_dkv_tcc<W, true>, tcc::DKV_THREADS, tcc::dkv_smem_bytes(W),
                        tcc::cluster_size(D), out);
  });
}
