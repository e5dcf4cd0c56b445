// The attention forward, dq and dk/dv of flash_mha_packed and flash_mha past
// head dim 368 (route "hd_stream", f32 or bf16 operands): the kernels over
// one (32-row block and column slice, head, sample) on strided operands, as
// the tensor-core units take them, and their launchers. The grid's x axis
// holds the row blocks times the column slices, the slice fastest (the
// CTAs of one row block read the same rows of q and k from L2).
// attention_hd_stream.cuh holds the device code and says why.
#include "flash_packed.cuh"

namespace {

using rd::packed::Plan;
using rd::packed::Strides;
using rd::packed::allow_smem;
using rd::packed::head_base;
namespace hs = rd::hs;

template <bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_fwd_hds(const TIn* __restrict__ q, const TIn* __restrict__ k,
               const TIn* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ o, float* __restrict__ lse, Strides s_in, Strides s_out,
               int H, int T, int D, float scale2, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int ns = hs::slices(D);
  const int q0 = (int)(blockIdx.x / ns) * hs::ROWS, c0 = (int)(blockIdx.x % ns) * hs::HS_SLICE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  hs::attend_rows_hs<kBf16, DROP, TIn>(
      q + in, k + in, v + in, s_in.t, T, length, q0, c0, D, scale2, smem,
      o + head_base(s_out, b, h) + (long)q0 * s_out.t, s_out.t, lse + ((long)b * H + h) * T,
      dr);
}

template <bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_dq_hds(const TIn* __restrict__ q, const TIn* __restrict__ k,
              const TIn* __restrict__ v, const TIn* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lengths, float* __restrict__ dq, Strides s_in,
              Strides s_do, Strides s_out, int H, int T, int D, float scale, int seed,
              rd::Drop dr) {
  extern __shared__ float smem[];
  const int ns = hs::slices(D);
  const int q0 = (int)(blockIdx.x / ns) * hs::ROWS, c0 = (int)(blockIdx.x % ns) * hs::HS_SLICE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  const long stat = ((long)b * H + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  hs::attn_dq_rows_hs<kBf16, DROP, TIn>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t, lse + stat,
      delta + stat, T, length, q0, c0, D, scale * 1.4426950408889634f, scale, dr, smem,
      dq + head_base(s_out, b, h), s_out.t);
}

template <bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_dkv_hds(const TIn* __restrict__ q, const TIn* __restrict__ k,
               const TIn* __restrict__ v, const TIn* __restrict__ d_o,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lengths, float* __restrict__ dk,
               float* __restrict__ dv, Strides s_in, Strides s_do, Strides s_out, int H,
               int T, int D, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int ns = hs::slices(D);
  const int k0 = (int)(blockIdx.x / ns) * hs::ROWS, c0 = (int)(blockIdx.x % ns) * hs::HS_SLICE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  const long out = head_base(s_out, b, h);
  const long stat = ((long)b * H + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  hs::attn_dkv_rows_hs<kBf16, DROP, TIn>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t, lse + stat,
      delta + stat, T, length, k0, c0, D, scale * 1.4426950408889634f, scale, dr, smem,
      dk + out, dv + out, s_out.t);
}

template <typename TIn>
int fwd_hds(const void* q, const void* k, const void* v, const void* lengths, void* o,
            void* lse, Strides s_in, Strides s_out, const Plan& p, int H, int T, int D,
            float scale2, int seed, double rate, rd::Drop dr, cudaStream_t stream) {
  auto kern = rate > 0.0 ? packed_fwd_hds<true, TIn> : packed_fwd_hds<false, TIn>;
  cudaError_t err = allow_smem(kern, p.smem_fwd);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_fwd, p.smem_fwd, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const int*)lengths, (float*)o,
      (float*)lse, s_in, s_out, H, T, D, scale2, seed, dr);
  return (int)cudaGetLastError();
}

template <typename TIn>
int dq_hds(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
           const void* delta, const void* lengths, void* dq, Strides s_in, Strides s_do,
           Strides s_out, const Plan& p, int H, int T, int D, float scale, int seed,
           double rate, rd::Drop dr, cudaStream_t stream) {
  auto kern = rate > 0.0 ? packed_dq_hds<true, TIn> : packed_dq_hds<false, TIn>;
  cudaError_t err = allow_smem(kern, p.smem_dq);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_dq, p.smem_dq, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o, (const float*)lse,
      (const float*)delta, (const int*)lengths, (float*)dq, s_in, s_do, s_out, H, T, D, scale,
      seed, dr);
  return (int)cudaGetLastError();
}

template <typename TIn>
int dkv_hds(const void* q, const void* k, const void* v, const void* d_o, const void* lse,
            const void* delta, const void* lengths, void* dk, void* dv, Strides s_in,
            Strides s_do, Strides s_out, const Plan& p, int H, int T, int D, float scale,
            int seed, double rate, rd::Drop dr, cudaStream_t stream) {
  auto kern = rate > 0.0 ? packed_dkv_hds<true, TIn> : packed_dkv_hds<false, TIn>;
  cudaError_t err = allow_smem(kern, p.smem_dkv);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.grid_x, p.grid_y, p.grid_z), p.threads_dkv, p.smem_dkv, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o, (const float*)lse,
      (const float*)delta, (const int*)lengths, (float*)dk, (float*)dv, s_in, s_do, s_out, H,
      T, D, scale, seed, dr);
  return (int)cudaGetLastError();
}

}  // namespace

int rd::packed::launch_fwd_hds(const void* q, const void* k, const void* v,
                               const void* lengths, void* o, void* lse, Strides s_in,
                               Strides s_out, const Plan& p, int H, int T, int D, float scale2,
                               int bf16, int seed, double rate, rd::Origin org,
                               cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return (bf16 ? fwd_hds<__nv_bfloat16> : fwd_hds<float>)(
      q, k, v, lengths, o, lse, s_in, s_out, p, H, T, D, scale2, seed, rate, dr, stream);
}

int rd::packed::launch_dq_hds(const void* q, const void* k, const void* v, const void* d_o,
                              const void* lse, const void* delta, const void* lengths,
                              void* dq, Strides s_in, Strides s_do, Strides s_out,
                              const Plan& p, int H, int T, int D, float scale, int bf16,
                              int seed, double rate, rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return (bf16 ? dq_hds<__nv_bfloat16> : dq_hds<float>)(
      q, k, v, d_o, lse, delta, lengths, dq, s_in, s_do, s_out, p, H, T, D, scale, seed, rate,
      dr, stream);
}

int rd::packed::launch_dkv_hds(const void* q, const void* k, const void* v, const void* d_o,
                               const void* lse, const void* delta, const void* lengths,
                               void* dk, void* dv, Strides s_in, Strides s_do, Strides s_out,
                               const Plan& p, int H, int T, int D, float scale, int bf16,
                               int seed, double rate, rd::Origin org, cudaStream_t stream) {
  const Drop dr = make_drop(rate, org);
  return (bf16 ? dkv_hds<__nv_bfloat16> : dkv_hds<float>)(
      q, k, v, d_o, lse, delta, lengths, dk, dv, s_in, s_do, s_out, p, H, T, D, scale, seed,
      rate, dr, stream);
}
