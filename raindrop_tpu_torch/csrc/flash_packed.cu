// Packed-heads attention, forward and backward: the Hopper counterparts of
// raindrop_tpu/ops/flash_attention.py:_packed_fwd_kernel (:566) and
// :_packed_bwd_kernel (:610).
//
// Forward: q, k, v [B, T, d] (f32 or bf16, d = nhead * hd), lengths [B]
// int32 -> o [B, T, d] f32, lse [B, nhead, T] f32 in base 2.
// Backward: + do [B, T, d] (operand type), lse, delta [B, nhead, T] f32
// -> dq, dk, dv [B, T, d] f32.
//
// What bounds it: at the training and serving shapes (P12: T=215, hd=80;
// eICU: T=300, hd=36) the forward's work is 4*B*H*T^2*hd FLOPs against
// 4*B*T*d*4 bytes, about 55 FLOP/byte, and the backward's 10*B*H*T^2*hd
// against 7 such arrays, about 80 FLOP/byte: under the H100's bf16 ridge,
// so the memory rate bounds the ideal kernels. These first kernels do
// their products in scalar f32 FMA out of shared memory, so the FMA and
// shared-memory throughput bound them instead; tensor cores (wgmma) are
// later work.
//
// Design: the TPU kernels hold one sample's [T, T] score tile in VMEM and
// isolate heads with lane masks. Neither carries over. Here one CTA takes
// one (block of 64 rows, head, sample); it indexes the head through the
// strided [B, T, H, hd] view of [B, T, d] and streams 64-row tiles of the
// other side through shared memory, so no score leaves the SM. The forward
// runs an online softmax in base 2; the backward recomputes p from the
// saved lse in two launches, dq per query block and dk, dv per key block
// (attention_bwd.cuh says why), with no atomics. Key tiles stop at the
// sample's length (the TPU kernel's -1e30 key bias, without the work on
// padded keys), and the ragged edge of T is masked instead of padding T to
// 8. Dropout is a template flag: with rate 0 the forward is the kernel
// without any mask code.
#include "attention_bwd.cuh"

namespace {

template <int MAXD, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ o, float* __restrict__ lse, int T, int d,
                  int nhead, float scale2, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::attend_rows<MAXD, kBf16, DROP, TIn>(
      q + base, k + base, v + base, d, T, length, q0, hd, scale2, smem,
      o + base + (long)q0 * d, d, lse + ((long)b * nhead + h) * T, dr);
}

template <int MAXD, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_dq_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, const TIn* __restrict__ d_o,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, float* __restrict__ dq, int T,
                 int d, int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  const long stat = ((long)b * nhead + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::attn_dq_rows<MAXD, kBf16, DROP, TIn>(
      q + base, k + base, v + base, d, d_o + base, d, lse + stat, delta + stat,
      T, length, q0, hd, scale * 1.4426950408889634f, scale, dr, smem,
      dq + base, d);
}

template <int MAXD, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_dkv_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, const TIn* __restrict__ d_o,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ lengths, float* __restrict__ dk,
                  float* __restrict__ dv, int T, int d, int nhead, float scale,
                  int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  const long stat = ((long)b * nhead + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, (uint32_t)(b * nhead + h));
  rd::attn_dkv_rows<MAXD, kBf16, DROP, TIn>(
      q + base, k + base, v + base, d, d_o + base, d, lse + stat, delta + stat,
      T, length, k0, hd, scale * 1.4426950408889634f, scale, dr, smem,
      dk + base, dv + base, d);
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > rd::MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MAXD, bool DROP, typename TIn>
int launch_fwd(const void* q, const void* k, const void* v, const void* lengths,
               void* o, void* lse, int B, int T, int d, int nhead, float scale2,
               int seed, rd::Drop dr, cudaStream_t stream) {
  const int bytes = rd::attn_smem_floats(d / nhead) * (int)sizeof(float);
  auto kern = packed_fwd_kernel<MAXD, DROP, TIn>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + rd::BQ - 1) / rd::BQ, nhead, B);
  kern<<<grid, rd::NT, bytes, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const int*)lengths,
      (float*)o, (float*)lse, T, d, nhead, scale2, seed, dr);
  return (int)cudaGetLastError();
}

template <int MAXD, bool DROP, typename TIn>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, const void* lengths, void* dq,
               void* dk, void* dv, int B, int T, int d, int nhead, float scale,
               int seed, rd::Drop dr, cudaStream_t stream) {
  const int hd = d / nhead;
  const int bytes_q = rd::attn_dq_smem_floats(hd) * (int)sizeof(float);
  const int bytes_kv = rd::attn_dkv_smem_floats(hd) * (int)sizeof(float);
  auto kq = packed_dq_kernel<MAXD, DROP, TIn>;
  auto kkv = packed_dkv_kernel<MAXD, DROP, TIn>;
  cudaError_t err = allow_smem(kq, bytes_q);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kkv, bytes_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + rd::BQ - 1) / rd::BQ, nhead, B);
  kq<<<grid, rd::NT, bytes_q, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dq,
      T, d, nhead, scale, seed, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<grid, rd::NT, bytes_kv, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dk,
      (float*)dv, T, d, nhead, scale, seed, dr);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int T, int d, int nhead, double rate) {
  return B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 ||
         d % nhead != 0 || !(rate >= 0.0 && rate < 1.0);
}

}  // namespace

// F<MAXD, DROP, TIn>(args...) for the run-time head dim, rate and type.
#define RD_DISPATCH(F, hd, rate, bf16, ...)                                   \
  RD_DISPATCH_HD(hd, {                                                        \
    if ((rate) > 0.0) {                                                       \
      return (bf16) ? F<MAXD, true, __nv_bfloat16>(__VA_ARGS__)               \
                    : F<MAXD, true, float>(__VA_ARGS__);                      \
    }                                                                         \
    return (bf16) ? F<MAXD, false, __nv_bfloat16>(__VA_ARGS__)                \
                  : F<MAXD, false, float>(__VA_ARGS__);                       \
  })

extern "C" int rd_packed_fwd(const void* q, const void* k, const void* v,
                             const void* lengths, void* o, void* lse, int B,
                             int T, int d, int nhead, float scale2, int bf16,
                             int seed, double rate, void* stream) {
  if (bad_shape(B, T, d, nhead, rate)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::Drop dr = rd::make_drop(rate);
  RD_DISPATCH(launch_fwd, d / nhead, rate, bf16, q, k, v, lengths, o, lse, B, T,
              d, nhead, scale2, seed, dr, s);
}

// scale = 1/sqrt(hd), without log2(e).
extern "C" int rd_packed_bwd(const void* q, const void* k, const void* v,
                             const void* d_o, const void* lse, const void* delta,
                             const void* lengths, void* dq, void* dk, void* dv,
                             int B, int T, int d, int nhead, float scale,
                             int bf16, int seed, double rate, void* stream) {
  if (bad_shape(B, T, d, nhead, rate)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::Drop dr = rd::make_drop(rate);
  RD_DISPATCH(launch_bwd, d / nhead, rate, bf16, q, k, v, d_o, lse, delta,
              lengths, dq, dk, dv, B, T, d, nhead, scale, seed, dr, s);
}
