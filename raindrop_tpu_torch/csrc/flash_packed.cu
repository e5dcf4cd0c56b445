// Packed-heads attention forward: the Hopper counterpart of
// raindrop_tpu/ops/flash_attention.py:_packed_fwd_kernel (:566).
//
// q, k, v [B, T, d] (f32 or bf16, d = nhead * hd), lengths [B] int32 ->
// o [B, T, d] f32, lse [B, nhead, T] f32 in base 2.
//
// What bounds it: at the serving shapes (P12: T=215, hd=80; eICU: T=300,
// hd=36) the work is 4*B*H*T^2*hd FLOPs against 4*B*T*d*4 bytes, about
// 55 FLOP/byte: under the H100's bf16 ridge, so the memory rate bounds
// the ideal kernel. This first kernel does its products in scalar f32 FMA
// out of shared memory, so the FMA and shared-memory issue rate bound it
// instead; tensor cores (wgmma) are later work.
//
// Design: the TPU kernel holds one sample's [T, T] score tile in VMEM and
// isolates heads with lane masks. Neither carries over. Here one CTA
// takes one (query block of 64 rows, head, sample); it indexes the head
// through the strided [B, T, H, hd] view of [B, T, d] and streams 64-key
// tiles of K and V through shared memory with an online softmax in base 2,
// so no score leaves the SM. Key tiles stop at the sample's length (the
// TPU kernel's -1e30 key bias, without the work on padded keys), and the
// ragged edge of T is masked instead of padding T to 8.
#include "attention.cuh"

namespace {

template <int MAXD, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ o, float* __restrict__ lse, int T, int d,
                  int nhead, float scale2) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  rd::attend_rows<MAXD, kBf16, TIn>(q + base, k + base, v + base, d, T, length,
                                     q0, hd, scale2, smem,
                                     o + base + (long)q0 * d, d,
                                     lse + ((long)b * nhead + h) * T);
}

template <int MAXD, typename TIn>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* lse, int B, int T, int d, int nhead, float scale2,
           cudaStream_t stream) {
  const int bytes = rd::attn_smem_floats(d / nhead) * (int)sizeof(float);
  if (bytes > rd::MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = packed_fwd_kernel<MAXD, TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + rd::BQ - 1) / rd::BQ, nhead, B);
  kern<<<grid, rd::NT, bytes, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const int*)lengths,
      (float*)o, (float*)lse, T, d, nhead, scale2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rd_packed_fwd(const void* q, const void* k, const void* v,
                             const void* lengths, void* o, void* lse, int B,
                             int T, int d, int nhead, float scale2, int bf16,
                             void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 || d % nhead != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  RD_DISPATCH_HD(d / nhead, {
    return bf16 ? launch<MAXD, __nv_bfloat16>(q, k, v, lengths, o, lse, B, T,
                                              d, nhead, scale2, s)
                : launch<MAXD, float>(q, k, v, lengths, o, lse, B, T, d, nhead,
                                      scale2, s);
  });
}
