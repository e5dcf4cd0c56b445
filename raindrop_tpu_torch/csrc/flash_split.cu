// Split-head attention at any T, forward and backward: the Hopper
// counterparts of the five flash_mha kernels of
// raindrop_tpu/ops/flash_attention.py: _fused_fwd_kernel (:121) and
// _fused_bwd_kernel (:146), one program per head while a [T, T] score tile
// fits the TPU's VMEM (T padded to 8 <= 1024), and _fwd_kernel (:191),
// _dq_kernel (:237), _dkv_kernel (:275), 128-row blocks with an online
// softmax beyond.
//
// Forward: q, k, v [B, H, T, D] (f32 or bf16), lengths [B] int32 ->
// o [B, H, T, D] f32, lse [B, H, T] f32 in base 2.
// Backward: + do [B, H, T, D] (operand type), lse, delta [B, H, T] f32 ->
// dq, dk, dv [B, H, T, D] f32.
// Every [B, H, T, D] array comes with its (batch, head, row) strides in
// elements and a unit last stride, so the [B, T, H, D] view of the model's
// projection is read in place and o is written merged: the two transposed
// copies the TPU route pays around its kernel do not exist here.
//
// What bounds it: 4*B*H*T^2*D FLOPs forward (10 backward) against
// 4*B*H*T*D elements, T FLOP per element: at T = 2048 with bf16 operands
// (about 680 FLOP/byte) past the H100's bf16 ridge of 295, so the tensor
// cores bound the ideal kernel; at T = 600 (about 200 FLOP/byte) the
// memory rate does. These first kernels do their products in scalar f32
// FMA out of shared memory, which bounds them instead; wgmma is later work.
//
// Design: the TPU's two regimes exist because its fast memory holds a
// whole [1024, 1024] tile; an SM's 227 KB holds none the model uses, so
// there is one regime. One CTA takes one (block of G::ROWS rows, head,
// sample) and streams G::KEYS-row tiles of the other side through shared
// memory with the device code of the packed-heads kernels (attention.cuh,
// attention_bwd.cuh), in the geometry G that RD_DISPATCH_GEOM picks by the
// head dim: Narrow (64-row blocks and tiles, 4 threads a row) up to hd 192,
// Wide (32, 8 threads a row) up to 368, so every preset's sensor-wise head
// (PAM-sw 170, P12-sw 360) runs here. Operands are read one element at a
// time, so a head may start at any element offset of a row (hd 170 bf16:
// 340 bytes a head). An online softmax in base 2 forward; p recomputed
// from the saved lse in two launches backward, dq per query block and dk,
// dv per key block, with fixed summation orders and no atomics. Key tiles
// stop at the sample's length; T is padded neither to 8 nor to 128 and D
// not to 128 (TPU tiling). The dropout mask is the counter hash of
// (seed, b * H + h, global row, global column), which is what both TPU
// regimes draw (their block coordinates times the block size plus the
// in-block index is the global index); the geometry does not enter it.
#include "attention_bwd.cuh"

namespace {

// (batch, head, row) strides in elements of one [B, H, T, D] array
struct Strides {
  long b, h, t;
};

__device__ __forceinline__ long head_base(const Strides& s, int b, int h) {
  return (long)b * s.b + (long)h * s.h;
}

template <int MAXD, typename G, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
split_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ lse, Strides s_in,
                 Strides s_out, int H, int T, int D, float scale2, int seed,
                 rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, (uint32_t)(b * H + h));
  rd::attend_rows<MAXD, kBf16, DROP, TIn, G>(
      q + in, k + in, v + in, s_in.t, T, length, q0, D, scale2, smem,
      o + head_base(s_out, b, h) + (long)q0 * s_out.t, s_out.t,
      lse + ((long)b * H + h) * T, dr);
}

template <int MAXD, typename G, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
split_dq_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                const TIn* __restrict__ v, const TIn* __restrict__ d_o,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lengths, float* __restrict__ dq,
                Strides s_in, Strides s_do, Strides s_out, int H, int T, int D,
                float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  const long stat = ((long)b * H + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, (uint32_t)(b * H + h));
  rd::attn_dq_rows<MAXD, kBf16, DROP, TIn, G>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t,
      lse + stat, delta + stat, T, length, q0, D, scale * 1.4426950408889634f,
      scale, dr, smem, dq + head_base(s_out, b, h), s_out.t);
}

template <int MAXD, typename G, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
split_dkv_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, const TIn* __restrict__ d_o,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, float* __restrict__ dk,
                 float* __restrict__ dv, Strides s_in, Strides s_do,
                 Strides s_out, int H, int T, int D, float scale, int seed,
                 rd::Drop dr) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(lengths[b], 0), T);
  const long in = head_base(s_in, b, h);
  const long out = head_base(s_out, b, h);
  const long stat = ((long)b * H + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, (uint32_t)(b * H + h));
  rd::attn_dkv_rows<MAXD, kBf16, DROP, TIn, G>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t,
      lse + stat, delta + stat, T, length, k0, D, scale * 1.4426950408889634f,
      scale, dr, smem, dk + out, dv + out, s_out.t);
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > rd::MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Shared bytes of the forward, dq and dk/dv kernels at head dim D in the
// geometry G: the one sizing the launches below and rd_split_smem use.
template <typename G>
void smem_bytes(int D, int* out) {
  out[0] = rd::attn_smem_floats<G>(D) * (int)sizeof(float);
  out[1] = rd::attn_dq_smem_floats<G>(D) * (int)sizeof(float);
  out[2] = rd::attn_dkv_smem_floats<G>(D) * (int)sizeof(float);
}

// One CTA per G::ROWS rows: in the Wide geometry a grid sized by Narrow's
// 64 would leave rows 32-63 of every block unwritten.
template <typename G>
dim3 grid_of(int B, int H, int T) {
  return dim3((T + G::ROWS - 1) / G::ROWS, H, B);
}

template <int MAXD, typename G, bool DROP, typename TIn>
int launch_fwd(const void* q, const void* k, const void* v, const void* lengths,
               void* o, void* lse, Strides s_in, Strides s_out, int B, int H,
               int T, int D, float scale2, int seed, rd::Drop dr,
               cudaStream_t stream) {
  int bytes[3];
  smem_bytes<G>(D, bytes);
  auto kern = split_fwd_kernel<MAXD, G, DROP, TIn>;
  cudaError_t err = allow_smem(kern, bytes[0]);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_of<G>(B, H, T), rd::NT, bytes[0], stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const int*)lengths,
      (float*)o, (float*)lse, s_in, s_out, H, T, D, scale2, seed, dr);
  return (int)cudaGetLastError();
}

template <int MAXD, typename G, bool DROP, typename TIn>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, const void* lengths, void* dq,
               void* dk, void* dv, Strides s_in, Strides s_do, Strides s_out,
               int B, int H, int T, int D, float scale, int seed, rd::Drop dr,
               cudaStream_t stream) {
  int bytes[3];
  smem_bytes<G>(D, bytes);
  auto kq = split_dq_kernel<MAXD, G, DROP, TIn>;
  auto kkv = split_dkv_kernel<MAXD, G, DROP, TIn>;
  cudaError_t err = allow_smem(kq, bytes[1]);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kkv, bytes[2]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of<G>(B, H, T);
  kq<<<grid, rd::NT, bytes[1], stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dq,
      s_in, s_do, s_out, H, T, D, scale, seed, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<grid, rd::NT, bytes[2], stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dk,
      (float*)dv, s_in, s_do, s_out, H, T, D, scale, seed, dr);
  return (int)cudaGetLastError();
}

// grid.y = H and grid.z = B are capped at 65535
bool bad_shape(int B, int H, int T, int D, double rate) {
  return B <= 0 || B > 65535 || H <= 0 || H > 65535 || T <= 0 || D <= 0 ||
         !(rate >= 0.0 && rate < 1.0);
}

Strides strides_at(const long long* s, int i) {
  return Strides{(long)s[3 * i], (long)s[3 * i + 1], (long)s[3 * i + 2]};
}

}  // namespace

// F<MAXD, G, DROP, TIn>(args...) for the run-time head dim, rate and type:
// the Narrow geometry up to hd 192, Wide up to 368 (RD_DISPATCH_GEOM).
#define RD_DISPATCH(F, hd, rate, bf16, ...)                                   \
  RD_DISPATCH_GEOM(hd, {                                                      \
    if ((rate) > 0.0) {                                                       \
      return (bf16) ? F<MAXD, G, true, __nv_bfloat16>(__VA_ARGS__)            \
                    : F<MAXD, G, true, float>(__VA_ARGS__);                   \
    }                                                                         \
    return (bf16) ? F<MAXD, G, false, __nv_bfloat16>(__VA_ARGS__)             \
                  : F<MAXD, G, false, float>(__VA_ARGS__);                    \
  })

// The shared bytes of the forward, dq and dk/dv kernels at head dim D, in
// the geometry the entry points below launch; cudaErrorInvalidValue for a
// head dim they do not take or a kernel that would not fit a block.
extern "C" int rd_split_smem(int D, int* out) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  RD_DISPATCH_GEOM(D, {
    smem_bytes<G>(D, out);
    return (out[0] > rd::MAX_SMEM || out[1] > rd::MAX_SMEM ||
            out[2] > rd::MAX_SMEM) ? (int)cudaErrorInvalidValue : 0;
  });
}

// strides: (batch, head, row) of q/k/v, then of o; host memory, int64.
extern "C" int rd_split_fwd(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, void* lse,
                            const long long* strides, int B, int H, int T, int D,
                            float scale2, int bf16, int seed, double rate,
                            void* stream) {
  if (bad_shape(B, H, T, D, rate)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::Drop dr = rd::make_drop(rate);
  const Strides s_in = strides_at(strides, 0), s_out = strides_at(strides, 1);
  RD_DISPATCH(launch_fwd, D, rate, bf16, q, k, v, lengths, o, lse, s_in, s_out,
              B, H, T, D, scale2, seed, dr, s);
}

// strides: of q/k/v, of do, of dq/dk/dv. scale = 1/sqrt(D), without log2(e).
extern "C" int rd_split_bwd(const void* q, const void* k, const void* v,
                            const void* d_o, const void* lse, const void* delta,
                            const void* lengths, void* dq, void* dk, void* dv,
                            const long long* strides, int B, int H, int T, int D,
                            float scale, int bf16, int seed, double rate,
                            void* stream) {
  if (bad_shape(B, H, T, D, rate)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::Drop dr = rd::make_drop(rate);
  const Strides s_in = strides_at(strides, 0), s_do = strides_at(strides, 1),
                s_out = strides_at(strides, 2);
  RD_DISPATCH(launch_bwd, D, rate, bf16, q, k, v, d_o, lse, delta, lengths, dq,
              dk, dv, s_in, s_do, s_out, B, H, T, D, scale, seed, dr, s);
}
