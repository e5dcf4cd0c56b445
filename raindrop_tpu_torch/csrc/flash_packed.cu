// Packed-heads attention, forward and backward: the Hopper counterparts of
// raindrop_tpu/ops/flash_attention.py:_packed_fwd_kernel (:566) and
// :_packed_bwd_kernel (:610).
//
// Forward: q, k, v [B, T, d] (f32 or bf16, d = nhead * hd), lengths [B]
// int32 -> o [B, T, d] f32, lse [B, nhead, T] f32 in base 2.
// Backward: + do [B, T, d] (operand type), o [B, T, d] f32, lse -> dq, dk,
// dv [B, T, d] f32, through delta [B, nhead, T] f32 (row_delta.cuh, a
// launch of its own before dq and dk/dv, into the caller's buffer).
//
// What bounds it: at the training and serving shapes (P12: T=215, hd=80,
// d=160; eICU: T=300, hd=36, d=72) the forward's work is 4*H*T*hd FLOPs a
// live key against 3 bf16 inputs (k and v below each length only) and an
// f32 output, about 55 FLOP/byte, and the backward's 10*H*T*hd against 4
// bf16 inputs and 3 f32 outputs, about 60 FLOP/byte: far under the H100's
// bf16 ridge (about 295), so the memory rate bounds the ideal kernels (P12,
// B=128, lengths uniform on 0..T: about 35 MB forward, 11 us; 80 MB
// backward, 24 us). The first kernels did every product in scalar f32 FMA
// out of shared memory with one-element synchronous loads, 20x off that.
//
// Three routes, chosen by the wrapper's launch plan (packed_plan in
// ops/flash_attention.py), which the entry points check:
// - "tc", bf16 operands up to hd_pad 144: attention_tc.cuh, launched from
//   flash_packed_{fwd,dq,dkv}_tc.cu. The products run on the tensor cores
//   (wgmma m64nNk16, bf16 in, f32 accumulate; one warpgroup per 64 rows,
//   two CTAs per key block in the dk/dv pass), and the streamed tiles come through a
//   two-stage cp.async ring, the next tile in flight while the current one
//   is multiplied, with a copy width the alignment allows.
// - "tc_wide", bf16 operands at hd 145-368 (P12's sensor-wise hd 360):
//   attention_tc_wide.cuh, launched from flash_packed_{fwd,dq,dkv}_wide.cu.
//   The same products on two warpgroups a CTA, each owning half of the
//   output's columns, with 32-row streamed tiles (that header says why).
//   The tensor-core kernels take (batch, head, row) strides: flash_split.cu
//   (flash_mha) launches them too, on its own.
// - "scalar", f32 operands, and bf16 on request to measure the previous
//   design: attend_rows / attn_dq_rows / attn_dkv_rows, scalar f32 FMA, in
//   the Narrow geometry up to hd 192 and the Wide one (32-row blocks and
//   tiles, attention.cuh says why) up to hd 368. TF32 would not hold the
//   f32 route's 1e-4.
// - "tc_cluster", bf16 operands past hd 368 up to 2048 (P12's sensor-wise
//   model at one head, hd 720): attention_tc_cluster.cuh, launched from
//   flash_packed_{fwd,dq,dkv}_tcc.cu. The same products on a cluster of
//   ceil(hd / 256) CTAs, each owning a slice of the head's columns; the
//   partial scores of the slices meet in distributed shared memory.
// - "hd_stream", f32 operands past hd 368, bf16 past 2048 (and on request
//   at any hd): attention_hd_stream.cuh, launched from flash_packed_hds.cu.
//   The scalar Wide routines' function and bits in shared memory that does
//   not grow with hd: the head dim streamed in chunks through the score
//   products, the outputs' columns split over the grid's x axis.
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
#include <algorithm>
#include <cstring>
#include <initializer_list>

#include "attention_bwd.cuh"
#include "flash_packed.cuh"
#include "row_delta.cuh"

namespace {

using rd::packed::Plan;
using rd::packed::allow_smem;

template <int MAXD, typename G, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ o, float* __restrict__ lse, int T, int d,
                  int nhead, float scale2, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attend_rows<MAXD, kBf16, DROP, TIn, G>(
      q + base, k + base, v + base, d, T, length, q0, hd, scale2, smem,
      o + base + (long)q0 * d, d, lse + ((long)b * nhead + h) * T, dr);
}

template <int MAXD, typename G, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_dq_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, const TIn* __restrict__ d_o,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, float* __restrict__ dq, int T,
                 int d, int nhead, float scale, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  const long stat = ((long)b * nhead + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attn_dq_rows<MAXD, kBf16, DROP, TIn, G>(
      q + base, k + base, v + base, d, d_o + base, d, lse + stat, delta + stat,
      T, length, q0, hd, scale * 1.4426950408889634f, scale, dr, smem,
      dq + base, d);
}

template <int MAXD, typename G, bool DROP, typename TIn>
__global__ void __launch_bounds__(rd::NT)
packed_dkv_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, const TIn* __restrict__ d_o,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ lengths, float* __restrict__ dk,
                  float* __restrict__ dv, int T, int d, int nhead, float scale,
                  int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const long base = (long)b * T * d + (long)h * hd;
  const long stat = ((long)b * nhead + h) * T;
  constexpr bool kBf16 = sizeof(TIn) == 2;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attn_dkv_rows<MAXD, kBf16, DROP, TIn, G>(
      q + base, k + base, v + base, d, d_o + base, d, lse + stat, delta + stat,
      T, length, k0, hd, scale * 1.4426950408889634f, scale, dr, smem,
      dk + base, dv + base, d);
}

template <typename G>
void scalar_smem(Plan& p, int hd) {
  p.rows = G::ROWS;
  p.smem_fwd = rd::attn_smem_floats<G>(hd) * (int)sizeof(float);
  p.smem_dq = rd::attn_dq_smem_floats<G>(hd) * (int)sizeof(float);
  p.smem_dkv = rd::attn_dkv_smem_floats<G>(hd) * (int)sizeof(float);
}

// The plan this file would make for the call, the copy width aside (the
// wrapper lowers it to the pointers' alignment; copy_ok checks it).
Plan expected_plan(int B, int T, int d, int nhead, int bf16, int route) {
  const int hd = d / nhead;
  Plan p{};
  p.route = route;
  if (route == 1) {
    p.hd_pad = rd::tc::pad16(hd);
    p.rows = rd::tc::ROWS;
    p.smem_fwd = rd::tc::fwd_smem_bytes(hd);
    p.smem_dq = rd::tc::dq_smem_bytes(hd);
    p.smem_dkv = rd::tc::dkv_smem_bytes(hd);
    p.threads_fwd = p.threads_dq = p.threads_dkv = rd::tc::WG;
  } else if (route == 2) {
    p.hd_pad = rd::tc::wide_pad(hd);
    p.rows = rd::tc::ROWS;
    p.smem_fwd = rd::tc::wide_fwd_smem_bytes(hd);
    p.smem_dq = rd::tc::wide_dq_smem_bytes(hd);
    p.smem_dkv = rd::tc::wide_dkv_smem_bytes(hd);
    p.threads_fwd = p.threads_dq = p.threads_dkv = rd::tc::WIDE_THREADS;
  } else if (route == 3) {
    rd::packed::hds_plan(p, hd, bf16);
  } else if (route == 5) {
    rd::packed::tcc_plan(p, hd);
  } else {
    p.hd_pad = hd;
    p.copy_bytes = bf16 ? 2 : 4;
    if (hd <= rd::NARROW_MAX_HD) {
      scalar_smem<rd::Narrow>(p, hd);
    } else {
      scalar_smem<rd::Wide>(p, hd);
    }
    p.threads_fwd = p.threads_dq = p.threads_dkv = rd::NT;
  }
  p.cols = hd;
  p.grid_x = (T + p.rows - 1) / p.rows *
             (route == 3 ? rd::hs::slices(hd) : route == 5 ? rd::tcc::cluster_size(hd) : 1);
  p.grid_y = nhead;
  p.grid_z = B;
  return p;
}

bool copy_ok(int W, int hd, int d, std::initializer_list<const void*> ptrs) {
  if (W != 2 && W != 4 && W != 8 && W != 16) return false;
  if ((hd * 2) % W != 0 || (d * 2) % W != 0) return false;
  for (const void* ptr : ptrs) {
    if ((uintptr_t)ptr % W != 0) return false;
  }
  return true;
}

bool route_ok(int route, int hd, int bf16) {
  if (route == 1) return bf16 && rd::tc::pad16(hd) <= rd::packed::TC_MAX_HD_PAD;
  if (route == 2) {
    return bf16 && rd::tc::pad16(hd) > rd::packed::TC_MAX_HD_PAD &&
           hd <= rd::tc::WIDE_MAX_HD_PAD;
  }
  if (route == 3) return hd >= 1;
  if (route == 5) return bf16 && hd > rd::SCALAR_MAX_HD && hd <= rd::tcc::MAX_HD;
  return route == 0 && hd <= rd::SCALAR_MAX_HD;
}

// The launch plan of this call, from the wrapper's PLAN_INTS ints: false
// unless the route is legal for the operand type, every field is what
// this file computes, the copy width fits the pointers and each kernel's
// shared memory fits a block.
bool make_plan(const int* ints, int B, int T, int d, int nhead, int bf16,
               std::initializer_list<const void*> operands, Plan* p) {
  const int route = ints[0];
  if (!route_ok(route, d / nhead, bf16)) return false;
  Plan e = expected_plan(B, T, d, nhead, bf16, route);
  if (route == 1 || route == 2 || route == 5) {
    if (!copy_ok(ints[2], d / nhead, d, operands)) return false;
    e.copy_bytes = ints[2];
  }
  if (std::max({e.smem_fwd, e.smem_dq, e.smem_dkv}) > rd::MAX_SMEM) return false;
  if (std::memcmp(&e, ints, rd::packed::PLAN_INTS * sizeof(int)) != 0) return false;
  *p = e;
  return true;
}

template <int MAXD, typename G, bool DROP, typename TIn>
int launch_fwd(const void* q, const void* k, const void* v, const void* lengths,
               void* o, void* lse, const Plan& p, int T, int d, int nhead, float scale2,
               int seed, rd::Drop dr, cudaStream_t stream) {
  auto kern = packed_fwd_kernel<MAXD, G, DROP, TIn>;
  cudaError_t err = allow_smem(kern, p.smem_fwd);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  kern<<<grid, p.threads_fwd, p.smem_fwd, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const int*)lengths,
      (float*)o, (float*)lse, T, d, nhead, scale2, seed, dr);
  return (int)cudaGetLastError();
}

template <int MAXD, typename G, bool DROP, typename TIn>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, const void* lengths, void* dq,
               void* dk, void* dv, const Plan& p, int T, int d, int nhead, float scale,
               int seed, rd::Drop dr, cudaStream_t stream) {
  auto kq = packed_dq_kernel<MAXD, G, DROP, TIn>;
  auto kkv = packed_dkv_kernel<MAXD, G, DROP, TIn>;
  cudaError_t err = allow_smem(kq, p.smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kkv, p.smem_dkv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  kq<<<grid, p.threads_dq, p.smem_dq, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dq,
      T, d, nhead, scale, seed, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<grid, p.threads_dkv, p.smem_dkv, stream>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const TIn*)d_o,
      (const float*)lse, (const float*)delta, (const int*)lengths, (float*)dk,
      (float*)dv, T, d, nhead, scale, seed, dr);
  return (int)cudaGetLastError();
}

// A launch holds at most 65535 samples and heads (the grid's z and y axes);
// the wrapper splits a larger batch into launches at their sample origins.
bool bad_shape(int B, int T, int d, int nhead, double rate) {
  return B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 ||
         d % nhead != 0 || !(rate >= 0.0 && rate < 1.0);
}

// [B, T, d] as [B, nhead, T, hd]: the strides the tensor-core launchers take
rd::packed::Strides packed_strides(int T, int d, int nhead) {
  return rd::packed::Strides{(long)T * d, (long)(d / nhead), (long)d};
}

}  // namespace

// F<MAXD, G, DROP, TIn>(args...) for the run-time head dim, rate and type.
#define RD_DISPATCH(F, hd, rate, bf16, ...)                                   \
  RD_DISPATCH_GEOM(hd, {                                                      \
    if ((rate) > 0.0) {                                                       \
      return (bf16) ? F<MAXD, G, true, __nv_bfloat16>(__VA_ARGS__)            \
                    : F<MAXD, G, true, float>(__VA_ARGS__);                   \
    }                                                                         \
    return (bf16) ? F<MAXD, G, false, __nv_bfloat16>(__VA_ARGS__)             \
                  : F<MAXD, G, false, float>(__VA_ARGS__);                    \
  })

// The shared bytes of the forward, dq and dk/dv kernels on a route (0
// scalar, 1 tensor cores, 2 tensor cores past hd_pad 144, 3 past hd 368
// or on request, 5 tensor cores past hd 368) for [B, T, d]
// operands, as the entry points below
// launch them; cudaErrorInvalidValue for a route the call cannot take or
// a kernel that would not fit a block.
extern "C" int rd_packed_smem(int B, int T, int d, int nhead, int bf16, int route,
                              int* out) {
  if (bad_shape(B, T, d, nhead, 0.0) || !route_ok(route, d / nhead, bf16))
    return (int)cudaErrorInvalidValue;
  const Plan e = expected_plan(B, T, d, nhead, bf16, route);
  out[0] = e.smem_fwd;
  out[1] = e.smem_dq;
  out[2] = e.smem_dkv;
  return std::max({e.smem_fwd, e.smem_dq, e.smem_dkv}) > rd::MAX_SMEM
             ? (int)cudaErrorInvalidValue : 0;
}

// How many clusters of the "tc_cluster" route's forward, dq and dk/dv
// kernels at head dim D the card holds at once: out[0..2];
// cudaErrorInvalidValue past the route's head dims.
extern "C" int rd_tcc_clusters(int D, int* out) {
  if (D <= rd::SCALAR_MAX_HD || D > rd::tcc::MAX_HD) return (int)cudaErrorInvalidValue;
  int err = rd::packed::clusters_fwd_tcc(D, out);
  if (err == 0) err = rd::packed::clusters_dq_tcc(D, out + 1);
  if (err == 0) err = rd::packed::clusters_dkv_tcc(D, out + 2);
  return err;
}

// plan: the wrapper's launch plan, PLAN_INTS ints (flash_packed.cuh struct
// Plan).
extern "C" int rd_packed_fwd(const void* q, const void* k, const void* v,
                             const void* lengths, void* o, void* lse, int B,
                             int T, int d, int nhead, float scale2, int bf16,
                             int seed, double rate, int b0, int h0, int heads,
                             const int* plan, void* stream) {
  const rd::Origin org{b0, h0, heads};
  if (bad_shape(B, T, d, nhead, rate) || rd::bad_origin(org, B, nhead))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(plan, B, T, d, nhead, bf16, {q, k, v}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::packed::Strides st = packed_strides(T, d, nhead);
  if (p.route == 1 || p.route == 2) {
    return (p.route == 1 ? rd::packed::launch_fwd_tc : rd::packed::launch_fwd_wide)(
        q, k, v, lengths, o, lse, st, st, p, nhead, T, d / nhead, scale2, seed, rate, org, s);
  }
  if (p.route == 3) {
    return rd::packed::launch_fwd_hds(q, k, v, lengths, o, lse, st, st, p, nhead, T,
                                      d / nhead, scale2, bf16, seed, rate, org, s);
  }
  if (p.route == 5) {
    return rd::packed::launch_fwd_tcc(q, k, v, lengths, o, lse, st, st, p, nhead, T,
                                      d / nhead, scale2, seed, rate, org, s);
  }
  const rd::Drop dr = rd::make_drop(rate, org);
  RD_DISPATCH(launch_fwd, d / nhead, rate, bf16, q, k, v, lengths, o, lse, p, T,
              d, nhead, scale2, seed, dr, s);
}

// scale = 1/sqrt(hd), without log2(e). delta: a [B, nhead, T] f32 buffer
// this call fills from do and o before the gradients' launches.
extern "C" int rd_packed_bwd(const void* q, const void* k, const void* v,
                             const void* d_o, const void* o, const void* lse, void* delta,
                             const void* lengths, void* dq, void* dk, void* dv,
                             int B, int T, int d, int nhead, float scale,
                             int bf16, int seed, double rate, int b0, int h0, int heads,
                             const int* plan, void* stream) {
  const rd::Origin org{b0, h0, heads};
  if (bad_shape(B, T, d, nhead, rate) || rd::bad_origin(org, B, nhead))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(plan, B, T, d, nhead, bf16, {q, k, v, d_o}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rd::packed::Strides st = packed_strides(T, d, nhead);
  int err = rd::launch_row_delta(bf16, d_o, o, delta, st, st, B, nhead, T, d / nhead, s);
  if (err != 0) return err;
  if (p.route == 1 || p.route == 2) {
    const bool tc = p.route == 1;
    err = (tc ? rd::packed::launch_dq_tc : rd::packed::launch_dq_wide)(
        q, k, v, d_o, lse, delta, lengths, dq, st, st, st, p, nhead, T, d / nhead, scale, seed,
        rate, org, s);
    if (err != 0) return err;
    return (tc ? rd::packed::launch_dkv_tc : rd::packed::launch_dkv_wide)(
        q, k, v, d_o, lse, delta, lengths, dk, dv, st, st, st, p, nhead, T, d / nhead, scale,
        seed, rate, org, s);
  }
  if (p.route == 3) {
    err = rd::packed::launch_dq_hds(q, k, v, d_o, lse, delta, lengths, dq, st, st, st, p,
                                    nhead, T, d / nhead, scale, bf16, seed, rate, org, s);
    if (err != 0) return err;
    return rd::packed::launch_dkv_hds(q, k, v, d_o, lse, delta, lengths, dk, dv, st, st, st,
                                      p, nhead, T, d / nhead, scale, bf16, seed, rate, org, s);
  }
  if (p.route == 5) {
    err = rd::packed::launch_dq_tcc(q, k, v, d_o, lse, delta, lengths, dq, st, st, st, p,
                                    nhead, T, d / nhead, scale, seed, rate, org, s);
    if (err != 0) return err;
    return rd::packed::launch_dkv_tcc(q, k, v, d_o, lse, delta, lengths, dk, dv, st, st, st,
                                      p, nhead, T, d / nhead, scale, seed, rate, org, s);
  }
  const rd::Drop dr = rd::make_drop(rate, org);
  RD_DISPATCH(launch_bwd, d / nhead, rate, bf16, q, k, v, d_o, lse, delta,
              lengths, dq, dk, dv, p, T, d, nhead, scale, seed, dr, s);
}
