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
// Backward: + do [B, H, T, D] (operand type), o [B, H, T, D] f32, lse ->
// dq, dk, dv [B, H, T, D] f32, through delta [B, H, T] f32 (row_delta.cuh,
// a launch of its own first, into the caller's buffer).
// Every [B, H, T, D] array comes with its (batch, head, row) strides in
// elements and a unit last stride, so the [B, T, H, D] view of the model's
// projection is read in place and o is written merged: the two transposed
// copies the TPU route pays around its kernel do not exist here.
//
// What bounds it: 4*B*H*T^2*D FLOPs forward (10 backward) against
// 4*B*H*T*D elements, T FLOP per element: at T = 2048 with bf16 operands
// (about 680 FLOP/byte) past the H100's bf16 ridge of 295, so the tensor
// cores bound the ideal kernel; at T = 600 (about 200 FLOP/byte) the
// memory rate does.
//
// Three routes, chosen by the wrapper's launch plan (split_plan in
// ops/flash_attention.py), which the entry points check as flash_packed.cu
// checks packed_plan's:
// - "tc", bf16 operands up to hd_pad 144, and "tc_wide", bf16 at hd 145-368
//   (PAM-sw's 170, P12-sw's 360): the packed pair's device routines
//   (attention_tc.cuh, attention_tc_wide.cuh: wgmma m64nNk16, bf16 in, f32
//   accumulate, a two-stage cp.async ring, one warpgroup a 64-row block, or
//   two each owning half of the output's columns), launched through the
//   packed pair's own kernels (flash_packed_{fwd,dq,dkv}_{tc,wide}.cu, in
//   this library), which take each (sample, head)'s base pointers from the
//   (batch, head, row) strides; the packed [B, T, d] layout is the strides
//   (T * d, hd, d). The dk/dv pass runs two CTAs a key block (dv and dk). The routines were written for T <= 1024 and assume nothing of
//   it: every offset past a row is a long, and the streamed loops run to the
//   sample's length. The copy width comes from the strides and the
//   alignment; the wrapper casts f32 operands into heads zero-padded to a
//   multiple of 8 columns (`cols`), so hd 42 and 170 copy by 16 bytes.
// - "scalar", f32 operands, and bf16 on request to measure the previous
//   design: the kernels below, scalar f32 FMA out of shared memory with
//   the device code of the packed-heads kernels (attention.cuh,
//   attention_bwd.cuh), in the geometry G that RD_DISPATCH_GEOM picks by
//   the head dim: Narrow (64-row blocks and tiles, 4 threads a row) up to
//   hd 192, Wide (32, 8 threads a row) up to 368. Operands are read one
//   element at a time, so a head may start at any element offset of a row.
//   TF32 would not hold the f32 route's 1e-4.
//
// - "tc_cluster", bf16 operands past hd 368 up to 2048: the packed pair's
//   kernels in flash_packed_{fwd,dq,dkv}_tcc.cu on these strides
//   (attention_tc_cluster.cuh: a cluster of CTAs a block, each owning a
//   slice of the head's columns, their partial scores summed in
//   distributed shared memory), on the padded cast as "tc".
// - "hd_stream", f32 operands past hd 368, bf16 past 2048 (and on request
//   at any hd): the packed pair's kernels in flash_packed_hds.cu on these
//   strides (attention_hd_stream.cuh: the scalar Wide routines' function
//   and bits in shared memory that does not grow with hd).
//
// Design: the TPU's two regimes exist because its fast memory holds a
// whole [1024, 1024] tile; an SM's 227 KB holds none the model uses, so
// there is one regime. One CTA takes one (block of rows, head, sample) and
// streams tiles of the other side through shared memory. An online softmax
// in base 2 forward; p recomputed from the saved lse in two launches
// backward, dq per query block and dk, dv per key block, with fixed
// summation orders and no atomics. Key tiles stop at the sample's length;
// T is padded neither to 8 nor to 128 (TPU tiling). The dropout mask is the
// counter hash of (seed, b * H + h, global row, global column), which is
// what both TPU regimes draw (their block coordinates times the block size
// plus the in-block index is the global index); neither the route nor the
// geometry enters it.
#include <algorithm>
#include <cstring>
#include <initializer_list>

#include "attention_bwd.cuh"
#include "flash_packed.cuh"
#include "row_delta.cuh"

namespace {

using rd::packed::Plan;
using rd::packed::Strides;
using rd::packed::head_base;

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
  dr.base = rd::drop_base(seed, dr.bh(b, h));
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
  dr.base = rd::drop_base(seed, dr.bh(b, h));
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
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attn_dkv_rows<MAXD, kBf16, DROP, TIn, G>(
      q + in, k + in, v + in, s_in.t, d_o + head_base(s_do, b, h), s_do.t,
      lse + stat, delta + stat, T, length, k0, D, scale * 1.4426950408889634f,
      scale, dr, smem, dk + out, dv + out, s_out.t);
}

using rd::packed::allow_smem;

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

// grid.y = H and grid.z = B are capped at 65535: the wrapper splits a larger
// call into launches at their sample and head origins
bool bad_shape(int B, int H, int T, int D, double rate) {
  return B <= 0 || B > 65535 || H <= 0 || H > 65535 || T <= 0 || D <= 0 ||
         !(rate >= 0.0 && rate < 1.0);
}

Strides strides_at(const long long* s, int i) {
  return Strides{(long)s[3 * i], (long)s[3 * i + 1], (long)s[3 * i + 2]};
}

// The plan this file would make for the call, the copy width and the
// columns a copy reads aside (the wrapper's; copy_ok checks them).
Plan expected_plan(int B, int H, int T, int D, int bf16, int route) {
  Plan p{};
  p.route = route;
  int bytes[3];
  if (route == 1) {
    p.hd_pad = rd::tc::pad16(D);
    p.rows = rd::tc::ROWS;
    bytes[0] = rd::tc::fwd_smem_bytes(D);
    bytes[1] = rd::tc::dq_smem_bytes(D);
    bytes[2] = rd::tc::dkv_smem_bytes(D);
    p.threads_fwd = p.threads_dq = p.threads_dkv = rd::tc::WG;
  } else if (route == 2) {
    p.hd_pad = rd::tc::wide_pad(D);
    p.rows = rd::tc::ROWS;
    bytes[0] = rd::tc::wide_fwd_smem_bytes(D);
    bytes[1] = rd::tc::wide_dq_smem_bytes(D);
    bytes[2] = rd::tc::wide_dkv_smem_bytes(D);
    p.threads_fwd = p.threads_dq = p.threads_dkv = rd::tc::WIDE_THREADS;
  } else if (route == 3 || route == 5) {
    if (route == 3) {
      rd::packed::hds_plan(p, D, bf16);
    } else {
      rd::packed::tcc_plan(p, D);
    }
    bytes[0] = p.smem_fwd;
    bytes[1] = p.smem_dq;
    bytes[2] = p.smem_dkv;
  } else {
    p.hd_pad = D;
    p.copy_bytes = bf16 ? 2 : 4;
    if (D <= rd::NARROW_MAX_HD) {
      smem_bytes<rd::Narrow>(D, bytes);
      p.rows = rd::Narrow::ROWS;
    } else {
      smem_bytes<rd::Wide>(D, bytes);
      p.rows = rd::Wide::ROWS;
    }
    p.threads_fwd = p.threads_dq = p.threads_dkv = rd::NT;
  }
  p.smem_fwd = bytes[0];
  p.smem_dq = bytes[1];
  p.smem_dkv = bytes[2];
  p.cols = D;
  p.grid_x = (T + p.rows - 1) / p.rows *
             (route == 3 ? rd::hs::slices(D) : route == 5 ? rd::tcc::cluster_size(D) : 1);
  p.grid_y = H;
  p.grid_z = B;
  return p;
}

bool route_ok(int route, int D, int bf16) {
  if (route == 1) return bf16 && rd::tc::pad16(D) <= rd::packed::TC_MAX_HD_PAD;
  if (route == 2) {
    return bf16 && rd::tc::pad16(D) > rd::packed::TC_MAX_HD_PAD &&
           D <= rd::tc::WIDE_MAX_HD_PAD;
  }
  if (route == 3) return D >= 1;
  if (route == 5) return bf16 && D > rd::SCALAR_MAX_HD && D <= rd::tcc::MAX_HD;
  return route == 0 && D <= rd::SCALAR_MAX_HD;
}

// A copy of W bytes reads `cols` columns of each row: W divides 2 * cols,
// every stride in bytes and every base address. cols is D, or D padded to 8
// where the wrapper's padded cast zeroed the heads' pad columns (a head
// and a row then hold at least cols columns).
bool copy_ok(int W, int cols, int D, int H, std::initializer_list<Strides> strides,
             std::initializer_list<const void*> ptrs) {
  if (W != 2 && W != 4 && W != 8 && W != 16) return false;
  if (cols != D && cols != (D + 7) / 8 * 8) return false;
  if ((2 * cols) % W != 0) return false;
  for (const Strides& s : strides) {
    if ((2 * s.b) % W != 0 || (2 * s.h) % W != 0 || (2 * s.t) % W != 0) return false;
    if (cols > D && (s.t < cols || (H > 1 && s.h < cols))) return false;
  }
  for (const void* ptr : ptrs) {
    if ((uintptr_t)ptr % W != 0) return false;
  }
  return true;
}

// The launch plan of this call, from the wrapper's PLAN_INTS + 1 ints (the
// last: the columns a copy reads): false unless the route is legal for the
// operand type, every field is what this file computes, the copy fits the
// operands and each kernel's shared memory fits a block.
bool make_plan(const int* ints, int B, int H, int T, int D, int bf16,
               std::initializer_list<Strides> strides,
               std::initializer_list<const void*> operands, Plan* p) {
  const int route = ints[0];
  if (!route_ok(route, D, bf16)) return false;
  Plan e = expected_plan(B, H, T, D, bf16, route);
  const int cols = ints[rd::packed::PLAN_INTS];
  if (route == 1 || route == 2 || route == 5) {
    if (!copy_ok(ints[2], cols, D, H, strides, operands)) return false;
    e.copy_bytes = ints[2];
    e.cols = cols;
  }
  if (std::max({e.smem_fwd, e.smem_dq, e.smem_dkv}) > rd::MAX_SMEM) return false;
  if (std::memcmp(&e, ints, rd::packed::PLAN_INTS * sizeof(int)) != 0 || cols != e.cols)
    return false;
  *p = e;
  return true;
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

// The shared bytes of the forward, dq and dk/dv kernels at head dim D on a
// route (0 scalar, 1 tensor cores, 2 tensor cores past hd_pad 144, 3 past
// hd 368 or on request, 5 tensor cores past hd 368), as the
// entry points below launch them; cudaErrorInvalidValue for a route the
// head dim cannot take or a kernel that would not fit a block.
extern "C" int rd_split_smem(int D, int route, int* out) {
  if (D <= 0 || !route_ok(route, D, route != 0)) return (int)cudaErrorInvalidValue;
  const Plan e = expected_plan(1, 1, 1, D, route != 0, route);
  out[0] = e.smem_fwd;
  out[1] = e.smem_dq;
  out[2] = e.smem_dkv;
  return std::max({e.smem_fwd, e.smem_dq, e.smem_dkv}) > rd::MAX_SMEM
             ? (int)cudaErrorInvalidValue : 0;
}

// strides: (batch, head, row) of q/k/v, then of o; host memory, int64.
// plan: the wrapper's launch plan, PLAN_INTS ints (flash_packed.cuh Plan)
// and the columns a copy reads.
extern "C" int rd_split_fwd(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, void* lse,
                            const long long* strides, int B, int H, int T, int D,
                            float scale2, int bf16, int seed, double rate,
                            int b0, int h0, int heads, const int* plan, void* stream) {
  const rd::Origin org{b0, h0, heads};
  if (bad_shape(B, H, T, D, rate) || rd::bad_origin(org, B, H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides s_in = strides_at(strides, 0), s_out = strides_at(strides, 1);
  Plan p;
  if (!make_plan(plan, B, H, T, D, bf16, {s_in}, {q, k, v}, &p))
    return (int)cudaErrorInvalidValue;
  if (p.route == 1 || p.route == 2) {
    return (p.route == 1 ? rd::packed::launch_fwd_tc : rd::packed::launch_fwd_wide)(
        q, k, v, lengths, o, lse, s_in, s_out, p, H, T, D, scale2, seed, rate, org, s);
  }
  if (p.route == 3) {
    return rd::packed::launch_fwd_hds(q, k, v, lengths, o, lse, s_in, s_out, p, H, T, D,
                                      scale2, bf16, seed, rate, org, s);
  }
  if (p.route == 5) {
    return rd::packed::launch_fwd_tcc(q, k, v, lengths, o, lse, s_in, s_out, p, H, T, D,
                                      scale2, seed, rate, org, s);
  }
  const rd::Drop dr = rd::make_drop(rate, org);
  RD_DISPATCH(launch_fwd, D, rate, bf16, q, k, v, lengths, o, lse, s_in, s_out,
              B, H, T, D, scale2, seed, dr, s);
}

// strides: of q/k/v, of do, of dq/dk/dv. scale = 1/sqrt(D), without log2(e).
// plan: as in rd_split_fwd.
extern "C" int rd_split_bwd(const void* q, const void* k, const void* v,
                            const void* d_o, const void* o, const void* lse, void* delta,
                            const void* lengths, void* dq, void* dk, void* dv,
                            const long long* strides, int B, int H, int T, int D,
                            float scale, int bf16, int seed, double rate,
                            int b0, int h0, int heads, const int* plan, void* stream) {
  const rd::Origin org{b0, h0, heads};
  if (bad_shape(B, H, T, D, rate) || rd::bad_origin(org, B, H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides s_in = strides_at(strides, 0), s_do = strides_at(strides, 1),
                s_out = strides_at(strides, 2), s_o = strides_at(strides, 3);
  Plan p;
  if (!make_plan(plan, B, H, T, D, bf16, {s_in, s_do}, {q, k, v, d_o}, &p))
    return (int)cudaErrorInvalidValue;
  int err = rd::launch_row_delta(bf16, d_o, o, delta, s_do, s_o, B, H, T, D, s);
  if (err != 0) return err;
  if (p.route == 1 || p.route == 2) {
    const bool tc = p.route == 1;
    err = (tc ? rd::packed::launch_dq_tc : rd::packed::launch_dq_wide)(
        q, k, v, d_o, lse, delta, lengths, dq, s_in, s_do, s_out, p, H, T, D, scale, seed,
        rate, org, s);
    if (err != 0) return err;
    return (tc ? rd::packed::launch_dkv_tc : rd::packed::launch_dkv_wide)(
        q, k, v, d_o, lse, delta, lengths, dk, dv, s_in, s_do, s_out, p, H, T, D, scale, seed,
        rate, org, s);
  }
  if (p.route == 3) {
    err = rd::packed::launch_dq_hds(q, k, v, d_o, lse, delta, lengths, dq, s_in, s_do, s_out,
                                    p, H, T, D, scale, bf16, seed, rate, org, s);
    if (err != 0) return err;
    return rd::packed::launch_dkv_hds(q, k, v, d_o, lse, delta, lengths, dk, dv, s_in, s_do,
                                      s_out, p, H, T, D, scale, bf16, seed, rate, org, s);
  }
  if (p.route == 5) {
    err = rd::packed::launch_dq_tcc(q, k, v, d_o, lse, delta, lengths, dq, s_in, s_do, s_out,
                                    p, H, T, D, scale, seed, rate, org, s);
    if (err != 0) return err;
    return rd::packed::launch_dkv_tcc(q, k, v, d_o, lse, delta, lengths, dk, dv, s_in, s_do,
                                      s_out, p, H, T, D, scale, seed, rate, org, s);
  }
  const rd::Drop dr = rd::make_drop(rate, org);
  RD_DISPATCH(launch_bwd, D, rate, bf16, q, k, v, d_o, lse, delta, lengths, dq,
              dk, dv, s_in, s_do, s_out, B, H, T, D, scale, seed, dr, s);
}
