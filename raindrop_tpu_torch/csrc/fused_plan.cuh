// The launch plan of the fused encoder layer's kernels, as the wrapper
// computes it (ops/fused_encoder.py fused_plan, FusedPlan.as_ints) and as
// both entry points (fused_encoder.cu, fused_encoder_bwd.cu) recompute and
// check it field for field: per launch the route (0 scalar, 1 tensor
// cores), the rows of a CTA's tile, the copy width, the threads and the
// shared bytes. Two routes:
// - tensor cores (bf16 operands, head dims up to 192, where every tile
//   fits): the row products (qkv, the forward's tail, the backward's row
//   kernel, dx, the weight gradients) on rows_tc.cuh, qkv in bf16; the
//   attention on attention_tc.cuh while the head dim pads to at most 144
//   (PAM's 42), else the scalar attention's Narrow geometry on the bf16
//   qkv (PAM's sensor-wise 170; its Wide geometry on bf16 operands spilled,
//   and no preset's head is wider than 170 here);
// - scalar (f32 operands, bf16 where a tensor-core tile does not fit, and
//   bf16 on request to measure the previous design): the kernels of PRs
//   1-7, unchanged.
#pragma once

#include <algorithm>
#include <cstring>
#include <initializer_list>

#include "attention_bwd.cuh"
#include "flash_packed.cuh"
#include "fused_rows.cuh"
#include "rows_tc.cuh"

namespace rd {
namespace fused {

enum { QKV, ATTN_FWD, TAIL, BWD_ROWS, ATTN_DQ, ATTN_DKV, DX, WGRAD, NLAUNCH };
struct Launch {
  int route, rows, copy_bytes, threads, smem;
};
struct Plan {
  Launch l[NLAUNCH];
};
constexpr int PLAN_INTS = NLAUNCH * 5;
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is 40 ints");

constexpr int WGRAD_TILE = 64;  // weight-gradient outputs a CTA: 64 x 64

// Shared floats of the scalar kernels: the forward's row-local tail (attn
// rows, later x1 + FFN; x + attention projection, later x1; the FFN
// hidden) and the backward's row kernel (the attn rows, the FFN hidden
// after them, four more [BR, d + 1] buffers, two row statistics).
__host__ __device__ inline int tail_floats(int d, int ffn) {
  return 2 * BQ * (d + 1) + BQ * (ffn + 1);
}
__host__ __device__ inline int bwd_rows_floats(int d, int ffn) {
  return BR * (d > ffn ? d + 1 : ffn + 1) + 4 * BR * (d + 1) + 2 * BR;
}
// Per-CTA column sums of the backward's row kernels: [dg2 d][dbe2 d][dbf2
// d][dbf1 ffn][dg1 d][dbe1 d][dbo d][dbqkv 3d].
__host__ __device__ inline int part_floats(int d, int ffn) { return 9 * d + ffn; }

// The scalar attention of the geometry G, operands es bytes wide.
template <typename G>
void scalar_attn(Plan& p, int hd, int es) {
  p.l[ATTN_FWD] = {0, G::ROWS, es, NT, attn_smem_floats<G>(hd) * 4};
  p.l[ATTN_DQ] = {0, G::ROWS, es, NT, attn_dq_smem_floats<G>(hd) * 4};
  p.l[ATTN_DKV] = {0, G::ROWS, es, NT, attn_dkv_smem_floats<G>(hd) * 4};
}

// The plan of route tc (1) or scalar (0) at one width; W is the tensor-core
// attention's copy width (the wrapper's, from the alignment). False where
// the route does not take the width: no geometry for the head dim, tensor
// cores without bf16 operands, or a launch past a block's shared memory.
inline bool expected_plan(int d, int ffn, int nhead, int bf16, int tc, int W, Plan* out) {
  if (nhead <= 0 || d <= 0 || d % nhead != 0 || ffn <= 0) return false;
  const int hd = d / nhead;
  if (hd > SCALAR_MAX_HD || (tc && (!bf16 || hd > NARROW_MAX_HD))) return false;
  Plan p{};
  const int es = bf16 ? 2 : 4;
  if (tc) {
    using namespace rows;
    p.l[QKV] = {1, R, 16, NTH, qkv_smem(d)};
    p.l[TAIL] = {1, R, 16, NTH, tail_smem(d, ffn)};
    p.l[BWD_ROWS] = {1, R, 16, NTH, bwd_rows_smem(d, ffn)};
    p.l[DX] = {1, R, 16, NTH, dx_smem(d)};
    p.l[WGRAD] = {1, WGRAD_TILE, 16, WG, WGRAD_BYTES};
  } else {
    p.l[QKV] = {0, BR, es, NT, BR * (d + 1) * 4};
    p.l[TAIL] = {0, BQ, es, NT, tail_floats(d, ffn) * 4};
    p.l[BWD_ROWS] = {0, BR, es, NT, bwd_rows_floats(d, ffn) * 4};
    p.l[DX] = {0, BR, es, NT, BR * (3 * d + 1) * 4};
    p.l[WGRAD] = {0, WGRAD_TILE, es, NT, 2 * 16 * WGRAD_TILE * 4};
  }
  if (tc && tc::pad16(hd) <= packed::TC_MAX_HD_PAD) {
    p.l[ATTN_FWD] = {1, tc::ROWS, W, tc::WG, tc::fwd_smem_bytes(hd)};
    p.l[ATTN_DQ] = {1, tc::ROWS, W, tc::WG, tc::dq_smem_bytes(hd)};
    p.l[ATTN_DKV] = {1, tc::ROWS, W, tc::WG, tc::dkv_smem_bytes(hd)};
  } else if (hd <= NARROW_MAX_HD) {
    scalar_attn<Narrow>(p, hd, es);
  } else {
    scalar_attn<Wide>(p, hd, es);
  }
  for (const Launch& l : p.l) {
    if (l.smem > MAX_SMEM) return false;
  }
  *out = p;
  return true;
}

// The tensor-core attention's copy width: it divides the head's offset in
// a row (2 hd bytes), the row strides of qkv (6 d) and d_attn (2 d) and
// every base pointer.
inline bool copy_ok(int W, int hd, int d, std::initializer_list<const void*> ptrs) {
  if (W != 2 && W != 4 && W != 8 && W != 16) return false;
  if ((2 * hd) % W != 0 || (2 * d) % W != 0) return false;
  for (const void* ptr : ptrs) {
    if ((uintptr_t)ptr % W != 0) return false;
  }
  return true;
}

// The wrapper's plan (PLAN_INTS ints) if it is the one this width and
// route give, with a copy width the pointers allow; false otherwise.
inline bool check_plan(const int* ints, int d, int ffn, int nhead, int bf16,
                       std::initializer_list<const void*> attn_operands, Plan* p) {
  const int tc = ints[0];
  if (tc != 0 && tc != 1) return false;
  const int W = ints[ATTN_FWD * 5 + 2];
  Plan e;
  if (!expected_plan(d, ffn, nhead, bf16, tc, W, &e)) return false;
  if (e.l[ATTN_FWD].route == 1 && !copy_ok(W, d / nhead, d, attn_operands)) return false;
  if (std::memcmp(&e, ints, sizeof(Plan)) != 0) return false;
  *p = e;
  return true;
}

// Offsets (bf16 elements) of the packed weights in the wrapper's buffer:
// the forward's four (in_proj, out_proj, lin1, lin2 as [out, in]), then
// the backward's four transposes (lin2, lin1, out_proj, in_proj read [in,
// out]); the forward packs the first four, the backward all eight.
enum { P_IN, P_WO, P_W1, P_W2, P_W2T, P_W1T, P_WOT, P_INT, NPACK };
struct Packed {
  long off[NPACK];
  int N[NPACK], K[NPACK];
};
inline Packed packed_layout(int d, int ffn) {
  Packed pk;
  const int n[NPACK] = {3 * d, d, ffn, d, ffn, d, d, d};
  const int k[NPACK] = {d, d, d, ffn, d, ffn, d, 3 * d};
  long off = 0;
  for (int i = 0; i < NPACK; ++i) {
    pk.off[i] = off;
    pk.N[i] = n[i];
    pk.K[i] = k[i];
    off += rows::packed_elems(n[i], k[i]);
  }
  return pk;
}

// The packing jobs of weights first .. first + n - 1 (torch-layout f32 w[i]
// for slot i; the transposed slots read the same tensors).
inline rows::PackJobs pack_jobs(const Packed& pk, const float* const* w, int n) {
  rows::PackJobs jobs{};
  jobs.n = n;
  for (int i = 0; i < n; ++i) {
    jobs.job[i] = {w[i], pk.off[i], pk.N[i], pk.K[i], i >= P_W2T ? 1 : 0};
  }
  return jobs;
}

// The tensor-core attention in the fused layer's layout (qkv [B, T, 3d]
// bf16, d_attn [B, T, d] bf16, dqkv [B, T, 3d] f32), launched as the plan
// says; each returns cudaGetLastError(). Units fused_encoder_attn_tc.cu,
// fused_encoder_dq_tc.cu, fused_encoder_dkv_tc.cu.
int launch_attn_fwd_tc(const void* qkv, const void* lengths, void* attn, void* lse,
                       const Launch& l, int B, int T, int d, int nhead, float scale2, int seed,
                       double rate, cudaStream_t stream);
int launch_dq_tc(const void* qkv, const void* dattn, const void* lse, const void* delta,
                 const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                 int nhead, float scale, int seed, double rate, cudaStream_t stream);
int launch_dkv_tc(const void* qkv, const void* dattn, const void* lse, const void* delta,
                  const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                  int nhead, float scale, int seed, double rate, cudaStream_t stream);

}  // namespace fused
}  // namespace rd
