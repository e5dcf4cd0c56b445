// The launch plan of the fused encoder layer's kernels, as the wrapper
// computes it (ops/fused_encoder.py fused_plan, FusedPlan.as_ints) and as
// both entry points (fused_encoder.cu, fused_encoder_bwd.cu) recompute and
// check it field for field: per launch the route (0 scalar, 1 tensor
// cores, 2 the attention on two warpgroups past hd_pad 144, 3 the attention
// past hd 368, 4 "stream", 5 the attention on the tensor cores past hd 368),
// the rows of a CTA's tile, the copy width, the
// threads and the shared bytes. Three routes for the row products:
// - tensor cores (bf16 operands, head dims up to 192, where every tile
//   fits): the row products (qkv, the forward's tail, the backward's row
//   kernel, dx, the weight gradients) on rows_tc.cuh, qkv in bf16; the
//   attention on attention_tc.cuh while the head dim pads to at most 144
//   (PAM's 42), on attention_tc_wide.cuh's two-warpgroup routines past it
//   (route 2, "tc_wide": PAM's sensor-wise 170, padded to 176; hd 177-192
//   to 208);
// - scalar (f32 operands, bf16 where a tensor-core tile does not fit, and
//   bf16 on request to measure the previous design): the kernels of PRs
//   1-7, unchanged;
// - stream (route 4, every width the two above do not take, and on
//   request at any width): the products on rows_stream.cuh, A streamed
//   through K beside the weight (bf16 on the tensor cores, f32 scalar),
//   rows in device memory between them, the LayerNorms and dropout sites
//   as row kernels; the attention up to hd 368 in bf16 on route 1 or 2 (as
//   the packed pair's: two warpgroups past hd_pad 144), in f32 on the
//   scalar kernels, and past hd 368 in bf16 on attention_tc_cluster.cuh
//   (route 5, "tc_cluster": a cluster of CTAs a block, to hd 2048), in f32
//   (and bf16 past 2048) on attention_hd_stream.cuh (route 3,
//   "hd_stream"); the weight gradients on the kernels of the two routes
//   above. No launch's shared bytes grow with d or ffn.
#pragma once

#include <algorithm>
#include <cstring>
#include <initializer_list>

#include "attention_bwd.cuh"
#include "flash_packed.cuh"
#include "fused_rows.cuh"
#include "rows_tc.cuh"

namespace rd {
// The geometry of the "stream" route's launches (rows_stream.cuh holds
// their kernels; only the fused layer's two entry units include it)
namespace stream {

using bf16 = __nv_bfloat16;
constexpr int R = rows::R;                       // rows of a product's tile
constexpr int TC_COLS = rows::NWG * rows::NC;    // output columns of a tensor-core CTA
constexpr int CHUNK_BYTES = R * rows::KC * 2;    // a [64, 64] bf16 chunk of A
constexpr int TC_SMEM = 2 * CHUNK_BYTES + rows::RING_BYTES;
constexpr int SC_TILE = 64;                      // the scalar product's output tile
constexpr int SC_K = 16;                         // its K depth a step
constexpr int SC_SMEM = 2 * SC_K * SC_TILE * 4;  // static shared bytes
constexpr int ROW_WARPS = NT / 32;               // rows a row kernel's CTA
static_assert(TC_SMEM == 49152 && SC_SMEM == 8192, "the shared bytes fused_plan mirrors");

}  // namespace stream

namespace fused {

enum { QKV, ATTN_FWD, TAIL, BWD_ROWS, ATTN_DQ, ATTN_DKV, DX, WGRAD, NLAUNCH };
// the routes' ints (ops/flash_attention.py _ROUTES)
enum { R_SCALAR, R_TC, R_TC_WIDE, R_HD_STREAM, R_STREAM, R_TC_CLUSTER };
struct Launch {
  int route, rows, copy_bytes, threads, smem;
};
struct Plan {
  Launch l[NLAUNCH];
};
constexpr int PLAN_INTS = NLAUNCH * 5;
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is 40 ints");

constexpr int WGRAD_TILE = 64;  // weight-gradient outputs a CTA: 64 x 64
// The widest padded head dim of the attention on two warpgroups (route 2):
// the tensor-core route stops at hd NARROW_MAX_HD (192), which pads to 208;
// the "stream" route takes it to hd SCALAR_MAX_HD (368), as the packed
// pair does.
constexpr int WIDE_MAX_HD_PAD = tc::WIDE_MAX_HD_PAD;

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

// The tensor-core attention's three launches: route 1 up to hd_pad 144,
// route 2 past it.
inline void tc_attn(Plan& p, int hd, int W) {
  if (tc::pad16(hd) <= packed::TC_MAX_HD_PAD) {
    p.l[ATTN_FWD] = {1, tc::ROWS, W, tc::WG, tc::fwd_smem_bytes(hd)};
    p.l[ATTN_DQ] = {1, tc::ROWS, W, tc::WG, tc::dq_smem_bytes(hd)};
    p.l[ATTN_DKV] = {1, tc::ROWS, W, tc::WG, tc::dkv_smem_bytes(hd)};
  } else {
    p.l[ATTN_FWD] = {2, tc::ROWS, W, tc::WIDE_THREADS, tc::wide_fwd_smem_bytes(hd)};
    p.l[ATTN_DQ] = {2, tc::ROWS, W, tc::WIDE_THREADS, tc::wide_dq_smem_bytes(hd)};
    p.l[ATTN_DKV] = {2, tc::ROWS, W, tc::WIDE_THREADS, tc::wide_dkv_smem_bytes(hd)};
  }
}

// The scalar kernels' weight gradient (a 64 x 64 tile, 16 rows a step).
inline Launch scalar_wgrad(int es) { return {0, WGRAD_TILE, es, NT, 2 * 16 * WGRAD_TILE * 4}; }

// The plan of route 4 ("stream") at one width, which it takes whatever d,
// ffn and the head dim: the products (launches QKV and DX), the row
// kernels (TAIL and BWD_ROWS), the weight gradients and the attention.
inline Plan stream_plan(int d, int nhead, int bf16, int W) {
  const int hd = d / nhead, es = bf16 ? 2 : 4;
  Plan p{};
  const Launch prod = bf16 ? Launch{R_STREAM, stream::R, 16, rows::NTH, stream::TC_SMEM}
                           : Launch{R_STREAM, stream::SC_TILE, es, NT, stream::SC_SMEM};
  const Launch row = {R_STREAM, stream::ROW_WARPS, 4, NT, 0};
  p.l[QKV] = p.l[DX] = prod;
  p.l[TAIL] = p.l[BWD_ROWS] = row;
  p.l[WGRAD] = bf16 ? Launch{R_TC, WGRAD_TILE, 16, rows::WG, rows::WGRAD_BYTES}
                    : scalar_wgrad(es);
  if (bf16 && hd <= SCALAR_MAX_HD) {
    tc_attn(p, hd, W);
  } else if (bf16 && hd <= tcc::MAX_HD) {
    const int S = tcc::slice_cols(hd);
    p.l[ATTN_FWD] = {R_TC_CLUSTER, tc::ROWS, W, tcc::FWD_THREADS, tcc::fwd_smem_bytes(S)};
    p.l[ATTN_DQ] = {R_TC_CLUSTER, tc::ROWS, W, tcc::DQ_THREADS, tcc::dq_smem_bytes(S)};
    p.l[ATTN_DKV] = {R_TC_CLUSTER, tc::ROWS, W, tcc::DKV_THREADS, tcc::dkv_smem_bytes(S)};
  } else if (hd <= NARROW_MAX_HD) {
    scalar_attn<Narrow>(p, hd, es);
  } else if (hd <= SCALAR_MAX_HD) {
    scalar_attn<Wide>(p, hd, es);
  } else {
    p.l[ATTN_FWD] = {R_HD_STREAM, hs::ROWS, es, NT, hs::fwd_smem_bytes()};
    p.l[ATTN_DQ] = {R_HD_STREAM, hs::ROWS, es, NT, hs::dq_smem_bytes()};
    p.l[ATTN_DKV] = {R_HD_STREAM, hs::ROWS, es, NT, hs::dkv_smem_bytes()};
  }
  return p;
}

// The plan of route tc (1), scalar (0) or stream (4) at one width; W is
// the tensor-core attention's copy width (the wrapper's, from the
// alignment). False where the route does not take the width: no geometry
// for the head dim, tensor cores without bf16 operands, or a launch past a
// block's shared memory (route 4 takes every width). The tensor-core
// route's attention is route 1 up to hd_pad 144 and route 2 past it (to hd
// NARROW_MAX_HD, where the tensor-core route stops).
inline bool expected_plan(int d, int ffn, int nhead, int bf16, int route, int W, Plan* out) {
  if (nhead <= 0 || d <= 0 || d % nhead != 0 || ffn <= 0) return false;
  if (route == R_STREAM) {
    *out = stream_plan(d, nhead, bf16, W);
    return true;
  }
  if (route != R_SCALAR && route != R_TC) return false;
  const int tc = route;
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
    p.l[WGRAD] = scalar_wgrad(es);
  }
  if (tc) {
    tc_attn(p, hd, W);
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
// route give, with a copy width the pointers allow; false otherwise (a
// route value other than 0-4 among them: no plan holds one).
inline bool check_plan(const int* ints, int d, int ffn, int nhead, int bf16,
                       std::initializer_list<const void*> attn_operands, Plan* p) {
  const int route = ints[0];
  if (route != R_SCALAR && route != R_TC && route != R_STREAM) return false;
  const int W = ints[ATTN_FWD * 5 + 2];
  Plan e;
  if (!expected_plan(d, ffn, nhead, bf16, route, W, &e)) return false;
  const int ar = e.l[ATTN_FWD].route;
  if ((ar == R_TC || ar == R_TC_WIDE || ar == R_TC_CLUSTER) &&
      !copy_ok(W, d / nhead, d, attn_operands))
    return false;
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
// says; each returns cudaGetLastError(). Route 1: units
// fused_encoder_attn_tc.cu, fused_encoder_dq_tc.cu, fused_encoder_dkv_tc.cu
// (_tc); route 2: fused_encoder_attn_wide.cu, fused_encoder_dq_wide.cu,
// fused_encoder_dkv_wide.cu (_wide), whose kernels are instantiated for
// the padded head dims up to WIDE_MAX_HD_PAD.
int launch_attn_fwd_tc(const void* qkv, const void* lengths, void* attn, void* lse,
                       const Launch& l, int B, int T, int d, int nhead, float scale2, int seed,
                       double rate, rd::Origin org, cudaStream_t stream);
int launch_dq_tc(const void* qkv, const void* dattn, const void* lse, const void* delta,
                 const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                 int nhead, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dkv_tc(const void* qkv, const void* dattn, const void* lse, const void* delta,
                  const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                  int nhead, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_attn_fwd_wide(const void* qkv, const void* lengths, void* attn, void* lse,
                         const Launch& l, int B, int T, int d, int nhead, float scale2,
                         int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dq_wide(const void* qkv, const void* dattn, const void* lse, const void* delta,
                   const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                   int nhead, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dkv_wide(const void* qkv, const void* dattn, const void* lse, const void* delta,
                    const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                    int nhead, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
// The attention past hd 368 (route 3, "hd_stream") on the fused layer's
// f32 qkv [B, T, 3d] and d_attn [B, T, d] (each value rounded to bf16
// where bf16 is set): fused_encoder_attn_hds.cu (forward) and
// fused_encoder_bwd_hds.cu (dq, dk/dv), attention_hd_stream.cuh's routines
// on the dense rows (row stride 3d); the grid's x axis is the 32-row
// blocks times hs::slices(hd).
int launch_attn_fwd_hds(const void* qkv, const void* lengths, void* attn, void* lse,
                        const Launch& l, int B, int T, int d, int nhead, float scale2,
                        int bf16, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dq_hds(const void* qkv, const void* dattn, const void* lse, const void* delta,
                  const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                  int nhead, float scale, int bf16, int seed, double rate, rd::Origin org,
                  cudaStream_t stream);
int launch_dkv_hds(const void* qkv, const void* dattn, const void* lse, const void* delta,
                   const void* lengths, void* dqkv, const Launch& l, int B, int T, int d,
                   int nhead, float scale, int bf16, int seed, double rate, rd::Origin org,
                   cudaStream_t stream);

// The attention past hd 368 on the tensor cores (route 5, "tc_cluster") on
// the fused layer's bf16 qkv [B, T, 3d] and d_attn [B, T, d]: the packed
// pair's kernels (flash_packed_{fwd,dq,dkv}_tcc.cu, units of the fused
// layer's libraries too) on the head's view of the rows, row stride 3 d,
// into attn [B, T, d] and dqkv [B, T, 3d] f32.
inline packed::Plan tcc_launch_plan(const Launch& l, int B, int T, int d, int nhead) {
  const int hd = d / nhead;
  packed::Plan p{};
  p.route = R_TC_CLUSTER;
  packed::tcc_plan(p, hd);
  p.copy_bytes = l.copy_bytes;
  p.cols = hd;
  p.grid_x = (T + l.rows - 1) / l.rows * tcc::cluster_size(hd);
  p.grid_y = nhead;
  p.grid_z = B;
  return p;
}
inline packed::Strides rows_strides(int T, int n, int hd) {
  return packed::Strides{(long)T * n, (long)hd, (long)n};
}
inline int launch_attn_fwd_tcc(const void* qkv, const void* lengths, void* attn, void* lse,
                               const Launch& l, int B, int T, int d, int nhead, float scale2,
                               int seed, double rate, rd::Origin org, cudaStream_t stream) {
  const __nv_bfloat16* q = (const __nv_bfloat16*)qkv;
  const int hd = d / nhead;
  return packed::launch_fwd_tcc(q, q + d, q + 2 * d, lengths, attn, lse,
                                rows_strides(T, 3 * d, hd), rows_strides(T, d, hd),
                                tcc_launch_plan(l, B, T, d, nhead), nhead, T, hd, scale2, seed,
                                rate, org, stream);
}
inline int launch_dq_tcc(const void* qkv, const void* dattn, const void* lse,
                         const void* delta, const void* lengths, void* dqkv, const Launch& l,
                         int B, int T, int d, int nhead, float scale, int seed, double rate,
                         rd::Origin org, cudaStream_t stream) {
  const __nv_bfloat16* q = (const __nv_bfloat16*)qkv;
  const int hd = d / nhead;
  const packed::Strides rows3 = rows_strides(T, 3 * d, hd);
  return packed::launch_dq_tcc(q, q + d, q + 2 * d, dattn, lse, delta, lengths, dqkv, rows3,
                               rows_strides(T, d, hd), rows3, tcc_launch_plan(l, B, T, d, nhead),
                               nhead, T, hd, scale, seed, rate, org, stream);
}
inline int launch_dkv_tcc(const void* qkv, const void* dattn, const void* lse,
                          const void* delta, const void* lengths, void* dqkv, const Launch& l,
                          int B, int T, int d, int nhead, float scale, int seed, double rate,
                          rd::Origin org, cudaStream_t stream) {
  const __nv_bfloat16* q = (const __nv_bfloat16*)qkv;
  float* dq = (float*)dqkv;
  const int hd = d / nhead;
  const packed::Strides rows3 = rows_strides(T, 3 * d, hd);
  return packed::launch_dkv_tcc(q, q + d, q + 2 * d, dattn, lse, delta, lengths, dq + d,
                                dq + 2 * d, rows3, rows_strides(T, d, hd), rows3,
                                tcc_launch_plan(l, B, T, d, nhead), nhead, T, hd, scale, seed,
                                rate, org, stream);
}

}  // namespace fused
}  // namespace rd
