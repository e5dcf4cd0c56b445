// What the compilation units of the flash_packed library share: the strides
// and launch plan of a call and the launchers of the tensor-core kernels.
// The library holds two entry-point files, flash_packed.cu
// (flash_mha_packed, [B, T, d] operands) and flash_split.cu (flash_mha,
// [B, H, T, D] operands with any (batch, head, row) strides), and one set of
// tensor-core kernels that both launch. Each kernel family (forward, dq,
// dk/dv) is a unit of its own: up to hd_pad 144
// flash_packed_{fwd,dq,dkv}_tc.cu (18 instantiations each: 9 padded head
// dims, with and without dropout), past it flash_packed_{fwd,dq,dkv}_wide.cu
// (14 each: 7 padded head dims), so nvcc builds the six beside the two
// entry-point files; flash_packed_hds.cu holds the scalar route past head
// dim 368 (attention_hd_stream.cuh, f32 and bf16 operands, 4 kernels a
// pass), and flash_packed_{fwd,dq,dkv}_tcc.cu the tensor-core route past it
// for bf16 (attention_tc_cluster.cuh, 6 kernels each: 3 column slices, with
// and without dropout; the fused layer's libraries link them too).
#pragma once

#include <type_traits>
#include <utility>

#include "attention_hd_stream.cuh"
#include "attention_tc_cluster.cuh"
#include "attention_tc_wide.cuh"

namespace rd {
namespace packed {

// (batch, head, row) strides in elements of one [B, H, T, hd] array; the
// [B, T, d] layout of flash_mha_packed is (T * d, hd, d)
struct Strides {
  long b, h, t;
};

__host__ __device__ __forceinline__ long head_base(const Strides& s, int b, int h) {
  return (long)b * s.b + (long)h * s.h;
}

// A launch plan: the wrapper's (ops/flash_attention.py PackedPlan.as_ints,
// the first PLAN_INTS fields), which the entry points check against the
// call, the columns a copy reads and the shared bytes of each kernel.
struct Plan {
  int route;       // 0 scalar, 1 tensor cores, 2 tensor cores past hd_pad 144,
                   // 3 past head dim 368 (attention_hd_stream.cuh), 5 tensor
                   // cores past it (attention_tc_cluster.cuh)
  int hd_pad;      // head dim padded to 16 (route 1), to 176 + 32 j (route 2), hd (0, 3),
                   // the cluster's columns n W (5)
  int copy_bytes;  // width of one tile copy (routes 0 and 3: one element)
  int rows;        // rows of a CTA's block: 64, or 32 (scalar, Wide geometry; route 3)
  int threads_fwd, threads_dq, threads_dkv;
  int grid_x, grid_y, grid_z;  // routes 3 and 5: x the row blocks times the column slices
  int cols;        // columns a copy reads from each row: hd; for flash_mha the
                   // wrapper's int after the first PLAN_INTS (SplitPlan.cols):
                   // hd, or hd padded to 8 where its cast zeroed the pad columns
  int smem_fwd, smem_dq, smem_dkv;
};
constexpr int PLAN_INTS = 10;
static_assert(sizeof(Plan) == (PLAN_INTS + 4) * sizeof(int), "Plan is 14 ints");

// The widest padded head dim of the one-warpgroup tensor-core kernels
// (route 1; also the fused layer's attention, fused_plan.cuh): eICU's
// sensor-wise hd 140. Past it the forward's five 64-row tiles stop fitting a
// block's shared memory at hd_pad 368 (P12's sensor-wise hd 360: 235,520
// bytes), and a 64 x 368 f32 accumulator would take 184 registers a thread:
// route 2 (attention_tc_wide.cuh) takes those widths in bf16, up to
// tc::WIDE_MAX_HD_PAD.
constexpr int TC_MAX_HD_PAD = 144;

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// f(std::integral_constant<int, HDK>) for the run-time padded head dim
// hd_pad = 16, 32, ..., 144.
template <int N = 16, typename F>
int with_hd_pad(int hd_pad, F&& f) {
  if constexpr (N > TC_MAX_HD_PAD) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (hd_pad == N) return f(std::integral_constant<int, N>{});
    return with_hd_pad<N + 16>(hd_pad, f);
  }
}

// f(std::integral_constant<int, HDK>) for the run-time padded head dim of
// the wide route, hd_pad = 176, 208, ..., MAX (368; the fused layer's
// units instantiate up to its own limit, 208).
template <int N = tc::WIDE_MIN_HD_PAD, int MAX = tc::WIDE_MAX_HD_PAD, typename F>
int with_wide_pad(int hd_pad, F&& f) {
  if constexpr (N > MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (hd_pad == N) return f(std::integral_constant<int, N>{});
    return with_wide_pad<N + tc::WIDE_STEP, MAX>(hd_pad, f);
  }
}

// The tensor-core kernels on [B, H, T, D] bf16 operands with the given
// strides (q, k, v: s_in; do: s_do; the f32 outputs: s_out), launched on
// `stream` as the plan says (_tc: route 1, _wide: route 2; the dk/dv pass
// as two CTAs a key block, 2 * grid_x); each returns cudaGetLastError().
// lse and delta are [B, H, T]. scale2 = log2(e)/sqrt(D), scale = 1/sqrt(D).
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* lengths, void* o,
                  void* lse, Strides s_in, Strides s_out, const Plan& p, int H, int T, int D,
                  float scale2, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dq_tc(const void* q, const void* k, const void* v, const void* d_o,
                 const void* lse, const void* delta, const void* lengths, void* dq,
                 Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T, int D,
                 float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* delta, const void* lengths, void* dk, void* dv,
                  Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T,
                  int D, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_fwd_wide(const void* q, const void* k, const void* v, const void* lengths, void* o,
                    void* lse, Strides s_in, Strides s_out, const Plan& p, int H, int T, int D,
                    float scale2, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dq_wide(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, const void* lengths, void* dq,
                   Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T,
                   int D, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* d_o,
                    const void* lse, const void* delta, const void* lengths, void* dk,
                    void* dv, Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H,
                    int T, int D, float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
// The route past head dim 368 (flash_packed_hds.cu), either operand type:
int launch_fwd_hds(const void* q, const void* k, const void* v, const void* lengths, void* o,
                   void* lse, Strides s_in, Strides s_out, const Plan& p, int H, int T, int D,
                   float scale2, int bf16, int seed, double rate, rd::Origin org,
                   cudaStream_t stream);
int launch_dq_hds(const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* delta, const void* lengths, void* dq,
                  Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T, int D,
                  float scale, int bf16, int seed, double rate, rd::Origin org,
                  cudaStream_t stream);
int launch_dkv_hds(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, const void* lengths, void* dk, void* dv,
                   Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T,
                   int D, float scale, int bf16, int seed, double rate, rd::Origin org,
                   cudaStream_t stream);

// The tensor-core route past head dim 368 (flash_packed_{fwd,dq,dkv}_tcc.cu),
// bf16 operands on any strides, launched in clusters of
// tcc::cluster_size(D) CTAs (the grid's x axis: the plan's row blocks times
// it, the rank fastest). dq and dk/dv write into dq, and into dk and dv,
// at s_out. Each returns the launch's error, or cudaGetLastError().
int launch_fwd_tcc(const void* q, const void* k, const void* v, const void* lengths, void* o,
                   void* lse, Strides s_in, Strides s_out, const Plan& p, int H, int T, int D,
                   float scale2, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dq_tcc(const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* delta, const void* lengths, void* dq,
                  Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T, int D,
                  float scale, int seed, double rate, rd::Origin org, cudaStream_t stream);
int launch_dkv_tcc(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, const void* lengths, void* dk, void* dv,
                   Strides s_in, Strides s_do, Strides s_out, const Plan& p, int H, int T,
                   int D, float scale, int seed, double rate, rd::Origin org,
                   cudaStream_t stream);
// How many clusters of that route's forward, dq and dk/dv kernels at head
// dim D (the dropout instantiations, the training path's; the shared bytes
// that bound it are the same without) the card holds at once
// (cudaOccupancyMaxActiveClusters).
int clusters_fwd_tcc(int D, int* out);
int clusters_dq_tcc(int D, int* out);
int clusters_dkv_tcc(int D, int* out);

// f(std::integral_constant<int, W>) for the route's columns a CTA, W =
// 192, 224 or 256.
template <typename F>
int with_slice(int W, F&& f) {
  switch (W) {
    case 192: return f(std::integral_constant<int, 192>{});
    case 224: return f(std::integral_constant<int, 224>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The configuration of a launch in clusters of n CTAs along x; `attr`
// holds its one attribute.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem, int n,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// kern<<<grid, threads, smem, stream>>>(args...) in clusters of n CTAs
// along x; the launch's error, or cudaGetLastError().
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), dim3 grid, int threads, int smem, int n,
                   cudaStream_t stream, A&&... args) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, threads, smem, n, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kern, std::forward<A>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of n CTAs of kern (threads, smem) fit the card at once.
template <typename... P>
int max_clusters(void (*kern)(P...), int threads, int smem, int n, int* out) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(64 * n), threads, smem, n, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// The plan fields of route 5 at head dim hd but the copy width, the
// columns a copy reads and the grid
inline void tcc_plan(Plan& p, int hd) {
  const int W = tcc::slice_cols(hd);
  p.hd_pad = tcc::cluster_size(hd) * W;
  p.rows = tc::ROWS;
  p.smem_fwd = tcc::fwd_smem_bytes(W);
  p.smem_dq = tcc::dq_smem_bytes(W);
  p.smem_dkv = tcc::dkv_smem_bytes(W);
  p.threads_fwd = tcc::FWD_THREADS;
  p.threads_dq = tcc::DQ_THREADS;
  p.threads_dkv = tcc::DKV_THREADS;
}

// The plan fields of route 3 at head dim hd but the grid (both entry files;
// its x axis is the row blocks times hs::slices(hd))
inline void hds_plan(Plan& p, int hd, int bf16) {
  p.hd_pad = hd;
  p.copy_bytes = bf16 ? 2 : 4;
  p.rows = hs::ROWS;
  p.smem_fwd = hs::fwd_smem_bytes();
  p.smem_dq = hs::dq_smem_bytes();
  p.smem_dkv = hs::dkv_smem_bytes();
  p.threads_fwd = p.threads_dq = p.threads_dkv = NT;
}

}  // namespace packed
}  // namespace rd
