// What the compilation units of the flash_packed library share: the launch
// plan and the launchers of the tensor-core kernels. Each tensor-core
// kernel family (forward, dq, dk/dv) is a unit of its own: up to hd_pad 144
// flash_packed_{fwd,dq,dkv}_tc.cu (18 instantiations each: 9 padded head
// dims, with and without dropout), past it flash_packed_{fwd,dq,dkv}_wide.cu
// (14 each: 7 padded head dims), so nvcc builds the six beside
// flash_packed.cu, which holds the entry points.
#pragma once

#include <type_traits>

#include "attention_tc_wide.cuh"

namespace rd {
namespace packed {

// A launch plan: the wrapper's (ops/flash_attention.py PackedPlan.as_ints,
// the first PLAN_INTS fields), which flash_packed.cu checks against the
// call, and the shared bytes of each kernel, which flash_packed.cu computes.
struct Plan {
  int route;       // 0 scalar, 1 tensor cores, 2 tensor cores past hd_pad 144
  int hd_pad;      // head dim padded to 16 (route 1), to 176 + 32 j (route 2), hd (0)
  int copy_bytes;  // width of one tile copy
  int rows;        // rows of a CTA's block: 64, or 32 (scalar, Wide geometry)
  int threads_fwd, threads_dq, threads_dkv;
  int grid_x, grid_y, grid_z;
  int smem_fwd, smem_dq, smem_dkv;
};
constexpr int PLAN_INTS = 10;
static_assert(sizeof(Plan) == (PLAN_INTS + 3) * sizeof(int), "Plan is 13 ints");

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
// the wide route, hd_pad = 176, 208, ..., 368.
template <int N = tc::WIDE_MIN_HD_PAD, typename F>
int with_wide_pad(int hd_pad, F&& f) {
  if constexpr (N > tc::WIDE_MAX_HD_PAD) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (hd_pad == N) return f(std::integral_constant<int, N>{});
    return with_wide_pad<N + tc::WIDE_STEP>(hd_pad, f);
  }
}

// The tensor-core kernels on [B, T, d] bf16 operands, launched on `stream`
// as the plan says (_tc: route 1, _wide: route 2); each returns
// cudaGetLastError(). scale2 = log2(e)/sqrt(hd), scale = 1/sqrt(hd).
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* lengths, void* o,
                  void* lse, const Plan& p, int T, int d, int nhead, float scale2, int seed,
                  double rate, cudaStream_t stream);
int launch_dq_tc(const void* q, const void* k, const void* v, const void* d_o,
                 const void* lse, const void* delta, const void* lengths, void* dq,
                 const Plan& p, int T, int d, int nhead, float scale, int seed, double rate,
                 cudaStream_t stream);
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* d_o,
                  const void* lse, const void* delta, const void* lengths, void* dk, void* dv,
                  const Plan& p, int T, int d, int nhead, float scale, int seed, double rate,
                  cudaStream_t stream);
int launch_fwd_wide(const void* q, const void* k, const void* v, const void* lengths, void* o,
                    void* lse, const Plan& p, int T, int d, int nhead, float scale2, int seed,
                    double rate, cudaStream_t stream);
int launch_dq_wide(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, const void* lengths, void* dq,
                   const Plan& p, int T, int d, int nhead, float scale, int seed, double rate,
                   cudaStream_t stream);
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* d_o,
                    const void* lse, const void* delta, const void* lengths, void* dk,
                    void* dv, const Plan& p, int T, int d, int nhead, float scale, int seed,
                    double rate, cudaStream_t stream);

}  // namespace packed
}  // namespace rd
