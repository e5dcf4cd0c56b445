// The attention backward's row term, delta[b, h, t] = the sum over the head's
// columns of do * o, which the dq and dk/dv kernels read. The JAX package
// computes it outside its kernel (a reduction whose order XLA picks); here
// both backward entry points (flash_packed.cu, flash_split.cu) launch this
// kernel first, on their own strides.
//
// A warp a row: lane l takes columns l, l + 32, ... in turn (0 past the head
// dim), each product and each sum rounded apart (__fmul_rn / __fadd_rn: no
// fused multiply-add), then the lanes' sums halve by xor shuffles 16, 8, 4,
// 2, 1. The order depends on the row alone, not on the launch's shape, so a
// launch over a shard of the batch or of the heads (parallel/mesh.py) gets
// the full launch's bits, and ops/flash_attention._row_delta computes the
// same bits in plain PyTorch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_packed.cuh"

namespace rd {
namespace {

constexpr int DELTA_ROWS = 8;  // rows (warps) a block

// do [B, H, T, D] (operand type) and o [B, H, T, D] f32 on (batch, head,
// row) strides with unit column strides -> delta [B, H, T] f32, dense.
template <typename TIn>
__global__ void row_delta_kernel(const TIn* __restrict__ d_o, const float* __restrict__ o,
                                 float* __restrict__ delta, packed::Strides s_do,
                                 packed::Strides s_o, int B, int H, int T, int D) {
  const long row = (long)blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
  if (row >= (long)B * H * T) return;  // the whole warp: the shuffles stay full
  const int lane = threadIdx.x % 32;
  const int h = (int)(row % H);        // heads fastest: [B, T, d] rows in order
  const long bt = row / H;
  const int t = (int)(bt % T), b = (int)(bt / T);
  const TIn* x = d_o + packed::head_base(s_do, b, h) + (long)t * s_do.t;
  const float* y = o + packed::head_base(s_o, b, h) + (long)t * s_o.t;
  float acc = lane < D ? __fmul_rn(to_f(x[lane]), y[lane]) : 0.f;
  for (int c = lane + 32; c < (D + 31) / 32 * 32; c += 32)
    acc = __fadd_rn(acc, c < D ? __fmul_rn(to_f(x[c]), y[c]) : 0.f);
#pragma unroll
  for (int w = 16; w > 0; w /= 2)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, w));
  if (lane == 0) delta[((long)b * H + h) * T + t] = acc;
}

// Launch row_delta_kernel on `stream`; 0 or the CUDA error.
inline int launch_row_delta(bool bf16, const void* d_o, const void* o, void* delta,
                            const packed::Strides& s_do, const packed::Strides& s_o,
                            int B, int H, int T, int D, cudaStream_t stream) {
  const long blocks = ((long)B * H * T + DELTA_ROWS - 1) / DELTA_ROWS;
  if (blocks <= 0 || blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  if (bf16) {
    row_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, 32 * DELTA_ROWS, 0, stream>>>(
        (const __nv_bfloat16*)d_o, (const float*)o, (float*)delta, s_do, s_o, B, H, T, D);
  } else {
    row_delta_kernel<float><<<(unsigned)blocks, 32 * DELTA_ROWS, 0, stream>>>(
        (const float*)d_o, (const float*)o, (float*)delta, s_do, s_o, B, H, T, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rd
