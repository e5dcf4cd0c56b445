// The fused encoder layer's "stream" route (route 4 of fused_plan.cuh):
// the row products with the activation operand streamed through K, and
// the row kernels between them, in shared memory that does not grow with
// the layer's width.
//
// What it replaces: at widths past PAM's sensor-wise (d 340), the row
// kernels of the other routes no longer fit an SM. Those keep a whole
// [64, K] operand tile and the layer's rows (f32 [64, d] and [64, ffn]
// buffers) in shared memory: the backward's row kernel needs 229,376 bytes
// at d 340 on the tensor cores, and at P12's sensor-wise width (d 720, ffn
// 288) 0.5 MB. The JAX kernel (raindrop_tpu/ops/fused_encoder.py:131,
// :183) keeps a whole sample in VMEM; no SM holds one.
//
// Design: each product is a launch of its own, out[m][n] = sum_k A[m][k]
// B[n][k] (+ bias[n]) (+ add[m][n]) over the f32 rows A [M, K] in device
// memory, its output's columns split over CTAs:
// - bf16 operands (stream_rows_tc): a CTA is two warpgroups on 64 rows and
//   128 output columns; per 64-deep step of K it stages A's 64 x 64 chunk
//   as a bf16 K-major tile (rounding as it goes) beside the packed weight's
//   step (rows_tc.cuh's panels, by cp.async), both double-buffered, and
//   runs rows_tc.cuh's wgmma step m64n64k16 four times a step; 49,152
//   shared bytes at any K;
// - f32 operands (stream_rows_scalar): a 64 x 64 output tile a CTA, 16-deep
//   steps of A and the weight (read [N, K] or transposed) staged in
//   shared memory, 4 x 4 outputs a thread, scalar FMA; 8,192 bytes.
// The LayerNorms, the three dropout sites (keyed (seed, b, site) with row
// term site * t8 + row, the masks of the other routes), the relu, delta
// and the bias and LayerNorm gradients' column sums are row kernels over
// the rows in device memory: one warp a row (two passes over it for its
// statistics, a third for the result), or one thread a column in fixed
// 512-row chunks whose partials a second pass adds in chunk order. The
// price is device-memory traffic: every product's operand and output make
// a round trip the other routes keep in shared memory. No atomics: a
// repeat gives the same bits.
#pragma once

#include <type_traits>

#include "fused_plan.cuh"

namespace rd {
namespace stream {

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// The keep factor of element (row m, column n) of a site's mask: 1 / (1 -
// rate) where kept, 0 where dropped (1 without dropout). m = b T + t.
template <bool DROP>
__device__ __forceinline__ float site_keep(Drop dr, int seed, long m, int T, uint32_t site,
                                           int n) {
  if constexpr (DROP) {
    const int b = (int)(m / T), t = (int)(m - (long)b * T);
    dr.base = drop_base(seed, dr.row(b));
    const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
    return keep_bit(dr, site * t8 + (uint32_t)t, (uint32_t)n) ? dr.inv : 0.f;
  } else {
    return 1.f;
  }
}

}  // namespace stream
}  // namespace rd

namespace {

// out[m][n] = sum_k rd(A[m][k]) B[n][k] (+ bias[n]) (+ add[m][n]), rounded
// to bf16 where round_out is set, for 64 rows (blockIdx.x) and 128 output
// columns (blockIdx.y) of out [M, N]; wp is the packed bf16 B (rows_tc.cuh
// pack_weights_kernel: step (s, q) of the 128-column group s and K panel q
// at element 8192 (s KP / 64 + q)). Warpgroup v owns the columns 64 v ..
// 64 v + 63 of the CTA's 128; every thread of the block stages A.
template <typename TO>
__global__ void __launch_bounds__(rd::rows::NTH)
stream_rows_tc(const float* __restrict__ A, long M, int K, const __nv_bfloat16* __restrict__ wp, int N,
               const float* __restrict__ bias, const float* __restrict__ add,
               TO* __restrict__ out, int round_out) {
  using namespace rd::rows;
  namespace tc = rd::tc;
  extern __shared__ __align__(128) uint8_t smem_stream[];
  uint8_t* chunks = smem_stream;                          // two [64, 64] chunks of A
  uint8_t* ring = smem_stream + 2 * rd::stream::CHUNK_BYTES;  // two steps of the weight
  const long row0 = (long)blockIdx.x * R;
  const int nrows = (int)(M - row0 < R ? M - row0 : R);
  const int kpanels = pad64(K) / KC;
  const int tid = threadIdx.x, v = tid / WG;
  const uint8_t* src0 = reinterpret_cast<const uint8_t*>(wp) +
                        (long)blockIdx.y * kpanels * STEP_BYTES;
  const float* arow = A + row0 * K;
  auto issue = [&](int q) {  // the weight's step q into the ring
    if (q < kpanels) {
      const uint8_t* src = src0 + (long)q * STEP_BYTES;
      const uint32_t dst = tc::smem_addr(ring + (q % STAGES) * STEP_BYTES);
#pragma unroll
      for (int i = 0; i < STEP_BYTES / 16 / NTH; ++i) {
        const int off = 16 * (tid + i * NTH);
        tc::cp_async<16>(dst + off, src + off, true);
      }
    }
    tc::cp_commit();
  };
  auto stage = [&](int q) {  // A's columns 64 q .. 64 q + 63, rounded to bf16
    stage_rows(chunks + (q & 1) * rd::stream::CHUNK_BYTES, arow + q * KC, K, nrows,
               min(KC, K - q * KC), KC);
  };
  issue(0);
  stage(0);
  const int lane = tid & 31, w = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int q = 0; q < kpanels; ++q) {
    tc::cp_wait<0>();   // the weight's step q has landed (this thread's copies)
    tc::proxy_fence();  // ... and the chunk's stores, for wgmma
    __syncthreads();    // every thread's; every product of step q - 1 done
    issue(q + 1);       // into the stage step q - 1 used
    const uint32_t a = tc::smem_addr(chunks + (q & 1) * rd::stream::CHUNK_BYTES);
    const uint32_t b = tc::smem_addr(ring + (q % STAGES) * STEP_BYTES + v * PANEL_BYTES);
    tc::reg_fence(acc);
    tc::mma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      tc::mma_ss_n64(acc, tc::desc_k(a, kk), tc::desc_k(b, kk), 1);
    }
    tc::mma_commit();
    if (q + 1 < kpanels) stage(q + 1);  // the other chunk, while the products run
    tc::mma_wait();
    tc::reg_fence(acc);
  }
  tc::cp_wait<0>();
  const int c0 = blockIdx.y * rd::stream::TC_COLS + v * NC;
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int r = 16 * w + g + 8 * ((x >> 1) & 1);
    const int n = c0 + 8 * (x >> 2) + 2 * t + (x & 1);
    if (r < nrows && n < N) {
      const long o = (row0 + r) * N + n;
      float y = acc[x];
      if (bias != nullptr) y += bias[n];
      if (add != nullptr) y += add[o];
      if (round_out) y = rd::opnd<true>(y);
      rd::stream::store(out + o, y);
    }
  }
}

// out[m][n] = sum_k A[m][k] B[n][k] (+ bias[n]) (+ add[m][n]) in f32 for a
// 64 x 64 tile of out [M, N] (blockIdx.x rows, blockIdx.y columns); B[n][k]
// = W[n * K + k] (W torch-layout [N, K], a forward product) or, with
// trans, W[k * N + n] (W [K, N], the backward's product through it). Each
// 16-deep step stages A's and B's 64 x 16 blocks k-major in shared memory;
// thread (tm, tn) sums rows 4 tm .. 4 tm + 3 by columns 4 tn .. 4 tn + 3
// over k in order.
__global__ void __launch_bounds__(rd::NT)
stream_rows_scalar(const float* __restrict__ A, long M, int K, const float* __restrict__ W,
                   int trans, int N, const float* __restrict__ bias,
                   const float* __restrict__ add, float* __restrict__ out) {
  using rd::stream::SC_K;
  using rd::stream::SC_TILE;
  __shared__ __align__(16) float As[SC_K][SC_TILE];
  __shared__ __align__(16) float Ws[SC_K][SC_TILE];
  const long m0 = (long)blockIdx.x * SC_TILE;
  const int n0 = blockIdx.y * SC_TILE;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[u][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += SC_K) {
#pragma unroll
    for (int it = 0; it < SC_K * SC_TILE / rd::NT; ++it) {
      const int idx = threadIdx.x + it * rd::NT;
      {  // a row's 16 k side by side in global memory
        const int kk = idx % SC_K, mm = idx / SC_K;
        const long m = m0 + mm;
        const int k = k0 + kk;
        As[kk][mm] = (m < M && k < K) ? A[m * K + k] : 0.f;
      }
      // neighbouring threads on neighbouring addresses of W either way
      const int kk = trans ? idx / SC_TILE : idx % SC_K;
      const int nn = trans ? idx % SC_TILE : idx / SC_K;
      const int n = n0 + nn, k = k0 + kk;
      Ws[kk][nn] = (n < N && k < K) ? (trans ? W[(long)k * N + n] : W[(long)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SC_K; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tn * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][j] = fmaf(a4[u], w4[j], acc[u][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long m = m0 + tm * 4 + u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (m < M && n < N) {
        float y = acc[u][j];
        if (bias != nullptr) y += bias[n];
        if (add != nullptr) y += add[m * N + n];
        out[m * N + n] = y;
      }
    }
  }
}

// Row m of [M, d]: h = res + y * keep(site) (y alone where site is 0),
// then LayerNorm: xhat = (h - mean) / sqrt(var + 1e-5) (the arithmetic of
// the other routes' LayerNorms). Writes gamma xhat + beta into out (where
// gamma is given), xhat into xhat and 1/std into rstd (where given); h is
// held in xhat, or else in out, between the passes. y may alias out. One
// warp a row.
template <bool DROP>
__global__ void __launch_bounds__(rd::NT)
stream_ln_rows(const float* __restrict__ res, const float* y, uint32_t site,
               const float* __restrict__ gamma, const float* __restrict__ beta, float* out,
               float* xhat, float* __restrict__ rstd, long M, int T, int d, int seed,
               rd::Drop dr) {
  const int lane = threadIdx.x & 31;
  const long m = (long)blockIdx.x * rd::stream::ROW_WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  float* h = (xhat != nullptr ? xhat : out) + m * d;
  const float* r = res + m * d;
  const float* yr = y + m * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float k = site ? rd::stream::site_keep<DROP>(dr, seed, m, T, site, c) : 1.f;
    const float v = r[c] + yr[c] * k;
    h[c] = v;
    s += v;
  }
  const float mu = rd::stream::warp_sum(s) / d;
  float vs = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float u = h[c] - mu;
    vs += u * u;
  }
  const float rs = rsqrtf(rd::stream::warp_sum(vs) / d + 1e-5f);
  for (int c = lane; c < d; c += 32) {
    const float xh = (h[c] - mu) * rs;
    if (xhat != nullptr) xhat[m * d + c] = xh;
    if (gamma != nullptr) out[m * d + c] = xh * gamma[c] + beta[c];
  }
  if (rstd != nullptr && lane == 0) rstd[m] = rs;
}

// Row m: dh = (G gamma - mean(G gamma) - xhat mean(G gamma xhat)) rstd,
// the LayerNorm backward; dsite = dh * keep(site) (dh where site is 0).
template <bool DROP>
__global__ void __launch_bounds__(rd::NT)
stream_ln_bwd_rows(const float* __restrict__ G, const float* __restrict__ xhat,
                   const float* __restrict__ rstd, const float* __restrict__ gamma,
                   uint32_t site, float* __restrict__ dh, float* __restrict__ dsite, long M,
                   int T, int d, int seed, rd::Drop dr) {
  const int lane = threadIdx.x & 31;
  const long m = (long)blockIdx.x * rd::stream::ROW_WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  const float* gr = G + m * d;
  const float* xr = xhat + m * d;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dxh = gr[c] * gamma[c];
    s1 += dxh;
    s2 += dxh * xr[c];
  }
  const float m1 = rd::stream::warp_sum(s1) / d, m2 = rd::stream::warp_sum(s2) / d;
  const float rs = rstd[m];
  for (int c = lane; c < d; c += 32) {
    const float v = (gr[c] * gamma[c] - m1 - xr[c] * m2) * rs;
    dh[m * d + c] = v;
    dsite[m * d + c] = site ? v * rd::stream::site_keep<DROP>(dr, seed, m, T, site, c) : v;
  }
}

// The FFN hidden [M, ffn] in place: forward F = relu(F) * keep(site 102);
// backward (with f, the forward's F) F = f > 0 ? F * keep : 0, where f > 0
// exactly where the mask kept the value and the pre-activation was
// positive.
template <bool DROP>
__global__ void __launch_bounds__(rd::NT)
stream_relu(float* __restrict__ F, const float* __restrict__ f, long n, int ffn, int T,
            int seed, rd::Drop dr) {
  for (long i = (long)blockIdx.x * rd::NT + threadIdx.x; i < n; i += (long)gridDim.x * rd::NT) {
    if (f != nullptr) {
      F[i] = f[i] > 0.f ? (DROP ? F[i] * dr.inv : F[i]) : 0.f;
    } else {
      const long m = i / ffn;
      F[i] = fmaxf(F[i], 0.f) * rd::stream::site_keep<DROP>(dr, seed, m, T, 102u,
                                                             (int)(i - m * ffn));
    }
  }
}

// Row m: delta[b][h][t] = sum over head h's columns of d_attn * attn; and,
// where op is given, d_attn rounded to bf16 into op (the tensor-core
// attention's operand).
__global__ void __launch_bounds__(rd::NT)
stream_delta_rows(const float* __restrict__ dattn, const float* __restrict__ attn,
                  float* __restrict__ delta, __nv_bfloat16* __restrict__ op, long M, int T, int d,
                  int nhead) {
  const int lane = threadIdx.x & 31;
  const long m = (long)blockIdx.x * rd::stream::ROW_WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  const int b = (int)(m / T), t = (int)(m - (long)b * T), hd = d / nhead;
  for (int h = 0; h < nhead; ++h) {
    float s = 0.f;
    for (int c = h * hd + lane; c < (h + 1) * hd; c += 32) {
      const float v = dattn[m * d + c];
      s += v * attn[m * d + c];
      if (op != nullptr) op[m * d + c] = __float2bfloat16(v);
    }
    s = rd::stream::warp_sum(s);
    if (lane == 0) delta[((long)b * nhead + h) * T + t] = s;
  }
}

// part[s][c] = sum over the rows m of chunk s (in order) of P[m][c] (*
// Q[m][c] where Q is given), c < ncols; a thread a column.
__global__ void __launch_bounds__(rd::NT)
stream_col_sums(const float* __restrict__ P, const float* __restrict__ Q, int ncols, long M,
                int chunk, float* __restrict__ part) {
  const int c = blockIdx.x * rd::NT + threadIdx.x;
  if (c >= ncols) return;
  const long m0 = (long)blockIdx.y * chunk;
  const long m1 = m0 + chunk < M ? m0 + chunk : M;
  float s = 0.f;
  for (long m = m0; m < m1; ++m) {
    s += Q != nullptr ? P[m * ncols + c] * Q[m * ncols + c] : P[m * ncols + c];
  }
  part[(long)blockIdx.y * ncols + c] = s;
}

// One product of the "stream" route, on the tensor cores (wp, the packed
// weight, given) or scalar (W, the torch-layout f32 weight, read
// transposed where trans is set): out [M, N] = A [M, K] B^T (+ bias) (+
// add), f32, or bf16 where out_bf16 is set (tensor cores only), rounded to
// bf16 in f32 where round_out is set.
inline cudaError_t stream_product(const float* A, long M, int K, const __nv_bfloat16* wp, const float* W,
                                  int trans, int N, const float* bias, const float* add,
                                  void* out, int out_bf16, int round_out,
                                  cudaStream_t stream) {
  using namespace rd::stream;
  if (wp != nullptr) {
    const dim3 grid((unsigned)((M + R - 1) / R), (N + TC_COLS - 1) / TC_COLS);
    auto run = [&](auto* o) {
      auto kern = stream_rows_tc<std::remove_pointer_t<decltype(o)>>;
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
      if (err != cudaSuccess) return err;
      kern<<<grid, rd::rows::NTH, TC_SMEM, stream>>>(A, M, K, wp, N, bias, add, o, round_out);
      return cudaGetLastError();
    };
    return out_bf16 ? run((__nv_bfloat16*)out) : run((float*)out);
  } else {
    if (out_bf16 || round_out) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)((M + SC_TILE - 1) / SC_TILE), (N + SC_TILE - 1) / SC_TILE);
    stream_rows_scalar<<<grid, rd::NT, 0, stream>>>(A, M, K, W, trans, N, bias, add,
                                                    (float*)out);
  }
  return cudaGetLastError();
}

// The grid of a row kernel over M rows (a warp each), and of an
// elementwise one over n elements (a grid-stride loop past 2^20 blocks).
inline dim3 stream_row_grid(long M) {
  return dim3((unsigned)((M + rd::stream::ROW_WARPS - 1) / rd::stream::ROW_WARPS));
}
inline dim3 stream_elem_grid(long n) {
  const long blocks = (n + rd::NT - 1) / rd::NT;
  return dim3((unsigned)(blocks < (1L << 20) ? blocks : (1L << 20)));
}

}  // namespace
