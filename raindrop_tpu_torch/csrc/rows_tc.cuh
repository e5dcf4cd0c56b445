// Tensor-core row products of the fused encoder layer (bf16 operands):
// y[r][n] = epi(r, n, sum_k rd(A[r][k]) * rd(B[n][k])) for a 64-row tile A
// in shared memory and a weight B that a small kernel packs into bf16
// panels once per call, plus what the fused layer's tensor-core kernels
// share: staging f32 or bf16 rows into a tile, the packing kernel, the
// qkv projection, and the shared-memory sizes (keep in step with
// fused_plan in ops/fused_encoder.py).
//
// What it replaces: rd::row_gemm_br (fused_rows.cuh), where a thread owns
// one row and four columns and issues, for every k, one shared load, four
// weight loads from L2 and five roundings for four FMAs: instruction issue
// bounded it at about 7% of the f32 FMA peak (4.5 TFLOP/s on the qkv
// projection at PAM's sensor-wise width). Here one warpgroup (128 threads)
// issues wgmma.mma_async m64n64k16 (bf16 in, f32 accumulate; rd::tc's
// mma_ss_n64, both operands K-major in shared memory, the layout and
// descriptors of attention_tc.cuh) over a tile's K, 64 output columns at a
// time, the 64 x 64 f32 accumulator in registers (32 a thread) until the
// epilogue. Two warpgroups (256 threads) share a CTA, its A tile and its
// weight ring, and take alternate 64-column chunks: a row kernel's shared
// memory admits one CTA an SM at PAM's sensor-wise width, and one
// warpgroup alone left every load, barrier and wgmma latency exposed.
//
// The weight: B is read [N, K] as given (the forward products y = a W^T,
// W torch-layout [out, in]) or transposed (the backward products y = a W,
// B[n][k] = W[k][n]). pack_weights_kernel rounds it to bf16 (exactly
// opnd<true>, so the plain versions stay the yardstick) into panels of 64
// n by 64 k, each the 8 KB image of a shared-memory tile: panel (c, q)
// holds B[64 c + i][64 q + j] at tile_off(i, j), and a step of the product
// is the two warpgroups' panels of chunks 2 s and 2 s + 1 side by side
// (step (s, q) at element 8192 (s KP / 64 + q)). A step streams by 16-byte
// cp.async with no conversion and no alignment condition on d (a d = 84
// bf16 row is 168 bytes), through a ring of two, the next step in flight
// while one is multiplied. Packing once per call, instead of
// rounding while staging, keeps every conversion out of the product loop;
// the weights are at most 1.4 MB, so the packing is a few microseconds.
//
// K is padded with zeros to a multiple of 64 (the tile's and the panel's
// columns), not of 16, so every panel is four k-steps unrolled: no wgmma
// sits under a branch on a panel's depth (ptxas would serialise every
// wgmma of the kernel). N is padded to 128 in the panels (the second
// warpgroup multiplies zeros past it); the epilogue stops at N. Rows of a tile past the caller's nrows are zero (staged so),
// and the epilogue is not called for them.
#pragma once

#include "attention_tc.cuh"

namespace rd {
namespace rows {

using bf16 = __nv_bfloat16;
constexpr int R = 64;        // rows of a tile (the wgmma M of a warpgroup)
constexpr int NC = 64;       // output columns a chunk (the wgmma N)
constexpr int KC = 64;       // K depth of a weight panel
constexpr int WG = 128;      // threads of a warpgroup
constexpr int NWG = 2;       // warpgroups of a tensor-core row kernel's CTA
constexpr int NTH = NWG * WG;  // its threads
constexpr int STAGES = 2;    // steps in the weight ring
constexpr int PANEL_BYTES = NC * KC * 2;
constexpr int STEP_BYTES = NWG * PANEL_BYTES;
constexpr int RING_BYTES = STAGES * STEP_BYTES;
// the weight gradient's (one warpgroup) two stages of a 64 x 64 G^T tile
// and a 64 x 64 A^T tile
constexpr int WGRAD_BYTES = 2 * 2 * R * KC * 2;
// A step's f32 staging buffer for rows_tc<true>: [64][SST] floats, the two
// chunks side by side (4 floats of padding a row)
constexpr int SST = NWG * NC + 4;
constexpr int STAGE_BYTES = R * SST * 4;

__host__ __device__ constexpr int pad64(int x) { return (x + 63) / 64 * 64; }
__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }
// bytes of a [64, pad64(k)] bf16 tile
__host__ __device__ constexpr int tile_bytes(int k) { return R * pad64(k) * 2; }
// bytes of a [64, n] f32 row buffer (row stride n)
__host__ __device__ constexpr int f32_rows_bytes(int n) { return align128(R * n * 4); }
// bf16 elements of a packed [N, K] weight
__host__ __device__ inline long packed_elems(int N, int K) {
  return (long)((N + NWG * NC - 1) / (NWG * NC) * (NWG * NC)) * pad64(K);
}

// Shared bytes of the tensor-core row kernels (fused_plan mirrors them).
__host__ __device__ inline int qkv_smem(int d) {
  return tile_bytes(d) + RING_BYTES + STAGE_BYTES;
}
// f32 [64, d] (x + attention projection, then x1, then h2), the attn / x1
// tile, the FFN hidden's tile, the ring
__host__ __device__ inline int tail_smem(int d, int ffn) {
  return f32_rows_bytes(d) + tile_bytes(d) + tile_bytes(ffn) + RING_BYTES;
}
// f32 [64, d] (h1, x1, h2, dh2, dx1, dh1, d_attn in turn), the d-wide
// operand tile (attn, x1, df2, dao), the FFN tile (f, then dfpre), f32
// [64, ffn] dfpre for its column sums, the ring, four row statistics
__host__ __device__ inline int bwd_rows_smem(int d, int ffn) {
  return f32_rows_bytes(d) + tile_bytes(d) + tile_bytes(ffn) + f32_rows_bytes(ffn) +
         RING_BYTES + 4 * R * 4;
}
__host__ __device__ inline int dx_smem(int d) {
  return tile_bytes(3 * d) + RING_BYTES + STAGE_BYTES;
}

// One bf16 weight to pack: B[n][k] = trans ? w[k * N + n] : w[n * K + k],
// written at out + offset.
struct PackJob {
  const float* w;
  long offset;
  int N, K, trans;
};
constexpr int MAX_PACK_JOBS = 8;
struct PackJobs {
  PackJob job[MAX_PACK_JOBS];
  int n;
};

// Element (r, c) of a [64, KP] K-major bf16 tile = rd(src[r * ld + c]) for
// r < nrows and c < ncols, zero elsewhere (pad columns and rows past the
// data). Two columns a thread: eight neighbouring lanes take the eight
// rows of one core matrix, so a warp's 4-byte stores hit 32 banks. Eight
// pairs' loads are issued before their stores: with four warps an SM
// hides nothing else of a load's latency.
template <typename T>
__device__ __forceinline__ void stage_rows(uint8_t* tile, const T* __restrict__ src, long ld,
                                           int nrows, int ncols, int KP) {
  constexpr int U = 8;
  const int pairs = KP / 2, per_blk = 8 * pairs, total = R * pairs;
  for (int base = threadIdx.x; base < total; base += U * NTH) {
    float v0[U], v1[U];
    int off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NTH;
      const int blk = idx / per_blk, rest = idx - blk * per_blk;
      const int r = 8 * blk + (rest & 7), c = 2 * (rest >> 3);
      off[u] = idx < total ? tc::tile_off(r, c) : -1;
      v0[u] = v1[u] = 0.f;
      if (idx < total && r < nrows) {
        const T* row = src + (long)r * ld;
        if (c < ncols) v0[u] = to_f(row[c]);
        if (c + 1 < ncols) v1[u] = to_f(row[c + 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (off[u] >= 0) {
        *reinterpret_cast<uint32_t*>(tile + off[u]) = tc::pack_bf16(v0[u], v1[u]);
      }
    }
  }
}

__device__ __forceinline__ void put(uint8_t* tile, int r, int c, float v) {
  *reinterpret_cast<bf16*>(tile + tc::tile_off(r, c)) = __float2bfloat16(v);
}
__device__ __forceinline__ float get(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + tc::tile_off(r, c)));
}

// Zero n bytes of shared memory (n a multiple of 16).
__device__ __forceinline__ void zero_smem(uint8_t* p, int n) {
  for (int i = threadIdx.x * 16; i < n; i += NTH * 16) {
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// epi(r, n, sum_k A[r][k] B[n][k]) for r < nrows, n < N: A a [64, KP]
// K-major bf16 tile (KP a multiple of 64; the caller's writes to it are
// made visible here), wp the packed B. Called by all 256 threads of the
// block; warpgroup v multiplies chunks 2 s + v, the accumulator of its
// 64-column chunk in registers, thread (warp w of the warpgroup, lane
// 4 g + t) holding acc[4 j + 2 i + e] at row 16 w + g + 8 i, column
// 8 j + 2 t + e of the chunk. Returns after a barrier, with the ring free
// and every epilogue write done.
//
// With STAGED, each step's two accumulators go to `stage` (f32 [64][SST])
// instead, and after a barrier all threads call epi(c0, n) for the columns
// c0 .. c0 + n - 1 of the step: an epilogue that writes device memory then
// walks whole rows (a warp a row, a lane a column), where the fragment's
// pattern (eight rows, 16 bytes each, a warp instruction) would cost far
// more store transactions than the bytes (the qkv projection's scattered
// bf16 stores took half its time).
template <bool STAGED = false, typename Epi>
__device__ void rows_tc(const uint8_t* a_tile, int KP, const bf16* __restrict__ wp, int N,
                        int nrows, uint8_t* ring, Epi epi, float* stage = nullptr) {
  const int tid = threadIdx.x, v = tid / WG;
  const int kpanels = KP / KC, steps_n = (N + NWG * NC - 1) / (NWG * NC);
  const int P = steps_n * kpanels;
  const uint8_t* src0 = reinterpret_cast<const uint8_t*>(wp);
  auto issue = [&](int p) {
    if (p < P) {  // step p is the p-th 16 KB block of the packed weight
      const uint8_t* src = src0 + (long)p * STEP_BYTES;
      const uint32_t dst = tc::smem_addr(ring + (p % STAGES) * STEP_BYTES);
#pragma unroll
      for (int i = 0; i < STEP_BYTES / 16 / NTH; ++i) {
        const int off = 16 * (tid + i * NTH);
        tc::cp_async<16>(dst + off, src + off, true);
      }
    }
    tc::cp_commit();
  };
  issue(0);

  const int lane = tid & 31, w = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const uint32_t abase = tc::smem_addr(a_tile);
  float acc[32];
  for (int p = 0; p < P; ++p) {
    const int sn = p / kpanels, q = p - sn * kpanels;
    tc::cp_wait<0>();    // step p has landed (this thread's copies)
    tc::proxy_fence();   // ... and the caller's tile writes, for wgmma
    __syncthreads();     // every thread's; every wgmma of step p - 1 done
    issue(p + 1);        // into the stage step p - 1 used
    if (q == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    const uint32_t b = tc::smem_addr(ring + (p % STAGES) * STEP_BYTES + v * PANEL_BYTES);
    tc::reg_fence(acc);
    tc::mma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      tc::mma_ss_n64(acc, tc::desc_k(abase, q * (KC / 16) + kk), tc::desc_k(b, kk), 1);
    }
    tc::mma_commit();
    tc::mma_wait();
    tc::reg_fence(acc);
    if (q == kpanels - 1) {
      const int c0 = sn * NWG * NC;
      if constexpr (STAGED) {
#pragma unroll
        for (int x = 0; x < 32; x += 2) {
          const int r = 16 * w + g + 8 * ((x >> 1) & 1);
          *reinterpret_cast<float2*>(stage + r * SST + v * NC + 8 * (x >> 2) + 2 * t) =
              make_float2(acc[x], acc[x + 1]);
        }
        __syncthreads();
        epi(c0, min(NWG * NC, N - c0));
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int r = 16 * w + g + 8 * ((x >> 1) & 1);
          const int n = c0 + v * NC + 8 * (x >> 2) + 2 * t + (x & 1);
          if (r < nrows && n < N) epi(r, n, acc[x]);
        }
      }
    }
  }
  tc::cp_wait<0>();
  __syncthreads();
}

}  // namespace rows
}  // namespace rd

namespace {

// Every job's panels: blockIdx.y picks the job, the x blocks stride over
// its elements (writes in order, reads gathered: the weights are small).
__global__ void __launch_bounds__(256)
pack_weights_kernel(rd::rows::PackJobs jobs, __nv_bfloat16* __restrict__ out) {
  using namespace rd::rows;
  const PackJob jb = jobs.job[blockIdx.y];
  const int KP = pad64(jb.K);
  const long total = packed_elems(jb.N, jb.K);
  const int kpanels = KP / KC;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long step = idx / (NWG * NC * KC);
    const int within = (int)(idx - step * (NWG * NC * KC));
    const int half = within / (NC * KC);          // the warpgroup's panel
    const int off = (within - half * NC * KC) * 2;  // byte in the panel
    const int sn = (int)(step / kpanels), q = (int)(step - (long)sn * kpanels);
    const int c = sn * NWG + half;
    // invert tile_off: (k / 8) * 1024 + (n / 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    const int kb = off >> 10, nb = (off >> 7) & 7, nr = (off >> 4) & 7, kr = (off >> 1) & 7;
    const int n = c * NC + nb * 8 + nr, k = q * KC + kb * 8 + kr;
    float v = 0.f;
    if (n < jb.N && k < jb.K) {
      v = jb.trans ? jb.w[(long)k * jb.N + n] : jb.w[(long)n * jb.K + k];
    }
    out[jb.offset + idx] = __float2bfloat16(v);
  }
}

// Launch the packing of jobs.job[0 .. n-1] on `stream`.
inline cudaError_t pack_weights(const rd::rows::PackJobs& jobs, __nv_bfloat16* out,
                                cudaStream_t stream) {
  pack_weights_kernel<<<dim3(32, jobs.n), 256, 0, stream>>>(jobs, out);
  return cudaGetLastError();
}

// qkv = rd(x) rd(W_in)^T + b_in, rounded to bf16, for a 64-row tile of [M,
// d]: the first launch of the forward and of the backward on the
// tensor-core route. w_in: the packed [3d, d] in_proj weight.
__global__ void __launch_bounds__(rd::rows::NTH)
qkv_rows_tc_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w_in,
                   const float* __restrict__ b_in, __nv_bfloat16* __restrict__ qkv, long M,
                   int d) {
  using namespace rd::rows;
  extern __shared__ __align__(128) uint8_t smem_rows[];
  const int KP = pad64(d);
  uint8_t* A = smem_rows;
  uint8_t* ring = A + tile_bytes(d);
  float* stage = reinterpret_cast<float*>(ring + RING_BYTES);
  const long row0 = (long)blockIdx.x * R;
  const int nrows = (int)(M - row0 < R ? M - row0 : R);
  stage_rows(A, x + row0 * d, d, nrows, d, KP);
  const int N = 3 * d;
  __nv_bfloat16* out = qkv + row0 * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  rows_tc<true>(A, KP, w_in, N, nrows, ring, [&](int c0, int n) {
    for (int r = warp; r < nrows; r += NTH / 32) {
      for (int j = lane; j < n; j += 32) {
        out[(long)r * N + c0 + j] = __float2bfloat16(stage[r * SST + j] + b_in[c0 + j]);
      }
    }
  }, stage);
}

}  // namespace
