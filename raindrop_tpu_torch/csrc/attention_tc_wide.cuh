// Tensor-core device code of the packed-heads attention for bf16 operands at
// padded head dims past attention_tc.cuh's 144 (P12's sensor-wise hd 360):
// the forward over one 64-row query block, the dq pass over one 64-row
// query block and the dk/dv pass over one 64-row key block, of one (sample,
// head), on two warpgroups. Like attention_tc.cuh's routines they take base
// pointers and a row stride (and the columns a copy reads, `cols`), so
// flash_mha runs them too. With the kernels of
// flash_packed_{fwd,dq,dkv}_wide.cu they replace, at those widths,
// raindrop_tpu/ops/flash_attention.py:_packed_fwd_kernel (:566) and
// :_packed_bwd_kernel (:610), and, launched by flash_split.cu through the
// same kernels, the flash_mha kernels (:121, :146, :191, :237, :275) at any
// T; with those of fused_encoder_{attn,dq,dkv}_wide.cu, the attention of
// raindrop_tpu/ops/fused_encoder.py:_fwd_kernel (:131) and :_bwd_kernel
// (:183) at hd 145-192 (PAM's sensor-wise 170), on the head's view of the
// fused layer's bf16 qkv rows (row stride 3 d, 4-byte copies at d = 340).
//
// What bounds it: bytes, as at hd <= 144 (P12-sw, B=128, lengths uniform on
// 0..T: about 161 MB forward, 48 us at 3.35 TB/s; 356 MB backward, 106 us;
// the products take 9 and 22 us of tensor-core time). What stood between the
// attention_tc.cuh design and these widths:
// - a 64 x 368 f32 accumulator takes 184 registers a thread of one
//   warpgroup. So two warpgroups (256 threads) share a CTA, and each owns
//   half of the output's columns (HDK / 2: 184 at hd_pad 368, 92 registers):
//   its output products read a column slice of the MN-major B tile, which
//   is a descriptor offset (c0 / 8 column blocks), and use N = HDK / 2 (a
//   wgmma takes N <= 256, so a product this wide must be split by columns
//   in any design);
// - five 64 x 368 bf16 tiles are 235,520 bytes, past a block's 232,448. So
//   the streamed side comes in 32-row tiles: the forward holds Q and a
//   two-stage ring of K and V (141,312 bytes at hd_pad 368), the dq pass Q,
//   dO and the ring of K and V (188,416), the dk/dv pass K, V, the ring of
//   Q and dO and two stages of 32 lse and delta values (188,928). One CTA
//   an SM.
// Both warpgroups compute the whole score tile (S, and dP in the backward)
// over the full K depth from the same tiles with the same instructions, so
// their probabilities, dropout keep bits and ds are the same bits, and no
// barrier or shared-memory exchange sits between the score and the output
// products. The score products are m64n32k16 over HDK / 16 k-steps, the
// output products m64n(HDK/2)k16 over the tile's two 16-row k-steps.
//
// Padded widths: 176, 208, ..., 368 (steps of 32; hd 145-176 pads to 176).
// The K depth runs over the zeroed pad columns; the kernels are latency
// bound at these widths, and half as many instantiations build in half the
// time.
#pragma once

#include "attention_tc.cuh"

namespace rd {
namespace tc {

constexpr int WIDE_THREADS = 2 * WG;  // two warpgroups a CTA
constexpr int WIDE_KEYS = 32;         // rows of a streamed tile
constexpr int WIDE_MIN_HD_PAD = 176, WIDE_STEP = 32, WIDE_MAX_HD_PAD = 368;

// The padded head dim of the wide route for hd 145 .. 368.
__host__ __device__ constexpr int wide_pad(int hd) {
  return hd <= WIDE_MIN_HD_PAD
             ? WIDE_MIN_HD_PAD
             : WIDE_MIN_HD_PAD + (hd - WIDE_MIN_HD_PAD + WIDE_STEP - 1) / WIDE_STEP * WIDE_STEP;
}

// Shared bytes of the three routines for head dim hd (keep in step with
// the mirror in tests/test_torch_packed_plan.py).
inline int wide_fwd_smem_bytes(int hd) {
  return tile_bytes(wide_pad(hd)) + 4 * tile_bytes(wide_pad(hd), WIDE_KEYS);
}
inline int wide_dq_smem_bytes(int hd) {
  return 2 * tile_bytes(wide_pad(hd)) + 4 * tile_bytes(wide_pad(hd), WIDE_KEYS);
}
inline int wide_dkv_smem_bytes(int hd) {
  return wide_dq_smem_bytes(hd) + 2 * 2 * WIDE_KEYS * (int)sizeof(float);
}

// d[64 x 32] = A B^T over K = HDK: A a 64-row tile, B a 32-row tile, both
// K-major.
template <int HDK>
__device__ __forceinline__ void mma_scores_n32(float (&d)[16], uint32_t atile, uint32_t btile) {
#pragma unroll
  for (int kk = 0; kk < HDK / 16; ++kk) {
    mma_ss_n32(d, desc_k(atile, kk), desc_k<WIDE_KEYS>(btile, kk), kk);
  }
}

// Row and column of accumulator element x of an m64n32 score tile: row
// 16 w + g + 8 i, column 8 (x / 4) + 2 t + x % 2.
__device__ __forceinline__ int acc_i(int x) { return (x >> 1) & 1; }
__device__ __forceinline__ int acc_c(int x, int t) { return 8 * (x >> 2) + 2 * t + (x & 1); }

// ---------------------------------------------------------------- forward
// attend_rows_tc on two warpgroups, for HDK = 176 .. 368: query rows q0 ..
// q0+63 of one (sample, head) against keys 0 .. length-1, online softmax in
// base 2. Warpgroup wg keeps output columns wg * HDK / 2 .. of o; both keep
// the same row statistics, and warpgroup 0 writes lse.
template <int HDK, bool DROP>
__device__ void attend_rows_tc_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, long row_stride, int T,
                                    int length, int q0, int hd, int W, float scale2,
                                    uint8_t* smem, float* __restrict__ out, long out_stride,
                                    float* __restrict__ lse, Drop dr, int cols = 0) {
  constexpr int KT = WIDE_KEYS, NH = HDK / 2, NTH = WIDE_THREADS;
  constexpr int TQ = tile_bytes(HDK), TK = tile_bytes(HDK, KT);
  const int tid = threadIdx.x, wg = tid / WG, ld = cols > 0 ? cols : hd;
  const int nrows = min(ROWS, T - q0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * hd; idx += NTH) {
      const int r = idx / hd;
      out[(long)r * out_stride + (idx - r * hd)] = 0.f;
    }
    for (int r = tid; r < nrows; r += NTH) lse[q0 + r] = NEG_INF;
    return;
  }
  // Q, then stage s: K at smem + TQ + 2 s TK, V after it
  if (HDK > ld) {
    zero_pad<HDK>(smem, 1, ld, tid, NTH);
    zero_pad<HDK, KT>(smem + TQ, 4, ld, tid, NTH);
  }
  load_tile(W, smem, q, row_stride, q0, T, ld, tid, NTH);
  load_tile<KT>(W, smem + TQ, k, row_stride, 0, length, ld, tid, NTH);
  load_tile<KT>(W, smem + TQ + TK, v, row_stride, 0, length, ld, tid, NTH);
  cp_commit();

  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int c0 = wg * NH;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) o[i] = 0.f;
  const uint32_t qa = smem_addr(smem);
  const int ntiles = (length + KT - 1) / KT;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * KT, nk = min(KT, length - k0);
    uint8_t* Kt = smem + TQ + 2 * (jt & 1) * TK;
    if (jt + 1 < ntiles) {
      uint8_t* Kn = smem + TQ + 2 * ((jt + 1) & 1) * TK;
      load_tile<KT>(W, Kn, k, row_stride, k0 + KT, length, ld, tid, NTH);
      load_tile<KT>(W, Kn + TK, v, row_stride, k0 + KT, length, ld, tid, NTH);
      cp_commit();
      tiles_ready<1>();
    } else {
      tiles_ready<0>();
    }
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    mma_fence();
    mma_scores_n32<HDK>(s, qa, smem_addr(Kt));
    mma_commit();
    mma_wait();
    reg_fence(s);

    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      s[x] *= scale2;
      if (acc_c(x, t) < nk) tmax[acc_i(x)] = fmaxf(tmax[acc_i(x)], s[x]);
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int i = acc_i(x), c = acc_c(x, t);
      const float p = c < nk ? exp2f(s[x] - m[i]) : 0.f;
      psum[i] += p;
      float pw = p;
      if constexpr (DROP) {
        const uint32_t row = (uint32_t)(q0 + 16 * w + g + 8 * i);
        pw = keep_bit(dr, row, (uint32_t)(k0 + c)) ? p * dr.inv : 0.f;
      }
      s[x] = pw;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
#pragma unroll
    for (int x = 0; x < NH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    mma_acc_rows<NH>(o, s, smem_addr(Kt + TK) + c0 / 8 * KT * 16);
    __syncthreads();  // the stage is read before the next copy refills it
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int x = 0; x < NH / 2; ++x) o[x] *= inv_l[(x >> 1) & 1];
  store_rows<NH>(o, out + c0, out_stride, nrows, hd - c0, 1.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    if (wg == 0 && r < nrows && t == 0) lse[q0 + r] = m[i] + log2f(l[i]);
  }
}

// ------------------------------------------------------------- backward
// attn_dq_rows_tc on two warpgroups: dq of query rows q0 .. q0+63 (dq
// points at the head's row 0), warpgroup wg the columns wg * HDK / 2 ..
template <int HDK, bool DROP>
__device__ void attn_dq_rows_tc_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, long row_stride,
                                     const bf16* __restrict__ d_o, long do_stride,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, int T, int length,
                                     int q0, int hd, int W, float scale2, float scale, Drop dr,
                                     uint8_t* smem, float* __restrict__ dq, long dq_stride,
                                     int cols = 0) {
  constexpr int KT = WIDE_KEYS, NH = HDK / 2, NTH = WIDE_THREADS;
  constexpr int TQ = tile_bytes(HDK), TK = tile_bytes(HDK, KT);
  const int tid = threadIdx.x, wg = tid / WG, ld = cols > 0 ? cols : hd;
  const int nrows = min(ROWS, T - q0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * hd; idx += NTH) {
      const int r = idx / hd;
      dq[(long)(q0 + r) * dq_stride + (idx - r * hd)] = 0.f;
    }
    return;
  }
  // Q, dO, then stage s: K at smem + 2 TQ + 2 s TK, V after it
  if (HDK > ld) {
    zero_pad<HDK>(smem, 2, ld, tid, NTH);
    zero_pad<HDK, KT>(smem + 2 * TQ, 4, ld, tid, NTH);
  }
  load_tile(W, smem, q, row_stride, q0, T, ld, tid, NTH);
  load_tile(W, smem + TQ, d_o, do_stride, q0, T, ld, tid, NTH);
  load_tile<KT>(W, smem + 2 * TQ, k, row_stride, 0, length, ld, tid, NTH);
  load_tile<KT>(W, smem + 2 * TQ + TK, v, row_stride, 0, length, ld, tid, NTH);
  cp_commit();

  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int c0 = wg * NH;
  bool rok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    rok[i] = r < nrows;
    lse_r[i] = rok[i] ? lse[q0 + r] : 0.f;
    delta_r[i] = rok[i] ? delta[q0 + r] : 0.f;
  }
  float acc[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = smem_addr(smem), oa = smem_addr(smem + TQ);
  const int ntiles = (length + KT - 1) / KT;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * KT, nk = min(KT, length - k0);
    uint8_t* Kt = smem + 2 * TQ + 2 * (jt & 1) * TK;
    if (jt + 1 < ntiles) {
      uint8_t* Kn = smem + 2 * TQ + 2 * ((jt + 1) & 1) * TK;
      load_tile<KT>(W, Kn, k, row_stride, k0 + KT, length, ld, tid, NTH);
      load_tile<KT>(W, Kn + TK, v, row_stride, k0 + KT, length, ld, tid, NTH);
      cp_commit();
      tiles_ready<1>();
    } else {
      tiles_ready<0>();
    }
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
    mma_scores_n32<HDK>(s, qa, smem_addr(Kt));
    mma_scores_n32<HDK>(dp, oa, smem_addr(Kt + TK));
    mma_commit();
    mma_wait();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int i = acc_i(x), c = acc_c(x, t);
      const float p = (rok[i] && c < nk) ? exp2f(s[x] * scale2 - lse_r[i]) : 0.f;
      float dpv = dp[x];
      if constexpr (DROP) {
        const uint32_t row = (uint32_t)(q0 + 16 * w + g + 8 * i);
        dpv = keep_bit(dr, row, (uint32_t)(k0 + c)) ? dpv * dr.inv : 0.f;
      }
      s[x] = p * (dpv - delta_r[i]);
    }
    mma_acc_rows<NH>(acc, s, smem_addr(Kt) + c0 / 8 * KT * 16);
    __syncthreads();
  }
  store_rows<NH>(acc, dq + (long)q0 * dq_stride + c0, dq_stride, nrows, hd - c0, scale);
}

// attn_dkv_rows_tc on two warpgroups: one output of key rows k0 .. k0+63,
// dv (role 0) or dk (role 1), warpgroup wg its columns wg * HDK / 2 ..; the
// two roles are two CTAs of one launch, as at hd <= 144 (and, as there,
// role 0 computes dP^T without using it, so no wgmma sits on a branch).
template <int HDK, bool DROP>
__device__ void attn_dkv_rows_tc_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, long row_stride,
                                      const bf16* __restrict__ d_o, long do_stride,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, int T, int length,
                                      int k0, int hd, int W, float scale2, float scale,
                                      Drop dr, uint8_t* smem, int role,
                                      float* __restrict__ out, long out_stride,
                                      int cols = 0) {
  constexpr int KT = WIDE_KEYS, NH = HDK / 2, NTH = WIDE_THREADS;
  constexpr int TQ = tile_bytes(HDK), TK = tile_bytes(HDK, KT);
  const int tid = threadIdx.x, wg = tid / WG, ld = cols > 0 ? cols : hd;
  const int nkeys = min(ROWS, T - k0);
  if (k0 >= length) {  // also every block of a sample with length 0
    for (int idx = tid; idx < nkeys * hd; idx += NTH) {
      const int r = idx / hd;
      out[(long)(k0 + r) * out_stride + (idx - r * hd)] = 0.f;
    }
    return;
  }
  // K, V, then stage s: Q at smem + 2 TQ + 2 s TK, dO after it; then the
  // stages' lse and delta values
  float* Ls = reinterpret_cast<float*>(smem + 2 * TQ + 4 * TK);  // [2][32]
  float* Dl = Ls + 2 * KT;                                       // [2][32]
  if (HDK > ld) {
    zero_pad<HDK>(smem, 2, ld, tid, NTH);
    zero_pad<HDK, KT>(smem + 2 * TQ, 4, ld, tid, NTH);
  }
  load_tile(W, smem, k, row_stride, k0, length, ld, tid, NTH);
  load_tile(W, smem + TQ, v, row_stride, k0, length, ld, tid, NTH);
  load_tile<KT>(W, smem + 2 * TQ, q, row_stride, 0, T, ld, tid, NTH);
  load_tile<KT>(W, smem + 2 * TQ + TK, d_o, do_stride, 0, T, ld, tid, NTH);
  load_vec<KT>(Ls, lse, 0, T, tid, NTH);
  load_vec<KT>(Dl, delta, 0, T, tid, NTH);
  cp_commit();

  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int c0 = wg * NH;
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = k0 + 16 * w + g + 8 * i < length;
  float acc[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
  const uint32_t ka = smem_addr(smem), va = smem_addr(smem + TQ);
  const int ntiles = (T + KT - 1) / KT;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int t0 = jt * KT, nq = min(KT, T - t0), st = jt & 1;
    uint8_t* Qt = smem + 2 * TQ + 2 * st * TK;
    if (jt + 1 < ntiles) {
      const int sn = (jt + 1) & 1;
      uint8_t* Qn = smem + 2 * TQ + 2 * sn * TK;
      load_tile<KT>(W, Qn, q, row_stride, t0 + KT, T, ld, tid, NTH);
      load_tile<KT>(W, Qn + TK, d_o, do_stride, t0 + KT, T, ld, tid, NTH);
      load_vec<KT>(Ls + sn * KT, lse, t0 + KT, T, tid, NTH);
      load_vec<KT>(Dl + sn * KT, delta, t0 + KT, T, tid, NTH);
      cp_commit();
      tiles_ready<1>();
    } else {
      tiles_ready<0>();
    }
    const float* ls = Ls + st * KT;
    const float* dl = Dl + st * KT;
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
    mma_scores_n32<HDK>(s, ka, smem_addr(Qt));
    mma_scores_n32<HDK>(dp, va, smem_addr(Qt + TK));
    mma_commit();
    mma_wait();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int i = acc_i(x), c = acc_c(x, t);
      const float p = (key_ok[i] && c < nq) ? exp2f(s[x] * scale2 - ls[c]) : 0.f;
      bool keep = true;
      if constexpr (DROP) {
        keep = keep_bit(dr, (uint32_t)(t0 + c), (uint32_t)(k0 + 16 * w + g + 8 * i));
      }
      const float inv = DROP ? dr.inv : 1.f;
      if (role == 0) {
        s[x] = keep ? p * inv : 0.f;
      } else {
        const float dpv = keep ? dp[x] * inv : 0.f;
        s[x] = p * (dpv - dl[c]);
      }
    }
    mma_acc_rows<NH>(acc, s, smem_addr(role == 0 ? Qt + TK : Qt) + c0 / 8 * KT * 16);
    __syncthreads();
  }
  store_rows<NH>(acc, out + (long)k0 * out_stride + c0, out_stride, nkeys, hd - c0,
                 role == 0 ? 1.f : scale);
}

}  // namespace tc
}  // namespace rd
