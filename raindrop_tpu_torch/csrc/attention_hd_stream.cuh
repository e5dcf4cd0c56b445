// Device code of the attention past head dim 368 (route "hd_stream"):
// forward, dq and dk/dv of one block of rows and one slice of the output's
// columns of one (sample, head), in shared memory that does not grow with
// the head dim. flash_packed_hds.cu launches it for flash_mha_packed and
// flash_mha alike.
//
// The scalar routines (attention.cuh, attention_bwd.cuh) keep their own
// rows and a tile of each streamed operand whole in shared memory, hd + 1
// floats a row: the Wide geometry's dk/dv pass needs 197,632 bytes at hd
// 368, and no geometry fits hd 720 in the card's 227 KB. Here the two
// products that reduce over the head dim (q k^T and do v^T) stream it in
// chunks of HS_CHUNK columns through shared memory, the scores (and dp)
// accumulating in registers, and the products whose output has hd columns
// (p v, ds k, ds^T q, p^T do) read only the CTA's slice of HS_SLICE
// columns of their second operand. The grid's x axis holds the row blocks
// times the slices; each CTA of a row block recomputes the same scores and
// softmax statistics in the same order (so every slice sees the same bits)
// and owns the outputs' columns c0 .. c0 + HS_SLICE - 1. Slice 0 writes the
// forward's lse. Shared bytes: 45,568 forward, 54,016 dq, 91,392 dk/dv.
//
// The geometry is the scalar routines' Wide one (32 rows, 32-row streamed
// tiles, 8 threads a row; thread (r, j) owns the streamed rows j, j + 8, ...
// and the columns c0 + j, c0 + j + 8, ...), and every sum runs in the
// order of those routines: the scores over c = 0 .. hd - 1 in turn, the
// outputs over the streamed rows in turn. So at a head dim both take
// (impl="hd_stream" reaches this route at any hd) the results are the
// Wide kernels' bits. Scalar f32 FMA: slow (the scores are computed once a
// slice), and simple. It serves f32 operands, and bf16 past hd 2048 or on
// request (impl="hd_stream", the previous design); bf16 at hd 369-2048
// takes the tensor cores (attention_tc_cluster.cuh).
//
// Dropout hashes (query row, key column) under the (sample, head)'s base,
// as every route does: the column slice does not enter the mask.
#pragma once

#include "attention_bwd.cuh"

namespace rd {
namespace hs {

constexpr int ROWS = 32;       // rows of a CTA's own block
constexpr int KEYS = 32;       // rows of a streamed tile
constexpr int TPR = NT / ROWS;  // 8 threads a row
constexpr int NS = KEYS / TPR;  // 4 streamed rows a thread
constexpr int HS_CHUNK = 32;    // head-dim columns of a reduction's chunk
constexpr int HS_SLICE = 256;   // output columns of a CTA
constexpr int MAXC = HS_SLICE / TPR;  // 32 output columns a thread
constexpr int CP = HS_CHUNK + 1, SP = HS_SLICE + 1, PP = KEYS + 1;

__host__ __device__ constexpr int slices(int hd) { return (hd + HS_SLICE - 1) / HS_SLICE; }
constexpr int fwd_smem_bytes() { return (int)sizeof(float) * ((ROWS + KEYS) * CP + ROWS * PP + KEYS * SP); }
constexpr int dq_smem_bytes() {
  return (int)sizeof(float) * (2 * (ROWS + KEYS) * CP + ROWS * PP + KEYS * SP);
}
constexpr int dkv_smem_bytes() {
  return (int)sizeof(float) * (2 * (ROWS + KEYS) * CP + 2 * ROWS * PP + 2 * KEYS + 2 * KEYS * SP);
}
static_assert(fwd_smem_bytes() == 45568 && dq_smem_bytes() == 54016 &&
              dkv_smem_bytes() == 91392, "the shared bytes the header states");

// Rows row0 .. row0+N-1, columns col0 .. col0+ncols-1 of a head view into
// dst (row stride `ld`); rows at or past `limit` and columns past ncols up
// to `width` become zero. ROUND rounds to bf16 as load_rows does.
template <int N, bool ROUND, typename TIn>
__device__ __forceinline__ void load_block(float* dst, int ld, const TIn* __restrict__ src,
                                           long stride, int row0, int limit, int col0,
                                           int ncols, int width) {
  for (int idx = threadIdx.x; idx < N * width; idx += NT) {
    const int rr = idx / width, c = idx - rr * width;
    const float x = (row0 + rr < limit && c < ncols)
                        ? to_f(src[(long)(row0 + rr) * stride + col0 + c]) : 0.f;
    dst[rr * ld + c] = opnd<ROUND>(x);
  }
}

// The forward of query rows q0 .. q0+ROWS-1, output columns c0 ..
// c0+HS_SLICE-1 (those below hd) of one (sample, head): attend_rows's
// function and bits on those columns. out points at row q0, column 0;
// lse at this (sample, head)'s [T] (written by slice 0 only).
template <bool ROUND_P, bool DROP, typename TIn>
__device__ void attend_rows_hs(const TIn* __restrict__ q, const TIn* __restrict__ k,
                               const TIn* __restrict__ v, long row_stride, int T, int length,
                               int q0, int c0, int hd, float scale2, float* smem, float* out,
                               long out_stride, float* lse, Drop dr) {
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  float* Qc = smem;
  float* Kc = Qc + ROWS * CP;
  float* Ps = Kc + KEYS * CP;
  float* Vs = Ps + ROWS * PP;
  const int nrows = min(ROWS, T - q0), ncols = min(HS_SLICE, hd - c0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * ncols; idx += NT) {
      const int rr = idx / ncols;
      out[rr * out_stride + c0 + (idx - rr * ncols)] = 0.f;
    }
    if (c0 == 0) {
      for (int rr = tid; rr < nrows; rr += NT) lse[q0 + rr] = NEG_INF;
    }
    return;
  }
  float m = NEG_INF, l = 0.f;
  float acc[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < length; k0 += KEYS) {
    const int nk = min(KEYS, length - k0);
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += HS_CHUNK) {
      const int dc = min(HS_CHUNK, hd - d0);
      __syncthreads();  // the previous chunk (and tile) consumed
      load_block<ROWS, false>(Qc, CP, q, row_stride, q0, T, d0, dc, dc);
      load_block<KEYS, false>(Kc, CP, k, row_stride, k0, length, d0, dc, dc);
      __syncthreads();
      const float* qr = Qc + r * CP;
      for (int c = 0; c < dc; ++c) {
        const float qv = qr[c];
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = fmaf(qv, Kc[(j + TPR * i) * CP + c], s[i]);
      }
    }
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] *= scale2;
      if (j + TPR * i < nk) tmax = fmaxf(tmax, s[i]);
    }
    tmax = row_reduce<TPR, true>(tmax);
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kk = j + TPR * i;
      const float p = kk < nk ? exp2f(s[i] - m_new) : 0.f;
      psum += p;
      float pw = p;
      if constexpr (DROP) {
        pw = keep_bit(dr, (uint32_t)(q0 + r), (uint32_t)(k0 + kk)) ? p * dr.inv : 0.f;
      }
      Ps[r * PP + kk] = opnd<ROUND_P>(pw);
    }
    psum = row_reduce<TPR>(psum);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) acc[i] *= alpha;
    load_block<KEYS, false>(Vs, SP, v, row_stride, k0, length, c0, ncols, HS_SLICE);
    __syncthreads();  // the slice of v, and row r's probabilities
    const float* pr = Ps + r * PP;
    for (int kk = 0; kk < nk; ++kk) {
      const float p = pr[kk];
      const float* vr = Vs + kk * SP;
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = j + TPR * i;
        if (c < ncols) acc[i] = fmaf(p, vr[c], acc[i]);
      }
    }
  }
  if (r < nrows) {
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = j + TPR * i;
      if (c < ncols) out[r * out_stride + c0 + c] = acc[i] / l;
    }
    if (c0 == 0 && j == 0) lse[q0 + r] = m + log2f(l);
  }
}

// dq of query rows q0 .. q0+ROWS-1, columns c0 .. c0+HS_SLICE-1:
// attn_dq_rows's function and bits on those columns. dq points at this
// (sample, head)'s row 0, column 0.
template <bool BF, bool DROP, typename TIn>
__device__ void attn_dq_rows_hs(const TIn* __restrict__ q, const TIn* __restrict__ k,
                                const TIn* __restrict__ v, long row_stride,
                                const TIn* __restrict__ d_o, long do_stride,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                int T, int length, int q0, int c0, int hd, float scale2,
                                float scale, Drop dr, float* smem, float* __restrict__ dq,
                                long dq_stride) {
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  float* Qc = smem;
  float* Oc = Qc + ROWS * CP;
  float* Kc = Oc + ROWS * CP;
  float* Vc = Kc + KEYS * CP;
  float* Ds = Vc + KEYS * CP;
  float* Ks = Ds + ROWS * PP;
  const int nrows = min(ROWS, T - q0), ncols = min(HS_SLICE, hd - c0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * ncols; idx += NT) {
      const int rr = idx / ncols;
      dq[(long)(q0 + rr) * dq_stride + c0 + (idx - rr * ncols)] = 0.f;
    }
    return;
  }
  const bool rok = r < nrows;
  const float lse_r = rok ? lse[q0 + r] : 0.f;
  const float delta_r = rok ? delta[q0 + r] : 0.f;
  float acc[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < length; k0 += KEYS) {
    const int nk = min(KEYS, length - k0);
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += HS_CHUNK) {
      const int dc = min(HS_CHUNK, hd - d0);
      __syncthreads();
      load_block<ROWS, false>(Qc, CP, q, row_stride, q0, T, d0, dc, dc);
      load_block<ROWS, BF>(Oc, CP, d_o, do_stride, q0, T, d0, dc, dc);
      load_block<KEYS, false>(Kc, CP, k, row_stride, k0, length, d0, dc, dc);
      load_block<KEYS, false>(Vc, CP, v, row_stride, k0, length, d0, dc, dc);
      __syncthreads();
      const float* qr = Qc + r * CP;
      const float* orow = Oc + r * CP;
      for (int c = 0; c < dc; ++c) {
        const float qv = qr[c], ov = orow[c];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = fmaf(qv, Kc[(j + TPR * i) * CP + c], s[i]);
          dp[i] = fmaf(ov, Vc[(j + TPR * i) * CP + c], dp[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kk = j + TPR * i;
      const float p = (rok && kk < nk) ? exp2f(s[i] * scale2 - lse_r) : 0.f;
      float dpv = dp[i];
      if constexpr (DROP) {
        dpv = keep_bit(dr, (uint32_t)(q0 + r), (uint32_t)(k0 + kk)) ? dpv * dr.inv : 0.f;
      }
      Ds[r * PP + kk] = opnd<BF>(p * (dpv - delta_r));
    }
    load_block<KEYS, false>(Ks, SP, k, row_stride, k0, length, c0, ncols, HS_SLICE);
    __syncthreads();
    const float* dsr = Ds + r * PP;
    for (int kk = 0; kk < nk; ++kk) {
      const float dsv = dsr[kk];
      const float* kr = Ks + kk * SP;
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = j + TPR * i;
        if (c < ncols) acc[i] = fmaf(dsv, kr[c], acc[i]);
      }
    }
  }
  if (rok) {
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = j + TPR * i;
      if (c < ncols) dq[(long)(q0 + r) * dq_stride + c0 + c] = acc[i] * scale;
    }
  }
}

// dk and dv of key rows k0 .. k0+ROWS-1, columns c0 .. c0+HS_SLICE-1:
// attn_dkv_rows's function and bits on those columns. dk and dv point at
// this (sample, head)'s row 0, column 0.
template <bool BF, bool DROP, typename TIn>
__device__ void attn_dkv_rows_hs(const TIn* __restrict__ q, const TIn* __restrict__ k,
                                 const TIn* __restrict__ v, long row_stride,
                                 const TIn* __restrict__ d_o, long do_stride,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 int T, int length, int k0, int c0, int hd, float scale2,
                                 float scale, Drop dr, float* smem, float* __restrict__ dk,
                                 float* __restrict__ dv, long out_stride) {
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  float* Kc = smem;
  float* Vc = Kc + ROWS * CP;
  float* Qc = Vc + ROWS * CP;
  float* Oc = Qc + KEYS * CP;
  float* Ds = Oc + KEYS * CP;
  float* Pd = Ds + ROWS * PP;
  float* Ls = Pd + ROWS * PP;
  float* Dl = Ls + KEYS;
  float* Qs = Dl + KEYS;
  float* Os = Qs + KEYS * SP;
  const int nkeys = min(ROWS, T - k0), ncols = min(HS_SLICE, hd - c0);
  if (k0 >= length) {  // also every block of a sample with length 0
    for (int idx = tid; idx < nkeys * ncols; idx += NT) {
      const int rr = idx / ncols;
      const long g = (long)(k0 + rr) * out_stride + c0 + (idx - rr * ncols);
      dk[g] = 0.f;
      dv[g] = 0.f;
    }
    return;
  }
  const bool key_ok = k0 + r < length;
  float acc_k[MAXC], acc_v[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += KEYS) {
    const int nq = min(KEYS, T - t0);
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += HS_CHUNK) {
      const int dc = min(HS_CHUNK, hd - d0);
      __syncthreads();
      load_block<ROWS, false>(Kc, CP, k, row_stride, k0, length, d0, dc, dc);
      load_block<ROWS, false>(Vc, CP, v, row_stride, k0, length, d0, dc, dc);
      load_block<KEYS, false>(Qc, CP, q, row_stride, t0, T, d0, dc, dc);
      load_block<KEYS, BF>(Oc, CP, d_o, do_stride, t0, T, d0, dc, dc);
      if (d0 == 0) {
        for (int qq = tid; qq < KEYS; qq += NT) {
          Ls[qq] = qq < nq ? lse[t0 + qq] : 0.f;
          Dl[qq] = qq < nq ? delta[t0 + qq] : 0.f;
        }
      }
      __syncthreads();
      const float* kr = Kc + r * CP;
      const float* vr = Vc + r * CP;
      for (int c = 0; c < dc; ++c) {
        const float kv = kr[c], vv = vr[c];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = fmaf(kv, Qc[(j + TPR * i) * CP + c], s[i]);
          dp[i] = fmaf(vv, Oc[(j + TPR * i) * CP + c], dp[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qq = j + TPR * i;
      const float p = (key_ok && qq < nq) ? exp2f(s[i] * scale2 - Ls[qq]) : 0.f;
      float dpv = dp[i], pd = p;
      if constexpr (DROP) {
        const bool keep = keep_bit(dr, (uint32_t)(t0 + qq), (uint32_t)(k0 + r));
        dpv = keep ? dpv * dr.inv : 0.f;
        pd = keep ? p * dr.inv : 0.f;
      }
      Ds[r * PP + qq] = opnd<BF>(p * (dpv - Dl[qq]));
      Pd[r * PP + qq] = opnd<BF>(pd);
    }
    load_block<KEYS, false>(Qs, SP, q, row_stride, t0, T, c0, ncols, HS_SLICE);
    load_block<KEYS, BF>(Os, SP, d_o, do_stride, t0, T, c0, ncols, HS_SLICE);
    __syncthreads();
    const float* dsr = Ds + r * PP;
    const float* pdr = Pd + r * PP;
    for (int qq = 0; qq < nq; ++qq) {
      const float dsv = dsr[qq], pdv = pdr[qq];
      const float* qrow = Qs + qq * SP;
      const float* orow = Os + qq * SP;
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = j + TPR * i;
        if (c < ncols) {
          acc_k[i] = fmaf(dsv, qrow[c], acc_k[i]);
          acc_v[i] = fmaf(pdv, orow[c], acc_v[i]);
        }
      }
    }
  }
  if (r < nkeys) {
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = j + TPR * i;
      if (c < ncols) {
        const long g = (long)(k0 + r) * out_stride + c0 + c;
        dk[g] = acc_k[i] * scale;
        dv[g] = acc_v[i];
      }
    }
  }
}

}  // namespace hs
}  // namespace rd
