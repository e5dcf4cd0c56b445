// Device code of the attention backward, shared by the packed-heads
// backward and the fused layer's backward: dq for one block of query
// rows, dk and dv for one block of key rows, of one (sample, head); the
// block and tile sizes are the geometry G of attention.cuh.
//
// dk and dv sum over query rows while dq sums over keys. Doing all three
// in one CTA per query block would need float atomics on dk and dv, whose
// order changes from run to run. So there are two passes, each with a
// fixed summation order: one streams key tiles for dq, the other streams
// query tiles for dk and dv. Both recompute p = exp2(s * scale2 - lse)
// from the saved base-2 lse and regenerate the dropout mask from the
// counter hash. Scalar f32 FMA out of shared memory, as the forward.
//
// Rounding follows the TPU kernel: operands q, k, v, do in the operand
// type; ds = p * (dp - delta) and the dropped p rounded to it (BF) before
// their products; f32 accumulation; dq, dk times 1/sqrt(hd).
#pragma once

#include "attention.cuh"

namespace rd {

// Shared floats of attn_dq_rows / attn_dkv_rows for head dim hd.
template <typename G = Narrow>
inline int attn_dq_smem_floats(int hd) {
  return 2 * (G::ROWS + G::KEYS) * (hd + 1) + G::ROWS * (G::KEYS + 1);
}
template <typename G = Narrow>
inline int attn_dkv_smem_floats(int hd) {
  return 2 * (G::ROWS + G::KEYS) * (hd + 1) + 2 * G::ROWS * (G::KEYS + 1) + 2 * G::KEYS;
}

// Load rows row0 .. row0+N-1 of a [*, hd] head view into dst (stride hd+1);
// rows at or past `limit` become zero. ROUND rounds to bf16 (for an f32
// buffer that holds an operand not yet rounded).
template <int N, bool ROUND, typename TIn>
__device__ __forceinline__ void load_rows(float* dst, const TIn* __restrict__ src,
                                          long stride, int row0, int limit, int hd) {
  const int HP = hd + 1;
  for (int idx = threadIdx.x; idx < N * hd; idx += NT) {
    const int rr = idx / hd, c = idx - rr * hd;
    const float x = row0 + rr < limit ? to_f(src[(long)(row0 + rr) * stride + c]) : 0.f;
    dst[rr * HP + c] = opnd<ROUND>(x);
  }
}

// dq of query rows q0 .. q0+G::ROWS-1 of one (sample, head).
//   q, k, v: element (t, c) at [t * row_stride + c];  d_o at [t * do_stride + c]
//   lse, delta: [T] of this (sample, head)
//   dq: row t at [t * dq_stride + c]  (rows q0 .. are written, all c < hd)
// Thread (r = tid/TPR, j = tid%TPR) owns query row r, the keys j, j+TPR,
// ... of each tile and the output columns j, j+TPR, ... .
template <int MAXD, bool BF, bool DROP, typename TIn, typename G = Narrow>
__device__ void attn_dq_rows(const TIn* __restrict__ q, const TIn* __restrict__ k,
                             const TIn* __restrict__ v, long row_stride,
                             const TIn* __restrict__ d_o, long do_stride,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, int T, int length,
                             int q0, int hd, float scale2, float scale, Drop dr,
                             float* smem, float* __restrict__ dq, long dq_stride) {
  constexpr int RQ = G::ROWS, KT = G::KEYS, TPR = G::TPR, NS = KT / TPR;
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  const int HP = hd + 1, PP = KT + 1;
  float* Qs = smem;
  float* Os = Qs + RQ * HP;
  float* Ks = Os + RQ * HP;
  float* Vs = Ks + KT * HP;
  float* Ds = Vs + KT * HP;
  const int nrows = min(RQ, T - q0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * hd; idx += NT) {
      const int rr = idx / hd;
      dq[(long)(q0 + rr) * dq_stride + (idx - rr * hd)] = 0.f;
    }
    return;
  }
  load_rows<RQ, false>(Qs, q, row_stride, q0, T, hd);
  load_rows<RQ, BF>(Os, d_o, do_stride, q0, T, hd);
  const bool rok = r < nrows;
  const float lse_r = rok ? lse[q0 + r] : 0.f;
  const float delta_r = rok ? delta[q0 + r] : 0.f;
  float acc[MAXD];
#pragma unroll
  for (int i = 0; i < MAXD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < length; k0 += KT) {
    const int nk = min(KT, length - k0);
    __syncthreads();  // previous tile consumed
    load_rows<KT, false>(Ks, k, row_stride, k0, length, hd);
    load_rows<KT, false>(Vs, v, row_stride, k0, length, hd);
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    const float* qr = Qs + r * HP;
    const float* orow = Os + r * HP;
    for (int c = 0; c < hd; ++c) {
      const float qv = qr[c], ov = orow[c];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = fmaf(qv, Ks[(j + TPR * i) * HP + c], s[i]);
        dp[i] = fmaf(ov, Vs[(j + TPR * i) * HP + c], dp[i]);
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
    __syncwarp();  // row r's ds come from the TPR lanes of its group
    const float* dr_ = Ds + r * PP;
    for (int kk = 0; kk < nk; ++kk) {
      const float dsv = dr_[kk];
      const float* kr = Ks + kk * HP;
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        const int c = j + TPR * i;
        if (c < hd) acc[i] = fmaf(dsv, kr[c], acc[i]);
      }
    }
  }
  if (rok) {
#pragma unroll
    for (int i = 0; i < MAXD; ++i) {
      const int c = j + TPR * i;
      if (c < hd) dq[(long)(q0 + r) * dq_stride + c] = acc[i] * scale;
    }
  }
}

// dk and dv of key rows k0 .. k0+G::ROWS-1 of one (sample, head). Query
// rows past the sample's length are real rows (they attend to the live
// keys) and contribute; keys at or past the length get zeros. Thread
// (r, j) owns key row r, the queries j, j+TPR, ... of each tile and the
// output columns j, j+TPR, ... of both dk and dv.
template <int MAXD, bool BF, bool DROP, typename TIn, typename G = Narrow>
__device__ void attn_dkv_rows(const TIn* __restrict__ q, const TIn* __restrict__ k,
                              const TIn* __restrict__ v, long row_stride,
                              const TIn* __restrict__ d_o, long do_stride,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, int T, int length,
                              int k0, int hd, float scale2, float scale, Drop dr,
                              float* smem, float* __restrict__ dk,
                              float* __restrict__ dv, long out_stride) {
  constexpr int RK = G::ROWS, QT = G::KEYS, TPR = G::TPR, NS = QT / TPR;
  const int tid = threadIdx.x, r = tid / TPR, j = tid % TPR;
  const int HP = hd + 1, PP = QT + 1;
  float* Ks = smem;
  float* Vs = Ks + RK * HP;
  float* Qs = Vs + RK * HP;
  float* Os = Qs + QT * HP;
  float* Ds = Os + QT * HP;
  float* Pd = Ds + RK * PP;
  float* Ls = Pd + RK * PP;
  float* Dl = Ls + QT;
  const int nkeys = min(RK, T - k0);
  if (k0 >= length) {  // also every block of a sample with length 0
    for (int idx = tid; idx < nkeys * hd; idx += NT) {
      const int rr = idx / hd;
      const long g = (long)(k0 + rr) * out_stride + (idx - rr * hd);
      dk[g] = 0.f;
      dv[g] = 0.f;
    }
    return;
  }
  load_rows<RK, false>(Ks, k, row_stride, k0, length, hd);
  load_rows<RK, false>(Vs, v, row_stride, k0, length, hd);
  const bool key_ok = k0 + r < length;
  float acc_k[MAXD], acc_v[MAXD];
#pragma unroll
  for (int i = 0; i < MAXD; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += QT) {
    const int nq = min(QT, T - t0);
    __syncthreads();  // previous tile consumed (and the own rows loaded)
    load_rows<QT, false>(Qs, q, row_stride, t0, T, hd);
    load_rows<QT, BF>(Os, d_o, do_stride, t0, T, hd);
    for (int qq = tid; qq < QT; qq += NT) {
      Ls[qq] = qq < nq ? lse[t0 + qq] : 0.f;
      Dl[qq] = qq < nq ? delta[t0 + qq] : 0.f;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    const float* kr = Ks + r * HP;
    const float* vr = Vs + r * HP;
    for (int c = 0; c < hd; ++c) {
      const float kv = kr[c], vv = vr[c];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = fmaf(kv, Qs[(j + TPR * i) * HP + c], s[i]);
        dp[i] = fmaf(vv, Os[(j + TPR * i) * HP + c], dp[i]);
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
    __syncwarp();  // key row r's values come from the TPR lanes of its group
    const float* dsr = Ds + r * PP;
    const float* pdr = Pd + r * PP;
    for (int qq = 0; qq < nq; ++qq) {
      const float dsv = dsr[qq], pdv = pdr[qq];
      const float* qrow = Qs + qq * HP;
      const float* orow = Os + qq * HP;
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        const int c = j + TPR * i;
        if (c < hd) {
          acc_k[i] = fmaf(dsv, qrow[c], acc_k[i]);
          acc_v[i] = fmaf(pdv, orow[c], acc_v[i]);
        }
      }
    }
  }
  if (r < nkeys) {
#pragma unroll
    for (int i = 0; i < MAXD; ++i) {
      const int c = j + TPR * i;
      if (c < hd) {
        const long g = (long)(k0 + r) * out_stride + c;
        dk[g] = acc_k[i] * scale;
        dv[g] = acc_v[i];
      }
    }
  }
}

}  // namespace rd
