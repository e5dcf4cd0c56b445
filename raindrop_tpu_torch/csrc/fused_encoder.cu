// Post-LN transformer encoder layer forward: the Hopper counterpart of
// raindrop_tpu/ops/fused_encoder.py:_fwd_kernel (:131).
//
//   attn = MHA(x)                          (packed heads, base-2 softmax)
//   x1   = LN1(x + attn Wo^T + bo)
//   out  = LN2(x1 + W2 relu(W1 x1 + b1) + b2)
//
// x [B, T, d] f32, torch-layout weights (in_proj_w [3d, d], out_proj
// [d, d], lin1 [ffn, d], lin2 [d, ffn]) f32, lengths [B] int32 ->
// out, attn [B, T, d] f32, lse [B, nhead, T] f32 (base 2).
//
// What bounds it: at PAM (T=600, d=84, ffn=136) a sample needs about
// 182 MFLOP against 3 * T * d * 4 bytes of x, out and attn, about
// 300 FLOP/byte: at the bf16 ridge, so on tensor cores the operations
// and the bytes weigh about equally; at PAM's sensor-wise width (d=340,
// ffn=136, hd=170) about 1.5 GFLOP a sample, past the ridge. The first
// kernels ran every product in scalar f32 FMA, so the FMA and load issue
// rates bound them (at d=340, 35.9 ms against 2.3 for
// nn.TransformerEncoderLayer).
//
// Design: the TPU kernel keeps a whole sample (x, q, k, v, the [T, T]
// scores and every weight) in one core's VMEM; at PAM that is over
// 400 KB, past an SM's 227 KB. So the layer takes three launches:
//   A  qkv = x W_in^T + b_in for row tiles of [B*T, d] -> [B*T, 3d] in
//      device memory (the backward's first launch too);
//   B  one CTA per (block of query rows, head, sample) streams that
//      sample's K/V with an online softmax and writes attn and lse, which
//      the backward reads anyway;
//   C  one CTA per (64 rows, sample) runs the out-projection, residual,
//      LN1, FFN with relu, residual and LN2 on its own rows, which are
//      row-local. x1 and the FFN hidden stay in shared memory.
// The attention and the row-local tail once shared one CTA; at PAM's
// sensor-wise width the two together need 322,560 bytes of shared memory,
// and apart the attention gets a CTA per head. Weights are read from L2 by
// every CTA. No atomics, no score in device memory. With bf16 operands
// every product operand is rounded to bf16 (q, k, v after their bias, as
// the TPU kernel casts them), accumulation stays f32.
//
// Two routes, by the wrapper's launch plan (fused_plan.cuh), which the
// entry point checks:
// - tensor cores (bf16, the model's default): a small kernel packs the four
//   weights into bf16 panels, A and C run every product on wgmma
//   (rows_tc.cuh; one warpgroup a 64-row tile, 64 output columns at a
//   time), qkv is stored in bf16 (each value is already rounded to it, so
//   nothing is lost and the round trip halves: 77.4 MB to 38.7 at PAM),
//   and B runs attend_rows_tc (attention_tc.cuh, in the fused unit
//   fused_encoder_attn_tc.cu, one warpgroup a CTA) up to a padded head dim
//   of 144 and attend_rows_tc_wide (attention_tc_wide.cuh, in
//   fused_encoder_attn_wide.cu, two warpgroups each owning half of the
//   output's columns over 32-row streamed tiles) past it, to hd 192
//   (PAM-sw's 170 pads to 176);
// - scalar (f32, and bf16 on request): A in 32-row blocks, B attend_rows in
//   the geometry of the head dim, C row_gemm, every product scalar FMA.
//   The f32 route keeps these kernels bit for bit;
// - stream (every width the two above do not take: P12's sensor-wise d 720,
//   any head past 368; rows_stream.cuh says why and how): C becomes its
//   products and row kernels, each a launch over rows in device memory,
//   A a product of the same kernel (tensor cores in bf16, scalar in f32),
//   B the attention of the plan (in bf16 on the tensor cores to hd 368,
//   past it attend_rows_hs, in fused_encoder_attn_hds.cu).
//
// Dropout (training) is a template flag; with rate 0 the kernels carry no
// mask code. The attention probabilities are keyed (seed, b * nhead + h),
// the three site masks (seed, b) with the row term site * t8 + row, t8 = T
// padded to 8 (the reference's padded row count), sites 101 (attention
// out), 102 (FFN hidden, after relu) and 103 (FFN out).
#include "fused_plan.cuh"
#include "rows_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rd::fused::Plan;

template <int MAXD, typename G, bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
attn_rows_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
                 float* __restrict__ attn, float* __restrict__ lse, int T, int d,
                 int nhead, float scale2, int seed, rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * G::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hd = d / nhead;
  const int length = min(max(lengths[b], 0), T);
  const float* qh = qkv + (long)b * T * 3 * d + h * hd;
  dr.base = rd::drop_base(seed, dr.bh(b, h));
  rd::attend_rows<MAXD, BF, DROP, float, G>(
      qh, qh + d, qh + 2 * d, 3 * d, T, length, q0, hd, scale2, smem,
      attn + ((long)b * T + q0) * d + h * hd, d, lse + ((long)b * nhead + h) * T, dr);
}

template <bool BF, bool DROP>
__global__ void __launch_bounds__(rd::NT)
layer_tail_kernel(const float* __restrict__ x, const float* __restrict__ attn,
                  const float* __restrict__ wo, const float* __restrict__ bo,
                  const float* __restrict__ g1, const float* __restrict__ be1,
                  const float* __restrict__ w1, const float* __restrict__ bf1,
                  const float* __restrict__ w2, const float* __restrict__ bf2,
                  const float* __restrict__ g2, const float* __restrict__ be2,
                  float* __restrict__ out, int T, int d, int ffn, int seed,
                  rd::Drop dr) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * rd::BQ, b = blockIdx.y;
  const int nrows = min(rd::BQ, T - q0);
  const int DP = d + 1, FP = ffn + 1;
  float* As = smem;             // attention rows, later x1 + FFN
  float* Xs = As + rd::BQ * DP; // x + attention projection, then x1
  float* U = Xs + rd::BQ * DP;  // the FFN hidden
  const long row0 = (long)b * T + q0;
  for (int idx = threadIdx.x; idx < rd::BQ * d; idx += rd::NT) {
    const int r = idx / d, c = idx - r * d;
    As[r * DP + c] = r < nrows ? attn[(row0 + r) * d + c] : 0.f;
  }
  dr.base = rd::drop_base(seed, dr.row(b));
  const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
  __syncthreads();
  rd::row_gemm<BF, false, DROP>(As, DP, d, wo, bo, d, Xs, DP, x + row0 * d, d,
                                nrows, dr, 101u * t8 + q0);
  __syncthreads();
  rd::layer_norm_rows(Xs, DP, d, g1, be1, nrows, Xs, DP);
  __syncthreads();
  rd::row_gemm<BF, true, DROP>(Xs, DP, d, w1, bf1, ffn, U, FP, nullptr, 0, nrows,
                               dr, 102u * t8 + q0);
  __syncthreads();
  rd::row_gemm<BF, false, DROP>(U, FP, ffn, w2, bf2, d, As, DP, Xs, DP, nrows,
                                dr, 103u * t8 + q0);
  __syncthreads();
  rd::layer_norm_rows(As, DP, d, g2, be2, nrows, out + row0 * d, d);
}

// LayerNorm of rows r < nrows of the f32 [64, d] buffer X in place (one
// warp a row, eight warps), the arithmetic of rd::layer_norm_rows; with a
// tile, each result is also rounded into it (the next product's operand).
__device__ void ln_rows_tc(float* X, int d, const float* __restrict__ gamma,
                           const float* __restrict__ beta, int nrows, uint8_t* tile,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += rd::rows::NTH / 32) {
    float* h = X + r * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += h[c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / d;
    float vs = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = h[c] - mu;
      vs += t * t;
    }
    for (int o = 16; o > 0; o >>= 1) vs += __shfl_xor_sync(0xffffffffu, vs, o);
    const float rstd = rsqrtf(vs / d + 1e-5f);
    for (int c = lane; c < d; c += 32) {
      const float y = (h[c] - mu) * rstd * gamma[c] + beta[c];
      if (out != nullptr) {
        out[(long)r * d + c] = y;
      } else {
        h[c] = y;
        rd::rows::put(tile, r, c, y);
      }
    }
  }
}

// Launch C on the tensor cores: two warpgroups per (64 rows, sample). x + the
// attention projection (later x1, then x1 + the FFN) stays in f32 in
// shared memory; attn, x1 and the FFN hidden enter the products as bf16
// tiles; wo, w1, w2 are the packed weights.
template <bool DROP>
__global__ void __launch_bounds__(rd::rows::NTH)
layer_tail_tc(const float* __restrict__ x, const float* __restrict__ attn,
              const bf16* __restrict__ wo, const float* __restrict__ bo,
              const float* __restrict__ g1, const float* __restrict__ be1,
              const bf16* __restrict__ w1, const float* __restrict__ bf1,
              const bf16* __restrict__ w2, const float* __restrict__ bf2,
              const float* __restrict__ g2, const float* __restrict__ be2,
              float* __restrict__ out, int T, int d, int ffn, int seed, rd::Drop dr) {
  using namespace rd::rows;
  extern __shared__ __align__(128) uint8_t smem_rows[];
  const int q0 = blockIdx.x * R, b = blockIdx.y;
  const int nrows = min(R, T - q0);
  const int KPd = pad64(d), KPf = pad64(ffn);
  float* X = reinterpret_cast<float*>(smem_rows);  // [64, d]
  uint8_t* At = smem_rows + f32_rows_bytes(d);     // attn, then x1
  uint8_t* Ft = At + tile_bytes(d);                // the FFN hidden
  uint8_t* ring = Ft + tile_bytes(ffn);
  const long row0 = (long)b * T + q0;
  dr.base = rd::drop_base(seed, dr.row(b));
  const uint32_t t8 = (uint32_t)((T + 7) / 8 * 8);
  const uint32_t r101 = 101u * t8 + q0, r102 = 102u * t8 + q0, r103 = 103u * t8 + q0;
  // the value after its bias (and relu), dropped by the site's keep bit
  auto drop = [&](uint32_t row_base, int r, int n, float y) -> float {
    if constexpr (DROP) {
      return rd::keep_bit(dr, row_base + (uint32_t)r, (uint32_t)n) ? y * dr.inv : 0.f;
    } else {
      return y;
    }
  };
  zero_smem(Ft, tile_bytes(ffn));
  stage_rows(At, attn + row0 * d, d, nrows, d, KPd);
  const float* xr = x + row0 * d;
  rows_tc(At, KPd, wo, d, nrows, ring, [&](int r, int n, float acc) {
    X[r * d + n] = xr[(long)r * d + n] + drop(r101, r, n, acc + bo[n]);
  });
  ln_rows_tc(X, d, g1, be1, nrows, At, nullptr);  // x1, in X and (bf16) At
  __syncthreads();
  rows_tc(At, KPd, w1, ffn, nrows, ring, [&](int r, int n, float acc) {
    put(Ft, r, n, drop(r102, r, n, fmaxf(acc + bf1[n], 0.f)));
  });
  rows_tc(Ft, KPf, w2, d, nrows, ring, [&](int r, int n, float acc) {
    X[r * d + n] += drop(r103, r, n, acc + bf2[n]);
  });
  ln_rows_tc(X, d, g2, be2, nrows, nullptr, out + row0 * d);
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > rd::MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Launch B on the scalar kernels in the geometry of the head dim (up to hd
// 368), on f32 qkv.
template <bool BF, bool DROP>
int attn_scalar(const float* qkv, const int* lengths, float* attn, float* lse, int bytes,
                int B, int T, int d, int nhead, float scale2, int seed, rd::Drop dr,
                cudaStream_t stream) {
  RD_DISPATCH_GEOM(d / nhead, {
    auto kb = attn_rows_kernel<MAXD, G, BF, DROP>;
    cudaError_t err = allow_smem(kb, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 blocks((T + G::ROWS - 1) / G::ROWS, nhead, B);
    kb<<<blocks, rd::NT, bytes, stream>>>(qkv, lengths, attn, lse, T, d, nhead, scale2, seed,
                                          dr);
    return (int)cudaGetLastError();
  });
}

template <bool BF, bool DROP>
int launch(const float* x, const float* w_in, const float* b_in,
           const float* wo, const float* bo, const float* g1, const float* be1,
           const float* w1, const float* bf1, const float* w2, const float* bf2,
           const float* g2, const float* be2, const int* lengths, float* qkv,
           float* out, float* attn, float* lse, int B, int T, int d, int ffn,
           int nhead, float scale2, int seed, rd::Drop dr, const Plan& p,
           cudaStream_t stream) {
  const long M = (long)B * T;
  const int bytes_a = p.l[rd::fused::QKV].smem, bytes_b = p.l[rd::fused::ATTN_FWD].smem,
            bytes_c = p.l[rd::fused::TAIL].smem;
  auto ka = rd::qkv_rows_kernel<BF>;
  auto kc = layer_tail_kernel<BF, DROP>;
  cudaError_t err = allow_smem(ka, bytes_a);
  if (err == cudaSuccess) err = allow_smem(kc, bytes_c);
  if (err != cudaSuccess) return (int)err;
  ka<<<(unsigned)((M + rd::BR - 1) / rd::BR), rd::NT, bytes_a, stream>>>(
      x, w_in, b_in, qkv, M, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int e = attn_scalar<BF, DROP>(qkv, lengths, attn, lse, bytes_b, B, T, d, nhead,
                                      scale2, seed, dr, stream);
  if (e != 0) return e;
  dim3 rows((T + rd::BQ - 1) / rd::BQ, B);
  kc<<<rows, rd::NT, bytes_c, stream>>>(x, attn, wo, bo, g1, be1, w1, bf1, w2, bf2, g2,
                                        be2, out, T, d, ffn, seed, dr);
  return (int)cudaGetLastError();
}

#define RD_TRY(expr)                             \
  do {                                           \
    cudaError_t rd_e_ = (expr);                  \
    if (rd_e_ != cudaSuccess) return (int)rd_e_; \
  } while (0)

// The tensor-core route: pack the four weights, then A, B, C.
template <bool DROP>
int launch_tc(const float* const* w, const float* b_in, const float* bo, const float* g1,
              const float* be1, const float* bf1, const float* bf2, const float* g2,
              const float* be2, const float* x, const int* lengths, bf16* qkv, float* out,
              float* attn, float* lse, bf16* wpack, int B, int T, int d, int ffn, int nhead,
              float scale2, int seed, double rate, rd::Origin org, const Plan& p,
              cudaStream_t stream) {
  using namespace rd::fused;
  const rd::Drop dr = rd::make_drop(rate, org);
  const Packed pk = packed_layout(d, ffn);
  RD_TRY(pack_weights(pack_jobs(pk, w, P_W2T), wpack, stream));
  const long M = (long)B * T;
  const Launch& la = p.l[QKV];
  RD_TRY(allow_smem(qkv_rows_tc_kernel, la.smem));
  qkv_rows_tc_kernel<<<(unsigned)((M + la.rows - 1) / la.rows), la.threads, la.smem,
                       stream>>>(x, wpack + pk.off[P_IN], b_in, qkv, M, d);
  RD_TRY(cudaGetLastError());
  const Launch& lb = p.l[ATTN_FWD];
  const int err = (lb.route == 1 ? launch_attn_fwd_tc : launch_attn_fwd_wide)(
      qkv, lengths, attn, lse, lb, B, T, d, nhead, scale2, seed, rate, org, stream);
  if (err != 0) return err;
  const Launch& lc = p.l[TAIL];
  auto kc = layer_tail_tc<DROP>;
  RD_TRY(allow_smem(kc, lc.smem));
  kc<<<dim3((T + lc.rows - 1) / lc.rows, B), lc.threads, lc.smem, stream>>>(
      x, attn, wpack + pk.off[P_WO], bo, g1, be1, wpack + pk.off[P_W1], bf1,
      wpack + pk.off[P_W2], bf2, g2, be2, out, T, d, ffn, seed, dr);
  return (int)cudaGetLastError();
}

// The "stream" route: the four weights packed (bf16: the products on the
// tensor cores; f32 reads them as given), then A, B and C's products and
// row kernels. rows: x1 [M, d], then the FFN hidden [M, ffn]; out holds
// the out-projection and the FFN's output before LN1 and LN2 read them.
template <bool DROP>
int launch_stream(const float* const* w, const float* b_in, const float* bo,
                  const float* g1, const float* be1, const float* bf1, const float* bf2,
                  const float* g2, const float* be2, const float* x, const int* lengths,
                  void* qkv, float* out, float* attn, float* lse, bf16* wpack, float* rows,
                  int B, int T, int d, int ffn, int nhead, float scale2, int bf, int seed,
                  double rate, rd::Origin org, const Plan& p, cudaStream_t stream) {
  using namespace rd::fused;
  const rd::Drop dr = rd::make_drop(rate, org);
  const Packed pk = packed_layout(d, ffn);
  if (bf) RD_TRY(pack_weights(pack_jobs(pk, w, P_W2T), wpack, stream));
  const long M = (long)B * T;
  auto prod = [&](const float* A, int K, int slot, int N, const float* bias, void* o,
                  int out_bf16, int round) {
    return stream_product(A, M, K, bf ? wpack + pk.off[slot] : nullptr, w[slot], 0, N, bias,
                          nullptr, o, out_bf16, round, stream);
  };
  const Launch& lb = p.l[ATTN_FWD];
  const bool attn_tc = lb.route == R_TC || lb.route == R_TC_WIDE || lb.route == R_TC_CLUSTER;
  float* x1 = rows;
  float* f = rows + M * d;
  const dim3 row_grid = stream_row_grid(M);
  RD_TRY(prod(x, d, P_IN, 3 * d, b_in, qkv, attn_tc, bf && !attn_tc));
  int err;
  if (lb.route == R_TC) {
    err = launch_attn_fwd_tc(qkv, lengths, attn, lse, lb, B, T, d, nhead, scale2, seed, rate,
                             org, stream);
  } else if (lb.route == R_TC_WIDE) {
    err = launch_attn_fwd_wide(qkv, lengths, attn, lse, lb, B, T, d, nhead, scale2, seed,
                               rate, org, stream);
  } else if (lb.route == R_TC_CLUSTER) {
    err = launch_attn_fwd_tcc(qkv, lengths, attn, lse, lb, B, T, d, nhead, scale2, seed, rate,
                              org, stream);
  } else if (lb.route == R_HD_STREAM) {
    err = launch_attn_fwd_hds(qkv, lengths, attn, lse, lb, B, T, d, nhead, scale2, bf, seed,
                              rate, org, stream);
  } else {
    err = (bf ? attn_scalar<true, DROP> : attn_scalar<false, DROP>)(
        (const float*)qkv, lengths, attn, lse, lb.smem, B, T, d, nhead, scale2, seed, dr,
        stream);
  }
  if (err != 0) return err;
  RD_TRY(prod(attn, d, P_WO, d, bo, out, 0, 0));
  stream_ln_rows<DROP><<<row_grid, rd::NT, 0, stream>>>(x, out, 101u, g1, be1, x1, nullptr,
                                                        nullptr, M, T, d, seed, dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(x1, d, P_W1, ffn, bf1, f, 0, 0));
  stream_relu<DROP><<<stream_elem_grid(M * ffn), rd::NT, 0, stream>>>(f, nullptr, M * ffn,
                                                                     ffn, T, seed, dr);
  RD_TRY(cudaGetLastError());
  RD_TRY(prod(f, ffn, P_W2, d, bf2, out, 0, 0));
  stream_ln_rows<DROP><<<row_grid, rd::NT, 0, stream>>>(x1, out, 103u, g2, be2, out, nullptr,
                                                        nullptr, M, T, d, seed, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of route tc (1), scalar (0) or stream (4) at one width, as the
// entry points check it: PLAN_INTS ints into out (rd::fused::Plan); W is
// the tensor-core attention's copy width. cudaErrorInvalidValue (out all
// zeros) where the route does not take the width.
extern "C" int rd_fused_plan(int d, int ffn, int nhead, int bf16, int route, int W, int* out) {
  Plan p;
  if (rd::fused::expected_plan(d, ffn, nhead, bf16, route, W, &p)) {
    std::memcpy(out, &p, sizeof(Plan));
    return 0;
  }
  std::memset(out, 0, sizeof(Plan));
  return (int)cudaErrorInvalidValue;
}

// qkv: [B, T, 3d] scratch, bf16 where the attention runs on the tensor
// cores, f32 otherwise; wpack: the packed weights (tensor cores;
// rd::fused::packed_layout's first four); rows: the "stream" route's x1
// and FFN hidden, B T (d + ffn) floats; plan: the wrapper's PLAN_INTS ints.
extern "C" int rd_fused_layer_fwd(
    const void* x, const void* w_in, const void* b_in, const void* wo,
    const void* bo, const void* g1, const void* be1, const void* w1,
    const void* bf1, const void* w2, const void* bf2, const void* g2,
    const void* be2, const void* lengths, void* qkv, void* out, void* attn,
    void* lse, void* wpack, void* rows, int B, int T, int d, int ffn, int nhead, float scale2,
    int bf16, int seed, double rate, int b0, int h0, int heads, const int* plan,
    void* stream) {
  const rd::Origin org{b0, h0, heads};
  if (B <= 0 || B > 65535 || T <= 0 || nhead <= 0 || nhead > 65535 ||
      d % nhead != 0 || ffn <= 0 || !(rate >= 0.0 && rate < 1.0) ||
      rd::bad_origin(org, B, nhead))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!rd::fused::check_plan(plan, d, ffn, nhead, bf16, {qkv}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.l[rd::fused::QKV].route == rd::fused::R_STREAM) {
    if (rows == nullptr || (bf16 && wpack == nullptr)) return (int)cudaErrorInvalidValue;
    const float* w[4] = {(const float*)w_in, (const float*)wo, (const float*)w1,
                         (const float*)w2};
#define RD_STREAM_ARGS                                                          \
  w, (const float*)b_in, (const float*)bo, (const float*)g1, (const float*)be1, \
      (const float*)bf1, (const float*)bf2, (const float*)g2, (const float*)be2, \
      (const float*)x, (const int*)lengths, qkv, (float*)out, (float*)attn,     \
      (float*)lse, (__nv_bfloat16*)wpack, (float*)rows, B, T, d, ffn, nhead,    \
      scale2, bf16, seed, rate, org, p, s
    return rate > 0.0 ? launch_stream<true>(RD_STREAM_ARGS)
                      : launch_stream<false>(RD_STREAM_ARGS);
#undef RD_STREAM_ARGS
  }
  if (p.l[rd::fused::QKV].route == 1) {
    const float* w[4] = {(const float*)w_in, (const float*)wo, (const float*)w1,
                         (const float*)w2};
#define RD_TC_ARGS                                                              \
  w, (const float*)b_in, (const float*)bo, (const float*)g1, (const float*)be1, \
      (const float*)bf1, (const float*)bf2, (const float*)g2, (const float*)be2, \
      (const float*)x, (const int*)lengths, (__nv_bfloat16*)qkv, (float*)out,     \
      (float*)attn, (float*)lse, (__nv_bfloat16*)wpack, B, T, d, ffn, nhead,    \
      scale2, seed, rate, org, p, s
    return rate > 0.0 ? launch_tc<true>(RD_TC_ARGS) : launch_tc<false>(RD_TC_ARGS);
#undef RD_TC_ARGS
  }
  const rd::Drop dr = rd::make_drop(rate, org);
#define RD_ARGS                                                            \
  (const float*)x, (const float*)w_in, (const float*)b_in,                 \
      (const float*)wo, (const float*)bo, (const float*)g1,                \
      (const float*)be1, (const float*)w1, (const float*)bf1,              \
      (const float*)w2, (const float*)bf2, (const float*)g2,               \
      (const float*)be2, (const int*)lengths, (float*)qkv, (float*)out,    \
      (float*)attn, (float*)lse, B, T, d, ffn, nhead, scale2, seed, dr, p, s
  if (rate > 0.0) return bf16 ? launch<true, true>(RD_ARGS) : launch<false, true>(RD_ARGS);
  return bf16 ? launch<true, false>(RD_ARGS) : launch<false, false>(RD_ARGS);
#undef RD_ARGS
}
