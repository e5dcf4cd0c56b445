// Sparse sensor-graph kernels: the Hopper counterparts of
// raindrop_tpu/ops/sparse_pallas.py:_spmm_kernel (:64) with its backward
// (_spmm_bwd, :110) and :_sddmm_kernel (:195) with its backward (:230).
//
//   spmm_segment_softmax  out[b,n,:] = sum_{e: dst_e = n} w[b,e] * x[b,idx_e,:],
//                         w[b,:] = softmax of gamma[b,:] within each dst segment,
//                         idx = dst (gather_target) or src
//   its backward          dgamma[b,e] = w_e * (s_e - sum_{e' in seg(e)} w_e' s_e'),
//                         s_e = g_out[b,dst_e] . x[b,idx_e] + g_w[b,e];
//                         dx[b,v,:] = sum_{e: idx_e = v} w[b,e] * g_out[b,dst_e,:]
//   sddmm                 alpha[b,e] = scale * q[b,dst_e] . k[b,src_e]
//   its backward          dq[b,n,:] = sum_{e: dst_e = n} scale * dalpha[b,e] * k[b,src_e,:]
//                         dk[b,n,:] = sum_{e: src_e = n} scale * dalpha[b,e] * q[b,dst_e,:]
//
// All f32, x/q/k [B, N, D], gamma/w/alpha [B, E], one topology for the batch.
// The wrapper sorts the edges once per topology into two CSRs (by dst and by
// src: `perm` [E] the edge ids in segment order, `ptr` [N+1]), so every
// reduction by index is a loop over one segment in CSR order: no atomics,
// the same bits on a repeat. Products are f32 FMAs: a gather must be exact
// (the JAX kernels run at Precision.HIGHEST), and at a few FLOP per byte the
// tensor cores would buy nothing.
//
// What bounds them: the bytes. Each [B, N, D] array crosses from device
// memory once (16 MB each at P12, B=128, D=860: 0.0099 ms for the forward at
// 3.35 TB/s). The TPU kernels kept a sample's rows in VMEM and served every
// edge from there through one-hot products on the MXU; the first Hopper
// design (the "csr" route below, one CTA per node) read each gathered row
// once per edge from L2, N times per sample on a complete graph (570 MB of
// L2 reads for 16 MB of data at P12). This design takes the other half of
// the TPU kernel's idea: a sample's gathered rows cross from device memory
// once, into registers or shared memory, and every edge of the sample is
// served from there. A launch plan (make_graph_plan below, twin of
// ops/sparse.py graph_plan; every entry point recomputes it and refuses the
// wrapper's if it differs) picks one of three routes from the shapes:
//
//   "row"   the model's form, gather_target: every edge of node v's segment
//           gathers v's own row, in the forward and in dx. A warp per
//           (sample, node, chunk of 128 or 256 columns) reads the chunk once
//           into registers and runs the segment's weights over it, one FMA
//           an edge in the csr route's CSR order: out, w and dx keep the csr
//           route's bits. dgamma takes the segment's one dot product once,
//           in the csr route's lane order, and sums as that route does: the
//           same bits too. Bound: the bytes (each row read and written once).
//   "tile"  every other gather: the source-gathered forward and its dx,
//           dgamma's dots with the source gathered, sddmm and its dq, dk.
//           A CTA per (column group, part, sample) stages the sample's N
//           rows C columns at a time in shared memory, double-buffered by
//           cp.async (16-byte copies where D % 4 == 0 and the operands are
//           16-byte aligned), so the next chunk's copy overlaps this one's
//           arithmetic. Weighted sums (tile_sum_kernel) also stage their CSR
//           positions as (weight, row offset) pairs, read from CSR-ordered
//           index arrays so no load waits on another, and sum each (node, 4
//           columns) in CSR order: the csr route's bits, the softmax of the
//           forward computed in the same kernel. Edge dot products
//           (tile_dot_kernel) hold the destination row's chunk in registers
//           while a group of 8 lanes walks the segment's sources, each
//           source row slice read once from shared memory without a bank
//           conflict; the column groups' partial sums meet through
//           distributed shared memory in a cluster, in rank order (another
//           order than the csr route's: new bits). Bound: the shared-memory
//           reads, one a multiply-add (0.57 GB at P12 D=860, about 0.019 ms
//           at the H100's 128 bytes a clock an SM), where a sample's rows
//           are reused (P12, PAM); the bytes, streamed as column strips, on
//           sparse graphs (kNN). Node parts (sums) and position parts (dot
//           products) fill the card at B=1.
//   "csr"   the first design, kept for a sample whose rows do not fit a
//           tile at 32 columns (at 6 edges a node, N past 747 for the sums
//           and 398 for the dot products; no preset or driven graph).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int NW = NT / 32;        // warps per CTA
constexpr int CPT = 4;             // columns per thread in the csr route's gather_sum
constexpr int CH = NT;             // edges staged per pass by gather_sum
constexpr float NEG_INF = -1e30f;  // the TPU kernel's floor of a segment's max
constexpr int MAX_SMEM = 232448;   // a block's shared memory on the H100
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_PREFER = MAX_SMEM / 4;  // a tile that lets 4 CTAs share an SM
constexpr int TARGET_CTAS = 264;   // two CTAs on each of the H100's 132 SMs
constexpr int MAX_GROUPS = 8;      // column groups: a portable cluster's CTAs
constexpr int EC = 1024;           // CSR positions tile_sum stages at a time
constexpr int PAD = 4;             // floats between a staged row's chunk and the next row
constexpr int DOT_PART = NT * 8;   // most CSR positions of a dot-product part

enum Route { ROW = 0, TILE = 1, CSR = 2 };
// which reduction a call is: the forward and backward of spmm_segment_softmax
// with the target's or the source's row gathered, sddmm's forward and backward
enum Kind { FWD_TARGET = 0, FWD_SOURCE = 1, BWD_TARGET = 2, BWD_SOURCE = 3, SDDMM_FWD = 4,
            SDDMM_BWD = 5 };

// The launch plan (ops/sparse.py GraphPlan.as_ints): the route; the column
// chunk (a warp's columns on "row", a staged tile's on "tile"); the column
// groups (chunks of a row on "row", CTAs a sample's columns are split over
// on "tile"); the parts a sample's nodes (weighted sums) or CSR positions
// (dot products) are split over; the largest dynamic shared bytes of the
// call's kernels; the copy width in bytes; the main kernel's grid.
struct Plan {
  int route, chunk, groups, parts, smem, copy, grid_x, grid_y;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Shared bytes of tile_sum_kernel: two N x (C + PAD) float buffers, the
// staged CSR positions (min(E, EC) pairs of 8 bytes), ptr and two floats a
// node (the forward's softmax max and sum).
long long sum_smem(int N, int C, int E) {
  return 2LL * N * (C + PAD) * 4 + (long long)std::min(E, EC) * 8 + (N + 1) * 4LL + 8LL * N;
}

// Shared bytes of tile_dot_kernel: two buffers of each operand, and for a
// part's `per` CSR positions their partial sums and row offsets.
long long dot_smem(int N, int C, int per) { return 4LL * N * (C + PAD) * 4 + per * 12LL; }

bool make_graph_plan(int B, int N, int E, int D, int kind, int align, Plan* p) {
  if (kind < FWD_TARGET || kind > SDDMM_BWD) return false;
  const int copy = (D % 4 == 0 && align % 16 == 0) ? 16 : 4;
  if (kind == FWD_TARGET || kind == BWD_TARGET) {
    long long nc = 0, ctas = 0;
    int cpt = 0;
    for (int c : {8, 4}) {
      cpt = c;
      nc = cdiv(D, 32 * c);
      ctas = cdiv((long long)B * N * nc, NW);
      if (ctas >= TARGET_CTAS) break;
    }
    if (ctas > INT_MAX) return false;
    *p = Plan{ROW, 32 * cpt, (int)nc, 1, 0, copy, (int)ctas, 1};
    return true;
  }
  const bool sums = kind != SDDMM_FWD, dots = kind == SDDMM_FWD || kind == BWD_SOURCE;
  // where a staged row serves fewer than 16 edges (a light graph such as a
  // kNN one) the dot products' two large tiles leave room for fewer CTAs an
  // SM, and three quarters of the target keep them in one wave; sddmm's
  // backward launches dq and dk together, so on a denser graph half the
  // target fills the card
  const bool light = E < 16LL * N;
  const long long target = dots && light ? TARGET_CTAS * 3 / 4
                           : kind == SDDMM_BWD && !light ? TARGET_CTAS / 2 : TARGET_CTAS;
  bool found = false;
  for (int C : {128, 64, 32}) {
    const long long G = std::min({cdiv(D, C), cdiv(target, B), (long long)MAX_GROUPS});
    long long P = std::min({cdiv(target, B * G), (long long)N, cdiv(E, NT)});
    if (dots) P = std::max(P, cdiv(E, DOT_PART));
    const long long smem = std::max(sums ? sum_smem(N, C, E) : 0,
                                    dots ? dot_smem(N, C, (int)cdiv(E, P)) : 0);
    if (smem > MAX_SMEM || G * P > INT_MAX) continue;
    *p = Plan{TILE, C, (int)G, (int)P, (int)smem, copy, (int)(G * P), B};
    found = true;
    if (smem <= SMEM_PREFER && B * G * P >= target) break;
  }
  if (!found) *p = Plan{CSR, NT * CPT, (int)cdiv(D, NT * CPT), 1, 0, 4, N, B};
  return true;
}

int align_of(std::initializer_list<const void*> ptrs) {
  int a = 16;
  for (const void* ptr : ptrs) {
    while (a > 1 && (uintptr_t)ptr % a != 0) a /= 2;
  }
  return a;
}

// The plan of this call, as the wrapper must have made it: false unless
// every field of its PLAN_INTS ints is what this file computes.
bool check_plan(const int* ints, int B, int N, int E, int D, int kind,
                std::initializer_list<const void*> operands, Plan* p) {
  if (ints == nullptr || !make_graph_plan(B, N, E, D, kind, align_of(operands), p)) return false;
  return std::memcmp(p, ints, sizeof(Plan)) == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum or max over the CTA, the same order every time; all threads get it.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// A segment's sum over CSR positions j in [s0, s1), p = step(p, j) from
// p = 0, in the order block_reduce<false> takes it from NT threads that each
// stepped j = s0 + tid, s0 + tid + NT, ...: each warp's 32 partials by the
// butterfly, the warps' results added in order. One warp computes it, so a
// warp per segment has the bits of a CTA per segment (gather_sum_kernel,
// spmm_dgamma_kernel). A warp past the segment's end would add +0 to a sum
// that is never -0: skipping it changes nothing.
template <typename F>
__device__ __forceinline__ float block_order_sum(int s0, int s1, int lane, F step) {
  float r = 0.f;
  for (int w = 0; w < NW && s0 + 32 * w < s1; ++w) {
    float p = 0.f;
    for (int j = s0 + 32 * w + lane; j < s1; j += NT) p = step(p, j);
    p = warp_sum(p);
    r = w == 0 ? p : r + p;
  }
  return r;
}

// The max and the sum of exp of a segment's logits wrow[perm[j]], with the
// bits of gather_sum_kernel<true>'s two block reductions; one warp.
__device__ __forceinline__ void segment_softmax(const float* __restrict__ wrow,
                                                const int* __restrict__ perm, int s0, int s1,
                                                int lane, float& mx, float& den) {
  float m = NEG_INF;
  for (int j = s0 + lane; j < s1; j += 32) m = fmaxf(m, wrow[perm[j]]);
  const float M = warp_max(m);
  float d = block_order_sum(s0, s1, lane,
                            [&](float p, int j) { return p + expf(wrow[perm[j]] - M); });
  mx = M;
  den = d == 0.f ? 1.f : d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One W-byte copy to shared address dst; zeros when !ok (src is not read).
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  }
}

// Columns [c0, c0 + C) of the N rows of one sample's [N, D] array into a
// tile of N rows C + PAD floats apart, by 16-byte copies (VEC: D % 4 == 0,
// src 16-byte aligned) or 4-byte ones; columns at or past D become zero.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int N,
                                          int D, int C, int c0, int tid) {
  const uint32_t base = smem_addr(tile);
  const int ld = C + PAD;
  if (VEC) {
    const int q = C / 4;
    for (int i = tid; i < N * q; i += NT) {
      const int r = i / q, c = 4 * (i - r * q);
      const bool ok = c0 + c < D;
      cp_async<16>(base + 4u * (r * ld + c), src + (long long)r * D + (ok ? c0 + c : 0), ok);
    }
  } else {
    for (int i = tid; i < N * C; i += NT) {
      const int r = i / C, c = i - r * C;
      const bool ok = c0 + c < D;
      cp_async<4>(base + 4u * (r * ld + c), src + (long long)r * D + (ok ? c0 + c : 0), ok);
    }
  }
}

// ------------------------------------------------------------ route "row"
// out[b, v, c] = scale * sum_{j in [ptr[v], ptr[v+1])} wt(b, perm[j]) * feat[b, v, c]:
// the segment's own row, for gather_target's forward (feat = x) and dx
// (feat = g_out). One warp per (sample, node, chunk of 32 * CPTT columns),
// chunks fastest; the chunk is read once into registers (4 consecutive
// columns a lane with VEC, else lane-strided), then the weights run over it
// in CSR order, one FMA each, as gather_sum_kernel sums: the same bits. With
// SOFTMAX the weights are the segment's softmax of wt[b * wstride + e], which
// the chunk-0 warp writes to w_out[b * E + e].
template <bool SOFTMAX, bool VEC, int CPTT>
__global__ void __launch_bounds__(NT)
row_sum_kernel(const float* __restrict__ feat, const float* __restrict__ wt, long long wstride,
               const int* __restrict__ perm, const int* __restrict__ ptr,
               float* __restrict__ out, float* __restrict__ w_out, int B, int N, int E, int D,
               int nchunk, float scale) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (item >= (long long)B * N * nchunk) return;  // whole warps leave together
  const int chunk = (int)(item % nchunk);
  const long long bv = item / nchunk;  // b * N + v
  const int v = (int)(bv % N), b = (int)(bv / N);
  const int s0 = ptr[v], s1 = ptr[v + 1];
  const float* row = feat + bv * D;
  const int c0 = chunk * 32 * CPTT;
  float xr[CPTT], acc[CPTT];
#pragma unroll
  for (int k = 0; k < CPTT; ++k) xr[k] = acc[k] = 0.f;
  if (VEC) {
#pragma unroll
    for (int k = 0; k < CPTT / 4; ++k) {
      const int c = c0 + 128 * k + 4 * lane;
      if (c < D) {
        const float4 t = *reinterpret_cast<const float4*>(row + c);
        xr[4 * k] = t.x;
        xr[4 * k + 1] = t.y;
        xr[4 * k + 2] = t.z;
        xr[4 * k + 3] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPTT; ++k) {
      const int c = c0 + 32 * k + lane;
      if (c < D) xr[k] = row[c];
    }
  }
  const float* wrow = wt + (long long)b * wstride;
  float mx = 0.f, den = 1.f;
  if (SOFTMAX) segment_softmax(wrow, perm, s0, s1, lane, mx, den);
  for (int j0 = s0; j0 < s1; j0 += 32) {
    const int j = j0 + lane;
    float w = 0.f;
    if (j < s1) {
      const int e = perm[j];
      w = wrow[e];
      if (SOFTMAX) {
        w = expf(w - mx) / den;
        if (chunk == 0) w_out[(long long)b * E + e] = w;
      }
    }
    const int n = min(32, s1 - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float wj = __shfl_sync(0xffffffffu, w, jj);
#pragma unroll
      for (int k = 0; k < CPTT; ++k) acc[k] = fmaf(wj, xr[k], acc[k]);
    }
  }
  float* orow = out + bv * D;
  if (VEC) {
#pragma unroll
    for (int k = 0; k < CPTT / 4; ++k) {
      const int c = c0 + 128 * k + 4 * lane;
      if (c < D) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(scale * acc[4 * k], scale * acc[4 * k + 1], scale * acc[4 * k + 2],
                        scale * acc[4 * k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPTT; ++k) {
      const int c = c0 + 32 * k + lane;
      if (c < D) orow[c] = scale * acc[k];
    }
  }
}

// dgamma over the dst-CSR, one warp per (sample, node). s_e is, with ROW,
// the segment's one dot product g_out[b, v] . x[b, v] (every edge gathers v's
// row) in spmm_dgamma_kernel's lane order, or else the tile route's dot
// product, which tile_dot_kernel left in dgamma[b * E + e]. Then, as
// spmm_dgamma_kernel: s_e enters minus the segment's first one, plus g_w;
// the block-order sum of w * s; dgamma = w * (s - that sum), in place. With
// ROW the bits are spmm_dgamma_kernel's.
template <bool ROW>
__global__ void __launch_bounds__(NT)
dgamma_kernel(const float* __restrict__ g_out, const float* __restrict__ x,
              const float* __restrict__ w, const float* __restrict__ g_w,
              const int* __restrict__ perm, const int* __restrict__ ptr, float* dgamma, int B,
              int N, int E, int D) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (item >= (long long)B * N) return;
  const int v = (int)(item % N), b = (int)(item / N);
  const int s0 = ptr[v], s1 = ptr[v + 1];
  if (s0 == s1) return;
  const long long eb = (long long)b * E;
  float dot = 0.f;
  if (ROW) {
    const float* grow = g_out + item * D;
    const float* xrow = x + item * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s = fmaf(grow[c], xrow[c], s);
    dot = warp_sum(s);
  }
  auto sdot = [&](int e) { return ROW ? dot : dgamma[eb + e]; };
  const float ref = sdot(perm[s0]);
  auto sval = [&](int e) {
    return (sdot(e) - ref) + (g_w != nullptr ? g_w[eb + e] : 0.f);
  };
  const float inner = block_order_sum(s0, s1, lane, [&](float p, int j) {
    const int e = perm[j];
    return fmaf(w[eb + e], sval(e), p);
  });
  for (int j = s0 + lane; j < s1; j += 32) {
    const int e = perm[j];
    dgamma[eb + e] = w[eb + e] * (sval(e) - inner);
  }
}

// ----------------------------------------------------------- route "tile"
// The CSR positions of node part p of P: nodes [n0, n1) of ceil(N / P) each.
__device__ __forceinline__ void node_part(int N, int P, int p, int& n0, int& n1) {
  const int per = (N + P - 1) / P;
  n0 = min(N, p * per);
  n1 = min(N, n0 + per);
}

// CSR positions [st0, st0 + n) into es: (weight, gathered row's offset in
// a tile, as int bits). The weight is wrow[perm[j]], or with SOFTMAX its
// softmax in node seg[j]'s segment from that node's max and sum (mx_s,
// den_s), which w_out[perm[j]] also gets when it is not null. The index
// loads of four positions a thread are issued before the gathers they
// feed, so a pass costs two trips to L2, not two a position.
template <bool SOFTMAX>
__device__ __forceinline__ void stage_edges(float2* es, int st0, int n,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ nbr,
                                            const int* __restrict__ seg,
                                            const float* __restrict__ wrow, const float* mx_s,
                                            const float* den_s, float* __restrict__ w_out, int ld,
                                            int tid) {
  for (int i0 = 0; i0 < n; i0 += 4 * NT) {
    int e[4], u[4], v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * NT + tid;
      e[k] = u[k] = v[k] = 0;
      if (i < n) {
        e[k] = perm[st0 + i];
        u[k] = nbr[st0 + i];
        if (SOFTMAX) v[k] = seg[st0 + i];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * NT + tid;
      if (i < n) {
        float w = wrow[e[k]];
        if (SOFTMAX) {
          w = expf(w - mx_s[v[k]]) / den_s[v[k]];
          if (w_out != nullptr) w_out[e[k]] = w;
        }
        es[i] = make_float2(w, __int_as_float(u[k] * ld));
      }
    }
  }
}

// One weighted sum's operands: the gathered rows, the CSR (perm, ptr, nbr:
// the gathered node of each position) and the output.
struct SumOp {
  const float* feat;
  const int* perm;
  const int* ptr;
  const int* nbr;
  float* out;
};

// out[b, v, c] = scale * sum_{j in [ptr[v], ptr[v+1])} wt(b, perm[j]) * feat[b, nbr[j], c]
// for operand set ops[blockIdx.z] (sddmm's dq and dk share a launch). One
// CTA per (column group g of G, node part p of P, sample b) takes chunks g, g + G, ... of C
// columns: the sample's N rows of a chunk are staged in shared memory while
// the next chunk's copy is in flight. The part's CSR positions are staged
// as (weight, row offset) pairs min(E, EC) at a time (all at once where
// they fit, else those of each round of nodes, in passes). A thread sums
// one (node, 4 columns) item over the node's segment in CSR order, one FMA
// an element, as gather_sum_kernel does: the same bits. With SOFTMAX
// (the forward) the weights are the softmax of wt within each segment,
// each node's max and sum found first by a warp (segment_softmax's bits),
// and the g == 0 CTAs write them to w_out[b * E + e].
template <bool SOFTMAX, bool VEC>
__global__ void __launch_bounds__(NT)
tile_sum_kernel(SumOp op0, SumOp op1, const float* __restrict__ wt, long long wstride,
                const int* __restrict__ seg, float* __restrict__ w_out, int N, int E, int D,
                int C, int G, int P, float scale) {
  extern __shared__ __align__(16) float smem[];
  const SumOp& op = blockIdx.z == 0 ? op0 : op1;
  const float* __restrict__ feat = op.feat;
  const int* __restrict__ perm = op.perm;
  const int* __restrict__ ptr = op.ptr;
  const int* __restrict__ nbr = op.nbr;
  float* __restrict__ out = op.out;
  const int tid = threadIdx.x, g = blockIdx.x % G, b = blockIdx.y;
  int n0, n1;
  node_part(N, P, blockIdx.x / G, n0, n1);
  const int ld = C + PAD, es = min(E, EC);
  const int nc = (D + C - 1) / C;
  const int mine = (nc - 1 - g) / G + 1;  // g < G <= nc
  if (n0 == n1) return;                   // the whole CTA
  float* tiles = smem;
  float2* es_s = reinterpret_cast<float2*>(smem + 2 * N * ld);
  int* ptr_s = reinterpret_cast<int*>(es_s + es);  // ptr[n0 .. n1]
  float* mx_s = reinterpret_cast<float*>(ptr_s + N + 1);
  float* den_s = mx_s + N;
  const float* fb = feat + (long long)b * N * D;
  const float* wrow = wt + (long long)b * wstride;
  float* wo = SOFTMAX && g == 0 ? w_out + (long long)b * E : nullptr;
  load_tile<VEC>(tiles, fb, N, D, C, g * C, tid);
  cp_commit();
  for (int i = tid; i <= n1 - n0; i += NT) ptr_s[i] = ptr[n0 + i];
  if (SOFTMAX) {
    const int lane = tid & 31;
    for (int v = n0 + (tid >> 5); v < n1; v += NW) {
      float mx, den;
      segment_softmax(wrow, perm, ptr[v], ptr[v + 1], lane, mx, den);
      if (lane == 0) {
        mx_s[v] = mx;
        den_s[v] = den;
      }
    }
  }
  __syncthreads();
  const int q_all = ptr_s[n1 - n0];
  int st0 = ptr_s[0], st1 = min(q_all, st0 + es);  // the staged CSR positions
  stage_edges<SOFTMAX>(es_s, st0, st1 - st0, perm, nbr, seg, wrow, mx_s, den_s, wo, ld, tid);
  const int Q = C / 4, items = (n1 - n0) * Q;
  float* ob = out + (long long)b * N * D;
  for (int m = 0; m < mine; ++m) {
    const int c0 = (g + m * G) * C;
    if (m + 1 < mine) {
      load_tile<VEC>(tiles + ((m + 1) & 1) * N * ld, fb, N, D, C, c0 + G * C, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* tile = tiles + (m & 1) * N * ld;
    for (int it = 0; it * NT < items; ++it) {
      const int item = it * NT + tid;
      const bool active = item < items;
      const int vi = active ? item / Q : 0, q = item - vi * Q;
      // this round's nodes, and the CSR positions of their segments
      const int r0 = ptr_s[it * NT / Q], r1 = ptr_s[min(n1 - n0, ((it + 1) * NT - 1) / Q + 1)];
      const int s0 = active ? ptr_s[vi] : 0, s1 = active ? ptr_s[vi + 1] : 0;
      const float* tq = tile + 4 * q;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p0 = r0; p0 < r1; p0 += es) {
        const int p1 = min(p0 + es, r1);
        if (p0 < st0 || p1 > st1) {  // the same for every thread
          __syncthreads();
          st0 = p0;
          st1 = min(p0 + es, q_all);
          stage_edges<SOFTMAX>(es_s, st0, st1 - st0, perm, nbr, seg, wrow, mx_s, den_s,
                               m == 0 ? wo : nullptr, ld, tid);
          __syncthreads();
        }
        int j = max(s0, p0) - st0;
        const int j1 = min(s1, p1) - st0;
        // four edges' loads ahead of their FMAs, which keep CSR order
        for (; j + 4 <= j1; j += 4) {
          float2 a[4];
          float4 x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] = es_s[j + k];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            x[k] = *reinterpret_cast<const float4*>(tq + __float_as_int(a[k].y));
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc.x = fmaf(a[k].x, x[k].x, acc.x);
            acc.y = fmaf(a[k].x, x[k].y, acc.y);
            acc.z = fmaf(a[k].x, x[k].z, acc.z);
            acc.w = fmaf(a[k].x, x[k].w, acc.w);
          }
        }
        for (; j < j1; ++j) {
          const float2 a = es_s[j];
          const float4 x = *reinterpret_cast<const float4*>(tq + __float_as_int(a.y));
          acc.x = fmaf(a.x, x.x, acc.x);
          acc.y = fmaf(a.x, x.y, acc.y);
          acc.z = fmaf(a.x, x.z, acc.z);
          acc.w = fmaf(a.x, x.w, acc.w);
        }
      }
      const int c = c0 + 4 * q;
      if (active && c < D) {
        float* o = ob + (long long)(n0 + vi) * D + c;
        if (VEC) {
          *reinterpret_cast<float4*>(o) =
              make_float4(scale * acc.x, scale * acc.y, scale * acc.z, scale * acc.w);
        } else {
          const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (c + k < D) o[k] = scale * a[k];
          }
        }
      }
    }
    __syncthreads();  // the tile is read: the next round's copy may overwrite it
  }
}

// Edge dot products over the dst-CSR: position j (edge perm[j], node
// seg[j], source nbr[j]) gets scale * rows[b, seg[j]] . feat[b, nbr[j]].
// A cluster of G CTAs (column groups) per (part p of P of the positions,
// sample b): each stages both operands' N rows of its chunks (g, g + G, ...)
// in shared memory, double-buffered by cp.async. A group of 8 lanes takes a
// run of consecutive positions (mostly one segment) and holds the
// destination row's chunk in registers (C / 8 columns a lane) while it walks
// them: for each position its lanes read one contiguous C-column slice of
// the source row (no bank conflict: each quarter-warp of a 16-byte load is
// one group), the product is summed in a fixed order within a lane and then
// over the group by three shuffles, and the group's first lane adds it to
// the position's partial sum. The G partial sums then meet through
// distributed shared memory: CTA g adds a slice of the positions over the
// cluster's CTAs in rank order. No float atomics, no scratch.
template <bool VEC, int CF>
__global__ void __launch_bounds__(NT)
tile_dot_kernel(const float* __restrict__ rows, const float* __restrict__ feat,
                const int* __restrict__ perm, const int* __restrict__ nbr,
                const int* __restrict__ seg, float* __restrict__ out, int N, int E, int D,
                int G, int P, float scale) {
  constexpr int C = 32 * CF;  // CF float4s a lane: 8 lanes x 4 CF columns
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, g = (int)cluster.block_rank(), b = blockIdx.y;
  const int ld = C + PAD, tsz = N * ld;
  const int per = (E + P - 1) / P;
  const int j0 = min(E, (int)(blockIdx.x / G) * per), n = min(E, j0 + per) - j0;
  float* kt = smem;            // 2 buffers of the gathered operand
  float* qt = smem + 2 * tsz;  // 2 of the destination operand
  int2* pos_s = reinterpret_cast<int2*>(smem + 4 * tsz);  // (source, node) row offsets
  float* part_s = reinterpret_cast<float*>(pos_s + per);
  const int l8 = tid & 7, grp = tid >> 3;
  const unsigned gmask = 0xffu << (tid & 24);
  const int R = (n + NT / 8 - 1) / (NT / 8), r0 = grp * R, rcnt = max(0, min(R, n - r0));
  const float* fb = feat + (long long)b * N * D;
  const float* rb = rows + (long long)b * N * D;
  const int nc = (D + C - 1) / C, mine = (nc - 1 - g) / G + 1;
  load_tile<VEC>(kt, fb, N, D, C, g * C, tid);
  load_tile<VEC>(qt, rb, N, D, C, g * C, tid);
  cp_commit();
  for (int i = tid; i < n; i += NT) {
    part_s[i] = 0.f;
    pos_s[i] = make_int2(nbr[j0 + i] * ld, seg[j0 + i] * ld);
  }
  for (int m = 0; m < mine; ++m) {
    const int c0 = (g + m * G) * C;
    if (m + 1 < mine) {
      const int nb = ((m + 1) & 1) * tsz;
      load_tile<VEC>(kt + nb, fb, N, D, C, c0 + G * C, tid);
      load_tile<VEC>(qt + nb, rb, N, D, C, c0 + G * C, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* kb = kt + (m & 1) * tsz + 4 * l8;
    const float* qb = qt + (m & 1) * tsz + 4 * l8;
    float4 qv[CF];
    int cur = -1;
    for (int i = 0; i < rcnt; ++i) {  // the same count for the group's 8 lanes
      const int2 uv = pos_s[r0 + i];
      if (uv.y != cur) {
        cur = uv.y;
#pragma unroll
        for (int c = 0; c < CF; ++c) qv[c] = *reinterpret_cast<const float4*>(qb + cur + 32 * c);
      }
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < CF; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(kb + uv.x + 32 * c);
        s0 = fmaf(qv[c].x, x.x, s0);
        s1 = fmaf(qv[c].y, x.y, s1);
        s2 = fmaf(qv[c].z, x.z, s2);
        s3 = fmaf(qv[c].w, x.w, s3);
      }
      float s = (s0 + s1) + (s2 + s3);
      s += __shfl_xor_sync(gmask, s, 1);
      s += __shfl_xor_sync(gmask, s, 2);
      s += __shfl_xor_sync(gmask, s, 4);
      if (l8 == 0) part_s[r0 + i] += s;
    }
    __syncthreads();  // the tiles are read
  }
  // this CTA's slice of the positions: their edge ids read before the
  // barrier, the G partial sums read together, then added in rank order
  const int sl = (n + G - 1) / G, jj0 = g * sl + tid, jj1 = min(n, (g + 1) * sl);
  const int e0 = jj0 < jj1 ? perm[j0 + jj0] : 0;
  cluster.sync();  // every CTA's partial sums are in its shared memory
  for (int jj = jj0; jj < jj1; jj += NT) {
    const int e = jj == jj0 ? e0 : perm[j0 + jj];
    float v[MAX_GROUPS];
#pragma unroll
    for (int r = 0; r < MAX_GROUPS; ++r)
      v[r] = r < G ? cluster.map_shared_rank(part_s, r)[jj] : 0.f;
    float s = v[0];
#pragma unroll
    for (int r = 1; r < MAX_GROUPS; ++r) {
      if (r < G) s += v[r];
    }
    out[(long long)b * E + e] = scale * s;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ------------------------------------------------------------ route "csr"
// The previous design: one CTA per (node, sample, 1024 columns), each edge's
// row read from L2.
// out[b, v, c] = scale * sum_{j in [ptr[v], ptr[v+1])} wt(b, perm[j]) * feat[b, gidx[perm[j]], c]
// with wt(b, e) = wt[b * wstride + e], or with SOFTMAX its softmax within
// the segment, which the z == 0 CTA also writes to w_out[b * E + e].
template <bool SOFTMAX>
__global__ void __launch_bounds__(NT)
gather_sum_kernel(const float* __restrict__ feat, const float* __restrict__ wt,
                  long long wstride, const int* __restrict__ gidx,
                  const int* __restrict__ perm, const int* __restrict__ ptr,
                  float* __restrict__ out, float* __restrict__ w_out, int N, int E,
                  int D, float scale) {
  __shared__ float w_s[CH];
  __shared__ int g_s[CH];
  __shared__ float red[NW];
  const int tid = threadIdx.x;
  const int v = blockIdx.x, b = blockIdx.y;
  const int c0 = blockIdx.z * (NT * CPT) + tid;
  const int s0 = ptr[v], s1 = ptr[v + 1];
  const float* wrow = wt + (long long)b * wstride;
  float mx = 0.f, den = 1.f;
  if (SOFTMAX) {
    float m = NEG_INF;
    for (int j = s0 + tid; j < s1; j += NT) m = fmaxf(m, wrow[perm[j]]);
    mx = block_reduce<true>(m, red);
    float s = 0.f;
    for (int j = s0 + tid; j < s1; j += NT) s += expf(wrow[perm[j]] - mx);
    den = block_reduce<false>(s, red);
    if (den == 0.f) den = 1.f;
  }
  float acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0.f;
  const float* fb = feat + (long long)b * N * D;
  for (int j0 = s0; j0 < s1; j0 += CH) {
    const int n = min(CH, s1 - j0);
    __syncthreads();  // the chunk before is consumed
    if (tid < n) {
      const int e = perm[j0 + tid];
      float w = wrow[e];
      if (SOFTMAX) {
        w = expf(w - mx) / den;
        if (blockIdx.z == 0) w_out[(long long)b * E + e] = w;
      }
      w_s[tid] = w;
      g_s[tid] = gidx[e];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float w = w_s[j];
      const float* row = fb + (long long)g_s[j] * D;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = c0 + k * NT;
        if (c < D) acc[k] += w * row[c];
      }
    }
  }
  float* orow = out + ((long long)b * N + v) * D;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = c0 + k * NT;
    if (c < D) orow[c] = scale * acc[k];
  }
}

// dgamma over the dst-CSR, one CTA per (node, sample): a warp per edge for
// the dot product of s_e, kept in dgamma itself; then the segment's sum of
// w * s; then the final value in place. The dot products enter minus the
// segment's first one, and g_w is added to that difference: the weights sum
// to 1 only up to rounding, and a dot product over D can be some hundred
// times larger than the differences that matter, so the uncentred form
// loses about |dot| * 1e-7 (the shift changes nothing in exact arithmetic).
__global__ void __launch_bounds__(NT)
spmm_dgamma_kernel(const float* __restrict__ g_out, const float* __restrict__ x,
                   const float* __restrict__ w, const float* __restrict__ g_w,
                   const int* __restrict__ gidx, const int* __restrict__ perm,
                   const int* __restrict__ ptr, float* dgamma, int N, int E, int D) {
  __shared__ float red[NW];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int v = blockIdx.x, b = blockIdx.y;
  const int s0 = ptr[v], s1 = ptr[v + 1];
  const float* grow = g_out + ((long long)b * N + v) * D;
  const long long eb = (long long)b * E;
  for (int j = s0 + wid; j < s1; j += NW) {
    const int e = perm[j];
    const float* xrow = x + ((long long)b * N + gidx[e]) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += grow[c] * xrow[c];
    s = warp_sum(s);
    if (lane == 0) dgamma[eb + e] = s;
  }
  __syncthreads();
  const float ref = s0 < s1 ? dgamma[eb + perm[s0]] : 0.f;
  float p = 0.f;
  for (int j = s0 + tid; j < s1; j += NT) {
    const int e = perm[j];
    const float s = (dgamma[eb + e] - ref) + (g_w != nullptr ? g_w[eb + e] : 0.f);
    p += w[eb + e] * s;
  }
  const float inner = block_reduce<false>(p, red);  // every read of ref is done
  for (int j = s0 + tid; j < s1; j += NT) {
    const int e = perm[j];
    const float s = (dgamma[eb + e] - ref) + (g_w != nullptr ? g_w[eb + e] : 0.f);
    dgamma[eb + e] = w[eb + e] * (s - inner);
  }
}

// alpha[b, e] = scale * q[b, dst_e] . k[b, src_e], one warp per (sample, edge).
__global__ void __launch_bounds__(NT)
sddmm_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const int* __restrict__ src, const int* __restrict__ dst,
             float* __restrict__ alpha, long long BE, int N, int E, int D,
             float scale) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (item >= BE) return;  // whole warps leave together
  const long long b = item / E;
  const int e = (int)(item - b * E);
  const float* qrow = q + (b * N + dst[e]) * D;
  const float* krow = k + (b * N + src[e]) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += qrow[c] * krow[c];
  s = warp_sum(s);
  if (lane == 0) alpha[item] = scale * s;
}

// ------------------------------------------------------------ launches
bool bad_shape(int B, int N, int E, int D) {
  return B <= 0 || B > 65535 || N <= 0 || E <= 0 || D <= 0;
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

unsigned warp_blocks(long long warps) { return (unsigned)cdiv(warps, NW); }

template <bool SOFTMAX>
int launch_row_sum(const Plan& p, const void* feat, const void* wt, long long wstride,
                   const void* perm, const void* ptr, void* out, void* w_out, int B, int N,
                   int E, int D, float scale, cudaStream_t s) {
  auto args = [&](auto kern) {
    kern<<<p.grid_x, NT, 0, s>>>((const float*)feat, (const float*)wt, wstride,
                                 (const int*)perm, (const int*)ptr, (float*)out,
                                 (float*)w_out, B, N, E, D, p.groups, scale);
  };
  const bool vec = p.copy == 16;
  if (p.chunk == 256) {
    vec ? args(row_sum_kernel<SOFTMAX, true, 8>) : args(row_sum_kernel<SOFTMAX, false, 8>);
  } else {
    vec ? args(row_sum_kernel<SOFTMAX, true, 4>) : args(row_sum_kernel<SOFTMAX, false, 4>);
  }
  return (int)cudaGetLastError();
}

// tile_sum_kernel on the plan's grid, for one operand set or (sddmm's dq and
// dk) two; seg and w_out are read with SOFTMAX only.
template <bool SOFTMAX>
int launch_tile_sum(const Plan& p, SumOp op0, const SumOp* op1, const void* wt,
                    long long wstride, const void* seg, void* w_out, int N, int E, int D,
                    float scale, cudaStream_t s) {
  const int bytes = (int)sum_smem(N, p.chunk, E);
  auto kern = p.copy == 16 ? tile_sum_kernel<SOFTMAX, true> : tile_sum_kernel<SOFTMAX, false>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.grid_x, p.grid_y, op1 != nullptr ? 2 : 1), NT, bytes, s>>>(
      op0, op1 != nullptr ? *op1 : op0, (const float*)wt, wstride, (const int*)seg,
      (float*)w_out, N, E, D, p.chunk, p.groups, p.parts, scale);
  return (int)cudaGetLastError();
}

SumOp sum_op(const void* feat, const void* perm, const void* ptr, const void* nbr, void* out) {
  return SumOp{(const float*)feat, (const int*)perm, (const int*)ptr, (const int*)nbr,
               (float*)out};
}

// tile_dot_kernel in clusters of the plan's column groups: scale * the dot
// products of rows (destination side) and feat (gathered at nbr) into out.
template <bool VEC, int CF>
int launch_tile_dot_cf(const Plan& p, const void* rows, const void* feat, const void* perm,
                       const void* nbr, const void* seg, void* out, int N, int E, int D,
                       float scale, cudaStream_t s) {
  const int bytes = (int)dot_smem(N, p.chunk, (int)cdiv(E, p.parts));
  auto kern = tile_dot_kernel<VEC, CF>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.grid_x, p.grid_y);
  if (p.groups == 1) {  // a CTA is its own cluster
    kern<<<grid, NT, bytes, s>>>((const float*)rows, (const float*)feat, (const int*)perm,
                                 (const int*)nbr, (const int*)seg, (float*)out, N, E, D, 1,
                                 p.parts, scale);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const float*)rows, (const float*)feat,
                           (const int*)perm, (const int*)nbr, (const int*)seg, (float*)out, N, E,
                           D, p.groups, p.parts, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_tile_dot(const Plan& p, const void* rows, const void* feat, const void* perm,
                    const void* nbr, const void* seg, void* out, int N, int E, int D,
                    float scale, cudaStream_t s) {
#define RD_DOT(VEC, CF) \
  launch_tile_dot_cf<VEC, CF>(p, rows, feat, perm, nbr, seg, out, N, E, D, scale, s)
  const bool vec = p.copy == 16;
  if (p.chunk == 128) return vec ? RD_DOT(true, 4) : RD_DOT(false, 4);
  if (p.chunk == 64) return vec ? RD_DOT(true, 2) : RD_DOT(false, 2);
  return vec ? RD_DOT(true, 1) : RD_DOT(false, 1);
#undef RD_DOT
}

template <bool SOFTMAX>
int launch_gather_sum(const void* feat, const void* wt, long long wstride,
                      const void* gidx, const void* perm, const void* ptr, void* out,
                      void* w_out, int B, int N, int E, int D, float scale,
                      cudaStream_t stream) {
  gather_sum_kernel<SOFTMAX><<<dim3(N, B, (D + NT * CPT - 1) / (NT * CPT)), NT, 0, stream>>>(
      (const float*)feat, (const float*)wt, wstride, (const int*)gidx,
      (const int*)perm, (const int*)ptr, (float*)out, (float*)w_out, N, E, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan of a call (8 ints, Plan's fields) for `kind` (Kind) and
// operands whose addresses share `align` bytes; cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int rd_graph_plan(int B, int N, int E, int D, int kind, int align, int* out) {
  Plan p;
  if (bad_shape(B, N, E, D) || !make_graph_plan(B, N, E, D, kind, align, &p))
    return (int)cudaErrorInvalidValue;
  std::memcpy(out, &p, sizeof p);
  return 0;
}

// One edge list's index arrays (ops/sparse.py Topology.table), int32 [E]
// unless said: src and dst as given; for the dst-CSR perm (edge ids in
// segment order), ptr [N+1], nbr (each position's source) and seg (its
// segment's node); for the src-CSR perm, ptr and nbr (each position's dst).
struct Topo {
  const int *src, *dst, *dst_perm, *dst_ptr, *dst_nbr, *dst_seg, *src_perm, *src_ptr,
      *src_nbr;
};

// gamma [B, E] with row stride gamma_stride (0 for one row broadcast over the
// batch); the rows of x gathered at dst (gather_target) or src. Writes out
// [B, N, D] and w [B, E] (the caller's edge order). plan: the wrapper's
// launch plan, checked.
extern "C" int rd_spmm_fwd(const void* x, const void* gamma, long long gamma_stride,
                           const Topo* t, void* out, void* w, int B, int N, int E, int D,
                           int gather_target, const int* plan, void* stream) {
  Plan p;
  if (bad_shape(B, N, E, D) || gamma_stride < 0 ||
      !check_plan(plan, B, N, E, D, gather_target ? FWD_TARGET : FWD_SOURCE, {x, out}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.route == ROW) {
    return launch_row_sum<true>(p, x, gamma, gamma_stride, t->dst_perm, t->dst_ptr, out, w, B,
                                N, E, D, 1.f, s);
  }
  if (p.route == TILE) {
    return launch_tile_sum<true>(p, sum_op(x, t->dst_perm, t->dst_ptr, t->dst_nbr, out),
                                 nullptr, gamma, gamma_stride, t->dst_seg, w, N, E, D, 1.f, s);
  }
  return launch_gather_sum<true>(x, gamma, gamma_stride, gather_target ? t->dst : t->src,
                                 t->dst_perm, t->dst_ptr, out, w, B, N, E, D, 1.f, s);
}

// dgamma (skipped when it is null) over the dst-CSR, then dx over the CSR of
// the gathered end (dst with gather_target, else src). g_w may be null (no
// cotangent on the weights).
extern "C" int rd_spmm_bwd(const void* g_out, const void* g_w, const void* x, const void* w,
                           const Topo* t, void* dx, void* dgamma, int B, int N, int E, int D,
                           int gather_target, const int* plan, void* stream) {
  Plan p;
  if (bad_shape(B, N, E, D) ||
      !check_plan(plan, B, N, E, D, gather_target ? BWD_TARGET : BWD_SOURCE, {g_out, x, dx}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (p.route == ROW) {
    if (dgamma != nullptr) {
      dgamma_kernel<true><<<warp_blocks((long long)B * N), NT, 0, s>>>(
          (const float*)g_out, (const float*)x, (const float*)w, (const float*)g_w, t->dst_perm,
          t->dst_ptr, (float*)dgamma, B, N, E, D);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return launch_row_sum<false>(p, g_out, w, E, t->dst_perm, t->dst_ptr, dx, nullptr, B, N, E,
                                 D, 1.f, s);
  }
  if (p.route == TILE) {
    if (dgamma != nullptr) {
      // the dot products into dgamma, then the segment reduction in place
      int e = launch_tile_dot(p, g_out, x, t->dst_perm, t->dst_nbr, t->dst_seg, dgamma, N, E, D,
                              1.f, s);
      if (e != 0) return e;
      dgamma_kernel<false><<<warp_blocks((long long)B * N), NT, 0, s>>>(
          nullptr, nullptr, (const float*)w, (const float*)g_w, t->dst_perm, t->dst_ptr,
          (float*)dgamma, B, N, E, D);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return launch_tile_sum<false>(p, sum_op(g_out, t->src_perm, t->src_ptr, t->src_nbr, dx),
                                  nullptr, w, E, nullptr, nullptr, N, E, D, 1.f, s);
  }
  const int* gidx = gather_target ? t->dst : t->src;
  if (dgamma != nullptr) {
    spmm_dgamma_kernel<<<dim3(N, B), NT, 0, s>>>(
        (const float*)g_out, (const float*)x, (const float*)w, (const float*)g_w, gidx,
        t->dst_perm, t->dst_ptr, (float*)dgamma, N, E, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return launch_gather_sum<false>(g_out, w, E, t->dst, gather_target ? t->dst_perm : t->src_perm,
                                  gather_target ? t->dst_ptr : t->src_ptr, dx, nullptr, B, N, E,
                                  D, 1.f, s);
}

// alpha [B, E].
extern "C" int rd_sddmm_fwd(const void* q, const void* k, const Topo* t, void* alpha, int B,
                            int N, int E, int D, float scale, const int* plan, void* stream) {
  Plan p;
  if (bad_shape(B, N, E, D) || !check_plan(plan, B, N, E, D, SDDMM_FWD, {q, k}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.route == TILE) {
    return launch_tile_dot(p, q, k, t->dst_perm, t->dst_nbr, t->dst_seg, alpha, N, E, D, scale,
                           s);
  }
  const long long BE = (long long)B * E, blocks = cdiv(BE, NW);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  sddmm_kernel<<<(unsigned)blocks, NT, 0, s>>>((const float*)q, (const float*)k, t->src, t->dst,
                                               (float*)alpha, BE, N, E, D, scale);
  return (int)cudaGetLastError();
}

// dq over the dst-CSR (gathering k at src), dk over the src-CSR (gathering q
// at dst); d_alpha [B, E] contiguous.
extern "C" int rd_sddmm_bwd(const void* d_alpha, const void* q, const void* k, const Topo* t,
                            void* dq, void* dk, int B, int N, int E, int D, float scale,
                            const int* plan, void* stream) {
  Plan p;
  if (bad_shape(B, N, E, D) || !check_plan(plan, B, N, E, D, SDDMM_BWD, {q, k, dq, dk}, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.route == TILE) {
    const SumOp dk_op = sum_op(q, t->src_perm, t->src_ptr, t->src_nbr, dk);
    return launch_tile_sum<false>(p, sum_op(k, t->dst_perm, t->dst_ptr, t->dst_nbr, dq), &dk_op,
                                  d_alpha, E, nullptr, nullptr, N, E, D, scale, s);
  }
  int err = launch_gather_sum<false>(k, d_alpha, E, t->src, t->dst_perm, t->dst_ptr, dq, nullptr,
                                     B, N, E, D, scale, s);
  if (err != 0) return err;
  return launch_gather_sum<false>(q, d_alpha, E, t->dst, t->src_perm, t->src_ptr, dk, nullptr, B,
                                  N, E, D, scale, s);
}
