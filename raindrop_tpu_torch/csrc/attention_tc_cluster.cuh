// Tensor-core device code of the packed-heads attention for bf16 operands
// past head dim 368 (route "tc_cluster"; P12's sensor-wise model at one
// head, hd 720): the forward over one 64-row query block, the dq pass over
// one 64-row query block and the dk/dv pass over one 64-row key block, of
// one (sample, head), by a thread-block cluster of n CTAs. Like the other
// tensor-core routines they take base pointers and a row stride, so the
// kernels of flash_packed_{fwd,dq,dkv}_tcc.cu run them for
// flash_mha_packed, flash_mha (flash_split.cu) and the fused layer's
// attention (fused_encoder.cu, fused_encoder_bwd.cu, on the head's view of
// its bf16 qkv rows, row stride 3 d). At those head dims they replace
// raindrop_tpu/ops/flash_attention.py:_packed_fwd_kernel (:566) and
// :_packed_bwd_kernel (:610), the flash_mha kernels (:121, :146, :191,
// :237, :275) and the attention of raindrop_tpu/ops/fused_encoder.py
// :_fwd_kernel (:131) and :_bwd_kernel (:183); f32 operands (and bf16
// past hd 2048) stay on attention_hd_stream.cuh.
//
// What bounds it: bytes (P12-sw at one head, B=128, T=215, lengths uniform
// on 0..T: about 158 MB forward, 47 us at 3.35 TB/s; 434 MB backward,
// 130 us), as at hd 360. What stood between attention_tc_wide.cuh and
// these widths: a 64 x 720 f32 accumulator is 360 registers a thread of a
// warpgroup, and a 64 x 720 bf16 tile alone is 92,160 bytes. So the head
// dim is cut over the CTAs of a cluster:
// - n = ceil(hd / 256) CTAs per (64-row block, head, sample), rank r owning
//   the W columns r W .. r W + W - 1 of q, k, v, dO and the outputs, W the
//   per-CTA share rounded up to 32 (hd 372: 2 x 192; 720: 3 x 256, the
//   last 48 columns zeroed pad; 1024: 4 x 256). A CTA copies only its own
//   columns. The grid's x axis holds the row blocks times n, the rank
//   fastest; n <= 8 (the portable cluster size) covers hd <= 2048.
// - The scores reduce over the whole head dim: each CTA computes the
//   partial tile of its slice (S_r = Q_r K_r^T, wgmma m64n32k16 over W / 16
//   k-steps into f32 registers), stores it in its shared memory, and after
//   one cluster barrier reads the n partials through distributed shared
//   memory and adds them in rank order 0 .. n-1. Every CTA so holds the
//   same bits of S, and so of the softmax statistics, the probabilities
//   and the dropout keep bits: no float atomics, and a repeat is bit-equal.
//   The partial tiles are double-buffered (the tile jt writes buffer jt % 2)
//   so one barrier a key tile suffices: a CTA overwrites a buffer only
//   after the next tile's barrier, which every reader of it has passed.
//   A last barrier keeps every CTA resident until the others have read it.
// - The output products read the CTA's slice only: O_r += P V_r
//   (m64nWk16, P the bf16 fragment in registers, V_r's tile MN-major), in
//   the backward dQ_r += dS K_r, dV_r += P_drop^T dO_r, dK_r += dS^T Q_r.
// The backward runs as the other routes' two passes of fixed order, with
// no atomics: the dq pass exchanges the partial S and dP = dO V^T, the
// dk/dv pass the partial S^T and dP^T. The dk/dv pass holds two
// accumulators on two warpgroups: warpgroup 0 computes the partial S^T and
// owns dv, warpgroup 1 the partial dP^T and dk (it reads both sums).
//
// Tiles and copies as in attention_tc.cuh: 8x8 core matrices, no swizzle,
// column block major; the streamed side in 32-row tiles through a two-stage
// cp.async ring, a tile's own rows once. Pad columns (past the columns a
// copy reads, `cols`) are zeroed once.
//
// Shared bytes at W = 192 / 224 / 256 (the own tiles, the ring, the two
// buffers of partial tiles): forward 90,112 / 102,400 / 114,688 (Q, 2 x (K,
// V), 2 x S_r); dq 131,072 / 147,456 / 163,840 (Q, dO, 2 x (K, V), 2 x (S_r,
// dP_r)); dk/dv 131,584 / 147,968 / 164,352 (K, V, 2 x (Q, dO), 2 x (S_r^T,
// dP_r^T), two stages of 32 lse and delta floats). Registers a thread: the
// forward's and dq's 64 x W accumulator W / 2 (128 at W = 256) on one
// warpgroup, and 16 each of the score fragments; the dk/dv pass the same on
// each of its two warpgroups (what ptxas allots: chip_ab.py's task ptxas).
//
// Dropout hashes (query row, key column) under the (sample, head)'s base,
// as every route does: the slice does not enter the mask.
#pragma once

#include <cooperative_groups.h>

#include "attention_tc_wide.cuh"

namespace rd {
namespace tc {

// The output products of a W-column slice (attention_tc_cluster.cuh).
template <>
__device__ __forceinline__ void mma_rs<192>(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<224>(float (&d)[112], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace tc

namespace tcc {

namespace cg = cooperative_groups;
using tc::bf16;
using tc::ROWS;
using tc::WG;

constexpr int KEYS = 32;          // rows of a streamed tile
constexpr int MAX_SLICE = 256;    // columns a CTA owns at the most (wgmma's N)
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int MAX_HD = MAX_SLICE * MAX_CLUSTER;  // 2048; bf16 past it: "hd_stream"
constexpr int FWD_THREADS = WG, DQ_THREADS = WG, DKV_THREADS = 2 * WG;
constexpr int NX = ROWS * KEYS / WG;          // 16 floats of a score tile a thread
constexpr int PART_BYTES = ROWS * KEYS * 4;   // one partial score tile, f32

// The cluster's CTAs and each one's columns W for head dim hd (369 ..
// MAX_HD): W is 192, 224 or 256.
__host__ __device__ constexpr int cluster_size(int hd) {
  return (hd + MAX_SLICE - 1) / MAX_SLICE;
}
__host__ __device__ constexpr int slice_cols(int hd) {
  return ((hd + cluster_size(hd) - 1) / cluster_size(hd) + 31) / 32 * 32;
}

// Shared bytes of the three routines for W columns a CTA (keep in step
// with tc_cluster_smem in ops/flash_attention.py).
__host__ __device__ constexpr int fwd_smem_bytes(int W) {
  return tc::tile_bytes(W) + 4 * tc::tile_bytes(W, KEYS) + 2 * PART_BYTES;
}
__host__ __device__ constexpr int dq_smem_bytes(int W) {
  return 2 * tc::tile_bytes(W) + 4 * tc::tile_bytes(W, KEYS) + 4 * PART_BYTES;
}
__host__ __device__ constexpr int dkv_smem_bytes(int W) {
  return dq_smem_bytes(W) + 2 * 2 * KEYS * (int)sizeof(float);
}
static_assert(fwd_smem_bytes(256) == 114688 && dq_smem_bytes(256) == 163840 &&
                  dkv_smem_bytes(256) == 164352 && dkv_smem_bytes(192) == 131584,
              "the shared bytes the header states");
static_assert(dkv_smem_bytes(MAX_SLICE) <= MAX_SMEM, "a CTA fits a block");

// This warpgroup's m64n32 fragment x (NX floats a thread) into a partial
// buffer in fragment order: float4 j of thread tid at part[j WG + tid], so
// a warp's stores and every CTA's later reads are whole 512-byte rows.
__device__ __forceinline__ void put_part(float4* part, const float (&x)[NX], int tid) {
#pragma unroll
  for (int j = 0; j < NX / 4; ++j) {
    part[j * WG + tid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// x = the sum of the n CTAs' partial buffers at `part` (the same offset in
// each CTA's shared memory) at this thread's place, in rank order 0 ..
// n-1, after the cluster barrier that follows every CTA's put_part.
__device__ __forceinline__ void sum_parts(const cg::cluster_group& cluster, float4* part,
                                          int n, int tid, float (&x)[NX]) {
  float4 acc[NX / 4];
  const float4* p0 = cluster.map_shared_rank(part, 0);
#pragma unroll
  for (int j = 0; j < NX / 4; ++j) acc[j] = p0[j * WG + tid];
#pragma unroll
  for (int r = 1; r < MAX_CLUSTER; ++r) {
    if (r < n) {
      const float4* pr = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int j = 0; j < NX / 4; ++j) {
        const float4 y = pr[j * WG + tid];
        acc[j].x += y.x;
        acc[j].y += y.y;
        acc[j].z += y.z;
        acc[j].w += y.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NX / 4; ++j) {
    x[4 * j] = acc[j].x;
    x[4 * j + 1] = acc[j].y;
    x[4 * j + 2] = acc[j].z;
    x[4 * j + 3] = acc[j].w;
  }
}

// Zeros for rows < nrows, columns < ncols of out (row stride `stride`).
__device__ __forceinline__ void zero_rows(float* __restrict__ out, long stride, int nrows,
                                          int ncols, int tid, int nthr) {
  for (int idx = tid; idx < nrows * ncols; idx += nthr) {
    const int r = idx / ncols;
    out[(long)r * stride + (idx - r * ncols)] = 0.f;
  }
}

// ---------------------------------------------------------------- forward
// attend_rows_tc (attention_tc.cuh) over this CTA's columns: query rows q0
// .. q0+63 of one (sample, head) against keys 0 .. length-1, online
// softmax in base 2 on the cluster's summed scores. out points at row q0,
// column 0; rank 0 writes lse. CW is the copy width in bytes and `cols`
// the columns a copy reads from a row (hd, or hd padded to 8 where the
// operands hold zeroed pad columns).
template <int W, bool DROP>
__device__ void attend_rows_cluster(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, long row_stride, int T,
                                    int length, int q0, int hd, int CW, float scale2,
                                    uint8_t* smem, float* __restrict__ out, long out_stride,
                                    float* __restrict__ lse, Drop dr, int cols) {
  constexpr int TQ = tc::tile_bytes(W), TK = tc::tile_bytes(W, KEYS);
  const cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, c0 = rank * W;
  const int nrows = min(ROWS, T - q0), ncopy = min(W, cols - c0), nout = min(W, hd - c0);
  if (length <= 0) {  // the whole cluster: the sample is the same
    zero_rows(out + c0, out_stride, nrows, nout, tid, WG);
    if (rank == 0) {
      for (int r = tid; r < nrows; r += WG) lse[q0 + r] = NEG_INF;
    }
    return;
  }
  // Q, then stage s: K at smem + TQ + 2 s TK, V after it; then the two
  // buffers of partial scores
  float4* part = reinterpret_cast<float4*>(smem + TQ + 4 * TK);
  if (ncopy < W) {
    tc::zero_pad<W>(smem, 1, ncopy, tid, WG);
    tc::zero_pad<W, KEYS>(smem + TQ, 4, ncopy, tid, WG);
  }
  tc::load_tile(CW, smem, q + c0, row_stride, q0, T, ncopy, tid, WG);
  tc::load_tile<KEYS>(CW, smem + TQ, k + c0, row_stride, 0, length, ncopy, tid, WG);
  tc::load_tile<KEYS>(CW, smem + TQ + TK, v + c0, row_stride, 0, length, ncopy, tid, WG);
  tc::cp_commit();

  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  const uint32_t qa = tc::smem_addr(smem);
  const int ntiles = (length + KEYS - 1) / KEYS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * KEYS, nk = min(KEYS, length - k0);
    uint8_t* Kt = smem + TQ + 2 * (jt & 1) * TK;
    if (jt + 1 < ntiles) {
      uint8_t* Kn = smem + TQ + 2 * ((jt + 1) & 1) * TK;
      tc::load_tile<KEYS>(CW, Kn, k + c0, row_stride, k0 + KEYS, length, ncopy, tid, WG);
      tc::load_tile<KEYS>(CW, Kn + TK, v + c0, row_stride, k0 + KEYS, length, ncopy, tid, WG);
      tc::cp_commit();
      tc::tiles_ready<1>();
    } else {
      tc::tiles_ready<0>();
    }
    float s[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) s[i] = 0.f;
    tc::mma_fence();
    tc::mma_scores_n32<W>(s, qa, tc::smem_addr(Kt));
    tc::mma_commit();
    tc::mma_wait();
    tc::reg_fence(s);
    float4* buf = part + (jt & 1) * (NX / 4) * WG;
    put_part(buf, s, tid);
    cluster.sync();  // every CTA's partial scores of this tile are stored
    sum_parts(cluster, buf, n, tid, s);

    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      s[x] *= scale2;
      if (tc::acc_c(x, t) < nk) tmax[tc::acc_i(x)] = fmaxf(tmax[tc::acc_i(x)], s[x]);
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
    for (int x = 0; x < NX; ++x) {
      const int i = tc::acc_i(x), c = tc::acc_c(x, t);
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
    for (int x = 0; x < W / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    tc::mma_acc_rows<W>(o, s, tc::smem_addr(Kt + TK));
    __syncthreads();  // the stage is read before the next copy refills it
  }
  cluster.sync();  // no CTA leaves while another reads its partial scores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int x = 0; x < W / 2; ++x) o[x] *= inv_l[(x >> 1) & 1];
  tc::store_rows<W>(o, out + c0, out_stride, nrows, nout, 1.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    if (rank == 0 && r < nrows && t == 0) lse[q0 + r] = m[i] + log2f(l[i]);
  }
}

// ------------------------------------------------------------- backward
// attn_dq_rows_tc over this CTA's columns: dq of query rows q0 .. q0+63
// (dq points at the head's row 0, column 0) from the cluster's summed S
// and dP.
template <int W, bool DROP>
__device__ void attn_dq_rows_cluster(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, long row_stride,
                                     const bf16* __restrict__ d_o, long do_stride,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, int T, int length,
                                     int q0, int hd, int CW, float scale2, float scale,
                                     Drop dr, uint8_t* smem, float* __restrict__ dq,
                                     long dq_stride, int cols) {
  constexpr int TQ = tc::tile_bytes(W), TK = tc::tile_bytes(W, KEYS);
  const cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, c0 = rank * W;
  const int nrows = min(ROWS, T - q0), ncopy = min(W, cols - c0), nout = min(W, hd - c0);
  if (length <= 0) {
    zero_rows(dq + (long)q0 * dq_stride + c0, dq_stride, nrows, nout, tid, WG);
    return;
  }
  // Q, dO, then stage s: K at smem + 2 TQ + 2 s TK, V after it; then two
  // buffers each of the partial S and dP
  float4* part = reinterpret_cast<float4*>(smem + 2 * TQ + 4 * TK);
  if (ncopy < W) {
    tc::zero_pad<W>(smem, 2, ncopy, tid, WG);
    tc::zero_pad<W, KEYS>(smem + 2 * TQ, 4, ncopy, tid, WG);
  }
  tc::load_tile(CW, smem, q + c0, row_stride, q0, T, ncopy, tid, WG);
  tc::load_tile(CW, smem + TQ, d_o + c0, do_stride, q0, T, ncopy, tid, WG);
  tc::load_tile<KEYS>(CW, smem + 2 * TQ, k + c0, row_stride, 0, length, ncopy, tid, WG);
  tc::load_tile<KEYS>(CW, smem + 2 * TQ + TK, v + c0, row_stride, 0, length, ncopy, tid, WG);
  tc::cp_commit();

  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  bool rok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    rok[i] = r < nrows;
    lse_r[i] = rok[i] ? lse[q0 + r] : 0.f;
    delta_r[i] = rok[i] ? delta[q0 + r] : 0.f;
  }
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = tc::smem_addr(smem), oa = tc::smem_addr(smem + TQ);
  const int ntiles = (length + KEYS - 1) / KEYS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * KEYS, nk = min(KEYS, length - k0);
    uint8_t* Kt = smem + 2 * TQ + 2 * (jt & 1) * TK;
    if (jt + 1 < ntiles) {
      uint8_t* Kn = smem + 2 * TQ + 2 * ((jt + 1) & 1) * TK;
      tc::load_tile<KEYS>(CW, Kn, k + c0, row_stride, k0 + KEYS, length, ncopy, tid, WG);
      tc::load_tile<KEYS>(CW, Kn + TK, v + c0, row_stride, k0 + KEYS, length, ncopy, tid, WG);
      tc::cp_commit();
      tc::tiles_ready<1>();
    } else {
      tc::tiles_ready<0>();
    }
    float s[NX], dp[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) s[i] = dp[i] = 0.f;
    tc::mma_fence();
    tc::mma_scores_n32<W>(s, qa, tc::smem_addr(Kt));
    tc::mma_scores_n32<W>(dp, oa, tc::smem_addr(Kt + TK));
    tc::mma_commit();
    tc::mma_wait();
    tc::reg_fence(s);
    tc::reg_fence(dp);
    float4* buf = part + (jt & 1) * 2 * (NX / 4) * WG;  // S, then dP
    put_part(buf, s, tid);
    put_part(buf + (NX / 4) * WG, dp, tid);
    cluster.sync();
    sum_parts(cluster, buf, n, tid, s);
    sum_parts(cluster, buf + (NX / 4) * WG, n, tid, dp);
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      const int i = tc::acc_i(x), c = tc::acc_c(x, t);
      const float p = (rok[i] && c < nk) ? exp2f(s[x] * scale2 - lse_r[i]) : 0.f;
      float dpv = dp[x];
      if constexpr (DROP) {
        const uint32_t row = (uint32_t)(q0 + 16 * w + g + 8 * i);
        dpv = keep_bit(dr, row, (uint32_t)(k0 + c)) ? dpv * dr.inv : 0.f;
      }
      s[x] = p * (dpv - delta_r[i]);
    }
    tc::mma_acc_rows<W>(acc, s, tc::smem_addr(Kt));
    __syncthreads();
  }
  cluster.sync();
  tc::store_rows<W>(acc, dq + (long)q0 * dq_stride + c0, dq_stride, nrows, nout, scale);
}

// attn_dkv_rows_tc over this CTA's columns, both outputs: dv and dk of key
// rows k0 .. k0+63 (dk and dv point at the head's row 0, column 0) on two
// warpgroups. Warpgroup 0 computes the partial S^T = K_r Q_r^T and keeps
// dv += P_drop^T dO_r; warpgroup 1 the partial dP^T = V_r dO_r^T and keeps
// dk += dS^T Q_r, from the cluster's summed S^T and dP^T.
template <int W, bool DROP>
__device__ void attn_dkv_rows_cluster(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, long row_stride,
                                      const bf16* __restrict__ d_o, long do_stride,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, int T, int length,
                                      int k0, int hd, int CW, float scale2, float scale,
                                      Drop dr, uint8_t* smem, float* __restrict__ dk,
                                      float* __restrict__ dv, long out_stride, int cols) {
  constexpr int TQ = tc::tile_bytes(W), TK = tc::tile_bytes(W, KEYS), NTH = DKV_THREADS;
  const cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, c0 = rank * W;
  const int nkeys = min(ROWS, T - k0), ncopy = min(W, cols - c0), nout = min(W, hd - c0);
  if (k0 >= length) {  // also every block of a sample with length 0
    zero_rows(dk + (long)k0 * out_stride + c0, out_stride, nkeys, nout, tid, NTH);
    zero_rows(dv + (long)k0 * out_stride + c0, out_stride, nkeys, nout, tid, NTH);
    return;
  }
  // K, V, then stage s: Q at smem + 2 TQ + 2 s TK, dO after it; then the
  // stages' lse and delta values; then two buffers each of the partial
  // S^T and dP^T
  float* Ls = reinterpret_cast<float*>(smem + 2 * TQ + 4 * TK);  // [2][32]
  float* Dl = Ls + 2 * KEYS;                                       // [2][32]
  float4* part = reinterpret_cast<float4*>(Dl + 2 * KEYS);
  if (ncopy < W) {
    tc::zero_pad<W>(smem, 2, ncopy, tid, NTH);
    tc::zero_pad<W, KEYS>(smem + 2 * TQ, 4, ncopy, tid, NTH);
  }
  tc::load_tile(CW, smem, k + c0, row_stride, k0, length, ncopy, tid, NTH);
  tc::load_tile(CW, smem + TQ, v + c0, row_stride, k0, length, ncopy, tid, NTH);
  tc::load_tile<KEYS>(CW, smem + 2 * TQ, q + c0, row_stride, 0, T, ncopy, tid, NTH);
  tc::load_tile<KEYS>(CW, smem + 2 * TQ + TK, d_o + c0, do_stride, 0, T, ncopy, tid, NTH);
  tc::load_vec<KEYS>(Ls, lse, 0, T, tid, NTH);
  tc::load_vec<KEYS>(Dl, delta, 0, T, tid, NTH);
  tc::cp_commit();

  const int wg = tid / WG, wt = tid % WG;
  const int lane = tid & 31, w = wt >> 5, g = lane >> 2, t = lane & 3;
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = k0 + 16 * w + g + 8 * i < length;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
  const uint32_t own = tc::smem_addr(smem + wg * TQ);
  const int ntiles = (T + KEYS - 1) / KEYS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int t0 = jt * KEYS, nq = min(KEYS, T - t0), st = jt & 1;
    uint8_t* Qt = smem + 2 * TQ + 2 * st * TK;
    if (jt + 1 < ntiles) {
      const int sn = (jt + 1) & 1;
      uint8_t* Qn = smem + 2 * TQ + 2 * sn * TK;
      tc::load_tile<KEYS>(CW, Qn, q + c0, row_stride, t0 + KEYS, T, ncopy, tid, NTH);
      tc::load_tile<KEYS>(CW, Qn + TK, d_o + c0, do_stride, t0 + KEYS, T, ncopy, tid, NTH);
      tc::load_vec<KEYS>(Ls + sn * KEYS, lse, t0 + KEYS, T, tid, NTH);
      tc::load_vec<KEYS>(Dl + sn * KEYS, delta, t0 + KEYS, T, tid, NTH);
      tc::cp_commit();
      tc::tiles_ready<1>();
    } else {
      tc::tiles_ready<0>();
    }
    const float* ls = Ls + st * KEYS;
    const float* dl = Dl + st * KEYS;
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = 0.f;
    tc::mma_fence();
    tc::mma_scores_n32<W>(x, own, tc::smem_addr(Qt + wg * TK));
    tc::mma_commit();
    tc::mma_wait();
    tc::reg_fence(x);
    float4* buf = part + st * 2 * (NX / 4) * WG;  // S^T, then dP^T
    put_part(buf + wg * (NX / 4) * WG, x, wt);
    cluster.sync();
    float s[NX];
    sum_parts(cluster, buf, n, wt, s);
    if (wg == 1) sum_parts(cluster, buf + (NX / 4) * WG, n, wt, x);
#pragma unroll
    for (int e = 0; e < NX; ++e) {
      const int i = tc::acc_i(e), c = tc::acc_c(e, t);
      const float p = (key_ok[i] && c < nq) ? exp2f(s[e] * scale2 - ls[c]) : 0.f;
      bool keep = true;
      if constexpr (DROP) {
        keep = keep_bit(dr, (uint32_t)(t0 + c), (uint32_t)(k0 + 16 * w + g + 8 * i));
      }
      const float inv = DROP ? dr.inv : 1.f;
      if (wg == 0) {
        s[e] = keep ? p * inv : 0.f;
      } else {
        const float dpv = keep ? x[e] * inv : 0.f;
        s[e] = p * (dpv - dl[c]);
      }
    }
    // dv += P_drop^T dO (warpgroup 0), dk += dS^T Q (warpgroup 1)
    tc::mma_acc_rows<W>(acc, s, tc::smem_addr(Qt + (1 - wg) * TK));
    __syncthreads();
  }
  cluster.sync();
  tc::store_rows<W>(acc, (wg == 0 ? dv : dk) + (long)k0 * out_stride + c0, out_stride, nkeys,
                    nout, wg == 0 ? 1.f : scale);
}

}  // namespace tcc
}  // namespace rd
