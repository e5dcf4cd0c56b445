// Tensor-core device code of the packed-heads attention for bf16 operands:
// the forward over one 64-row query block, the dq pass over one 64-row query
// block and the dk/dv pass over one 64-row key block, of one (sample, head).
// It takes base pointers and a row stride, as attend_rows does, so the
// fused layer's attention and flash_mha's kernels run it too. With the
// kernels of flash_packed_{fwd,dq,dkv}_tc.cu it replaces, on the bf16 route,
// raindrop_tpu/ops/flash_attention.py:_packed_fwd_kernel (:566) and
// :_packed_bwd_kernel (:610), and, launched by flash_split.cu through the
// same kernels, the five flash_mha kernels (:121, :146, :191, :237, :275)
// at any T. The design
// that shipped is the wgmma one (the mma.sync fallback was not needed).
//
// Bound on this card: bytes. At B=128, with lengths uniform on 0..T (k and
// v are read below each length only), the forward moves about 35 MB at P12
// (11 us at 3.35 TB/s) and 22 MB at eICU (7 us), the backward 80 and 50 MB
// (24 and 15 us); its FLOPs take 2-5 us of tensor-core time. What the scalar
// kernels lost to FMA out of shared memory the tensor cores take back; what
// is left is latency: a 64-row tile is a few microseconds of copies,
// softmax and barriers for one warpgroup, so the design streams tiles
// through a copy ring and keeps three CTAs on an SM.
//
// Products: wgmma.mma_async m64nNk16, bf16 in, f32 accumulate. A warpgroup
// (128 threads) owns the 64 rows of its block. Scores S = Q K^T and dP =
// dO V^T (and their transposes in the dk/dv pass) read both operands from
// shared memory (m64n64k16, K-major); the output products O += P V, dQ +=
// dS K, dV += P_drop^T dO and dK += dS^T Q take the bf16 probabilities or
// ds from registers as the A operand and read the B tile from shared memory
// MN-major, so no tile is ever transposed. The softmax and the ds algebra
// run on the f32 accumulator fragments: thread (warp w, lane = 4 g + t)
// holds element x[4 j + 2 i + e] at row 16 w + g + 8 i, column 8 j + 2 t + e.
//
// Tiles: [64 rows, HDK columns] bf16, HDK = hd padded to 16 (the K depth of
// the score products), stored as 8x8 core matrices of 128 contiguous bytes
// (8 rows of 16 bytes), no swizzle, column block major: element (r, c) at
// byte (c / 8) * 1024 + (r / 8) * 128 + (r % 8) * 16 + (c % 8) * 2. A row of
// 80 bf16 is not a multiple of a 128-byte swizzle atom, and this layout
// takes any multiple of 8 columns. The output products use N = HDK too, so
// one padded width serves every product. Pad columns are zeroed once; rows
// past a tile's limit are filled with zeros by the copy itself (a NaN bit
// pattern in shared memory times a probability of 0 would be NaN).
//
// Copies: the streamed tiles go through a ring of two stages filled by
// cp.async, the next tile in flight while the current one is multiplied.
// The copy width W (16, 8 or 4 bytes; 2 means plain loads) divides the
// alignment of the base pointers, the row stride and the head offset: at
// eICU (hd 36, d 72) head 1 starts 72 bytes into a row, so W = 8 there; at
// hd 42 it is 4. The wrapper's launch plan picks it and the C entry checks it.
// Each routine's last argument, `cols` (0: hd), is the number of columns a
// copy reads from each row: flash_mha casts its operands into heads padded
// with zeros to a multiple of 8 columns, so that hd 42 and 170 copy 48 and
// 176 columns by 16 bytes; the stores still write hd columns.
#pragma once

#include "attention.cuh"

namespace rd {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;   // rows of every tile, the wgmma M of a warpgroup
constexpr int WG = 128;    // threads of a warpgroup

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int tile_bytes(int hdk, int rows = ROWS) { return rows * hdk * 2; }

// Shared bytes of the three routines for head dim hd (keep in step with
// packed_plan in ops/flash_attention.py).
inline int fwd_smem_bytes(int hd) { return 5 * tile_bytes(pad16(hd)); }
inline int dq_smem_bytes(int hd) { return 6 * tile_bytes(pad16(hd)); }
inline int dkv_smem_bytes(int hd) {
  return 6 * tile_bytes(pad16(hd)) + 2 * 2 * ROWS * (int)sizeof(float);
}

// Byte of element (r, c) in a tile of R rows (64; 32 for the streamed
// tiles of attention_tc_wide.cuh): a column block of 8 is R * 16 bytes.
template <int R = ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * (R * 16) + (r >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices along K), stride byte offset (between
// core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// K-major operand (tile rows = M or N, tile columns = K), k-step kk, of a
// tile of R rows.
template <int R = ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2 * R * 16, R * 16, 128);
}

// MN-major B operand (tile rows = K, tile columns = N), k-step kk, of a
// tile of R rows. Columns c0 .. of it (c0 a multiple of 8) start
// c0 / 8 * R * 16 bytes in: a column slice is a descriptor offset.
template <int R = ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2 * 128, 128, R * 16);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching an accumulator across an asynchronous
// product: after mma_wait, the registers hold the result.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Makes this thread's shared-memory writes (stores and cp.async) visible
// to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x N] += A[64 x 16] B[16 x N]: A bf16 in registers (the fragment of
// frag_a), B MN-major in shared memory. N = 16, 32, ..., 144 (one
// warpgroup's whole padded head), and 88, 104, ..., 184 (the half of a
// padded head of 176, 208, ..., 368 that each of two warpgroups owns in
// attention_tc_wide.cuh).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<112>(float (&d)[56], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<144>(float (&d)[72], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
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
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<88>(float (&d)[44], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
      "{%44, %45, %46, %47}, %48, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<104>(float (&d)[52], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<120>(float (&d)[60], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
      "{%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<136>(float (&d)[68], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1, 1;\n}\n"
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
        "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<152>(float (&d)[76], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1, 1;\n}\n"
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
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<168>(float (&d)[84], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %89, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83}, "
      "{%84, %85, %86, %87}, %88, p, 1, 1, 1;\n}\n"
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
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<184>(float (&d)[92], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %97, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91}, "
      "{%92, %93, %94, %95}, %96, p, 1, 1, 1;\n}\n"
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
        "+f"(d[90]), "+f"(d[91])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
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
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W),
                 "r"(n)
                 : "memory");
  }
}

// Rows row0 .. row0+R-1 of a [*, hd] head view (row stride `stride`
// elements) into a tile of R rows; rows at or past `limit` become zero.
// W = 2 (odd hd) has no cp.async: plain loads and stores.
// Copy idx goes to row 8 (idx / (8 per_row)) + idx % 8 and copy
// (idx / 8) % per_row of that row: eight neighbouring lanes fill the eight
// rows of one core matrix (no shared-memory bank conflict at W = 16), and
// a warp reads a few whole 32-byte sectors of each row. The coordinates
// advance by the block size without a division per copy: with four warps
// on an SM's four schedulers nothing hides an integer division's latency.
template <int W, int R = ROWS>
__device__ __forceinline__ void load_tile_w(uint8_t* tile, const bf16* __restrict__ src,
                                            long stride, int row0, int limit, int hd, int tid,
                                            int nthr) {
  constexpr int E = W / 2;
  const int per_row = hd / E, per_blk = 8 * per_row;
  const int step_blk = nthr / per_blk, step_rest = nthr - step_blk * per_blk;
  const uint32_t base = smem_addr(tile);
  int blk = tid / per_blk, rest = tid - blk * per_blk;
  for (int idx = tid; idx < R * per_row; idx += nthr) {
    const int r = 8 * blk + (rest & 7), c = (rest >> 3) * E;
    const bool ok = row0 + r < limit;
    const bf16* g = src + (ok ? (long)(row0 + r) * stride + c : 0);
    if constexpr (W >= 4) {
      cp_async<W>(base + tile_off<R>(r, c), g, ok);
    } else {
      *reinterpret_cast<bf16*>(tile + tile_off<R>(r, c)) = ok ? *g : __float2bfloat16(0.f);
    }
    blk += step_blk;
    rest += step_rest;
    if (rest >= per_blk) {
      rest -= per_blk;
      ++blk;
    }
  }
}

template <int R = ROWS>
__device__ __forceinline__ void load_tile(int W, uint8_t* tile, const bf16* __restrict__ src,
                                          long stride, int row0, int limit, int hd, int tid,
                                          int nthr) {
  switch (W) {
    case 16: load_tile_w<16, R>(tile, src, stride, row0, limit, hd, tid, nthr); break;
    case 8: load_tile_w<8, R>(tile, src, stride, row0, limit, hd, tid, nthr); break;
    case 4: load_tile_w<4, R>(tile, src, stride, row0, limit, hd, tid, nthr); break;
    default: load_tile_w<2, R>(tile, src, stride, row0, limit, hd, tid, nthr); break;
  }
}

// N floats x[row0 ..] (zeros at or past limit) by 4-byte cp.async.
template <int N = ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int row0,
                                         int limit, int tid, int nthr) {
  for (int r = tid; r < N; r += nthr) {
    const bool ok = row0 + r < limit;
    cp_async<4>(smem_addr(dst + r), src + (ok ? row0 + r : 0), ok);
  }
}

// Zero the pad columns hd .. HDK-1 of n consecutive tiles of R rows, a row
// a thread.
template <int HDK, int R = ROWS>
__device__ __forceinline__ void zero_pad(uint8_t* tiles, int n, int hd, int tid, int nthr) {
  for (int row = tid; row < n * R; row += nthr) {
    uint8_t* tile = tiles + (row / R) * tile_bytes(HDK, R);
    const int r = row % R;
    for (int c = hd; c < HDK; ++c) {
      *reinterpret_cast<bf16*>(tile + tile_off<R>(r, c)) = __float2bfloat16(0.f);
    }
  }
}

// The tiles a streamed step reads have landed and are visible to wgmma.
template <int PENDING>
__device__ __forceinline__ void tiles_ready() {
  cp_wait<PENDING>();
  proxy_fence();
  __syncthreads();
}

// -------------------------------------------------------------- fragments
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk (columns 16 kk .. 16 kk + 15) of an m64n64
// (NX = 32) or m64n32 (NX = 16) accumulator, rounded to bf16: the register
// layout of wgmma's A fragment is that of the accumulator, two 8-column
// blocks at a time.
template <int NX>
__device__ __forceinline__ void frag_a(const float (&x)[NX], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// acc[64 x N] += X[64 x K] B[K x N]: X from an m64nK accumulator (NX =
// K / 2 floats a thread, bf16 rounded; K = 64 or 32), B the K rows of an
// MN-major tile of K rows (btile may point at a column slice of it).
template <int N, int NX>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[N / 2], const float (&x)[NX],
                                             uint32_t btile) {
  constexpr int KS = NX / 8, R = 2 * NX;
  uint32_t a[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_a(x, kk, a[kk]);
  reg_fence(acc);
  mma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs<N>(acc, a[kk], desc_mn<R>(btile, kk));
  mma_commit();
  mma_wait();
  reg_fence(acc);
}

// d[64 x 64] = A B^T over K = HDK, both tiles K-major.
template <int HDK>
__device__ __forceinline__ void mma_scores(float (&d)[32], uint32_t atile, uint32_t btile) {
#pragma unroll
  for (int kk = 0; kk < HDK / 16; ++kk) mma_ss_n64(d, desc_k(atile, kk), desc_k(btile, kk), kk);
}

// Store rows < nrows, columns < hd of a [64 x N] accumulator times mul. A
// thread holds column pairs (2 t, 2 t + 1): one 8-byte store each when hd,
// the row stride and the address are even in floats.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], float* __restrict__ out,
                                           long stride, int nrows, int hd, float mul) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = ((hd | stride) & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    if (r >= nrows) continue;
    float* row = out + (long)r * stride;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float x0 = acc[4 * j + 2 * i] * mul, x1 = acc[4 * j + 2 * i + 1] * mul;
      if (pairs) {
        if (c < hd) *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
      } else {
        if (c < hd) row[c] = x0;
        if (c + 1 < hd) row[c + 1] = x1;
      }
    }
  }
}

// ---------------------------------------------------------------- forward
// attend_rows (attention.cuh) for bf16 operands on the tensor cores, with
// one warpgroup (128 threads): query rows q0 .. q0+63 of one (sample, head)
// against keys 0 .. length-1, online softmax in base 2. out points at row
// q0; lse at the (sample, head)'s [T]. The row sum l takes the unrounded
// f32 p; the PV operand is p (dropped and rescaled with DROP) in bf16.
template <int HDK, bool DROP>
__device__ void attend_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, long row_stride, int T, int length,
                               int q0, int hd, int W, float scale2, uint8_t* smem,
                               float* __restrict__ out, long out_stride,
                               float* __restrict__ lse, Drop dr, int cols = 0) {
  constexpr int TB = tile_bytes(HDK);
  const int tid = threadIdx.x, ld = cols > 0 ? cols : hd;
  const int nrows = min(ROWS, T - q0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * hd; idx += WG) {
      const int r = idx / hd;
      out[(long)r * out_stride + (idx - r * hd)] = 0.f;
    }
    for (int r = tid; r < nrows; r += WG) lse[q0 + r] = NEG_INF;
    return;
  }
  uint8_t* Qs = smem;  // then stage s: K at smem + (1 + 2 s) TB, V after it
  if (HDK > ld) zero_pad<HDK>(smem, 5, ld, tid, WG);
  load_tile(W, Qs, q, row_stride, q0, T, ld, tid, WG);
  load_tile(W, smem + TB, k, row_stride, 0, length, ld, tid, WG);
  load_tile(W, smem + 2 * TB, v, row_stride, 0, length, ld, tid, WG);
  cp_commit();

  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HDK / 2];
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) o[i] = 0.f;
  const uint32_t qa = smem_addr(Qs);
  const int ntiles = (length + ROWS - 1) / ROWS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * ROWS, nk = min(ROWS, length - k0);
    uint8_t* Kt = smem + (1 + 2 * (jt & 1)) * TB;
    if (jt + 1 < ntiles) {
      uint8_t* Kn = smem + (1 + 2 * ((jt + 1) & 1)) * TB;
      load_tile(W, Kn, k, row_stride, k0 + ROWS, length, ld, tid, WG);
      load_tile(W, Kn + TB, v, row_stride, k0 + ROWS, length, ld, tid, WG);
      cp_commit();
      tiles_ready<1>();
    } else {
      tiles_ready<0>();
    }
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mma_fence();
    mma_scores<HDK>(s, qa, smem_addr(Kt));
    mma_commit();
    mma_wait();
    reg_fence(s);

    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
      s[x] *= scale2;
      if (c < nk) tmax[i] = fmaxf(tmax[i], s[x]);
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
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
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
    for (int x = 0; x < HDK / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    mma_acc_rows<HDK>(o, s, smem_addr(Kt + TB));
    __syncthreads();  // the stage is read before the next copy refills it
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // one division a row: with four warps nothing hides an IEEE division an
  // element
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int x = 0; x < HDK / 2; ++x) o[x] *= inv_l[(x >> 1) & 1];
  store_rows<HDK>(o, out, out_stride, nrows, hd, 1.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    if (r < nrows && t == 0) lse[q0 + r] = m[i] + log2f(l[i]);
  }
}

// ------------------------------------------------------------- backward
// attn_dq_rows (attention_bwd.cuh) on the tensor cores, one warpgroup: dq
// of query rows q0 .. q0+63 (dq points at the head's row 0).
template <int HDK, bool DROP>
__device__ void attn_dq_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, long row_stride,
                                const bf16* __restrict__ d_o, long do_stride,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, int T, int length, int q0,
                                int hd, int W, float scale2, float scale, Drop dr,
                                uint8_t* smem, float* __restrict__ dq, long dq_stride,
                                int cols = 0) {
  constexpr int TB = tile_bytes(HDK);
  const int tid = threadIdx.x, ld = cols > 0 ? cols : hd;
  const int nrows = min(ROWS, T - q0);
  if (length <= 0) {
    for (int idx = tid; idx < nrows * hd; idx += WG) {
      const int r = idx / hd;
      dq[(long)(q0 + r) * dq_stride + (idx - r * hd)] = 0.f;
    }
    return;
  }
  // Q, dO, then stage s: K at smem + (2 + 2 s) TB, V after it
  if (HDK > ld) zero_pad<HDK>(smem, 6, ld, tid, WG);
  load_tile(W, smem, q, row_stride, q0, T, ld, tid, WG);
  load_tile(W, smem + TB, d_o, do_stride, q0, T, ld, tid, WG);
  load_tile(W, smem + 2 * TB, k, row_stride, 0, length, ld, tid, WG);
  load_tile(W, smem + 3 * TB, v, row_stride, 0, length, ld, tid, WG);
  cp_commit();

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
  float acc[HDK / 2];
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = smem_addr(smem), oa = smem_addr(smem + TB);
  const int ntiles = (length + ROWS - 1) / ROWS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * ROWS, nk = min(ROWS, length - k0);
    uint8_t* Kt = smem + (2 + 2 * (jt & 1)) * TB;
    if (jt + 1 < ntiles) {
      uint8_t* Kn = smem + (2 + 2 * ((jt + 1) & 1)) * TB;
      load_tile(W, Kn, k, row_stride, k0 + ROWS, length, ld, tid, WG);
      load_tile(W, Kn + TB, v, row_stride, k0 + ROWS, length, ld, tid, WG);
      cp_commit();
      tiles_ready<1>();
    } else {
      tiles_ready<0>();
    }
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
    mma_scores<HDK>(s, qa, smem_addr(Kt));
    mma_scores<HDK>(dp, oa, smem_addr(Kt + TB));
    mma_commit();
    mma_wait();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
      const float p = (rok[i] && c < nk) ? exp2f(s[x] * scale2 - lse_r[i]) : 0.f;
      float dpv = dp[x];
      if constexpr (DROP) {
        const uint32_t row = (uint32_t)(q0 + 16 * w + g + 8 * i);
        dpv = keep_bit(dr, row, (uint32_t)(k0 + c)) ? dpv * dr.inv : 0.f;
      }
      s[x] = p * (dpv - delta_r[i]);
    }
    mma_acc_rows<HDK>(acc, s, smem_addr(Kt));
    __syncthreads();
  }
  store_rows<HDK>(acc, dq + (long)q0 * dq_stride, dq_stride, nrows, hd, scale);
}

// attn_dkv_rows (attention_bwd.cuh) on the tensor cores, one warpgroup:
// one output of key rows k0 .. k0+63, dv (role 0: dV += P_drop^T dO) or dk
// (role 1: dK += dS^T Q), so a thread holds one output accumulator (at
// hd = 128, S^T, dP^T and dK take 128 f32 registers where both outputs
// would take 192) and the two roles run as two CTAs of 128 threads in one
// launch, which fit three to an SM where one CTA of both would fit once.
// Both compute S^T = K Q^T, dP^T = V dO^T and p; role 0 computes dP^T
// without using it, so that no wgmma sits on a branch (ptxas then
// serialises every wgmma of the kernel). out is dv or dk at the head's
// row 0.
template <int HDK, bool DROP>
__device__ void attn_dkv_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, long row_stride,
                                 const bf16* __restrict__ d_o, long do_stride,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta, int T, int length, int k0,
                                 int hd, int W, float scale2, float scale, Drop dr,
                                 uint8_t* smem, int role, float* __restrict__ out,
                                 long out_stride, int cols = 0) {
  constexpr int TB = tile_bytes(HDK);
  const int tid = threadIdx.x, ld = cols > 0 ? cols : hd;
  const int nkeys = min(ROWS, T - k0);
  if (k0 >= length) {  // also every block of a sample with length 0
    for (int idx = tid; idx < nkeys * hd; idx += WG) {
      const int r = idx / hd;
      out[(long)(k0 + r) * out_stride + (idx - r * hd)] = 0.f;
    }
    return;
  }
  // K, V, then stage s: Q at smem + (2 + 2 s) TB, dO after it; then the
  // stages' lse and delta rows
  float* Ls = reinterpret_cast<float*>(smem + 6 * TB);  // [2][64]
  float* Dl = Ls + 2 * ROWS;                            // [2][64]
  if (HDK > ld) zero_pad<HDK>(smem, 6, ld, tid, WG);
  load_tile(W, smem, k, row_stride, k0, length, ld, tid, WG);
  load_tile(W, smem + TB, v, row_stride, k0, length, ld, tid, WG);
  load_tile(W, smem + 2 * TB, q, row_stride, 0, T, ld, tid, WG);
  load_tile(W, smem + 3 * TB, d_o, do_stride, 0, T, ld, tid, WG);
  load_vec(Ls, lse, 0, T, tid, WG);
  load_vec(Dl, delta, 0, T, tid, WG);
  cp_commit();

  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = k0 + 16 * w + g + 8 * i < length;
  float acc[HDK / 2];
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) acc[i] = 0.f;
  const uint32_t ka = smem_addr(smem), va = smem_addr(smem + TB);
  const int ntiles = (T + ROWS - 1) / ROWS;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int t0 = jt * ROWS, nq = min(ROWS, T - t0), st = jt & 1;
    uint8_t* Qt = smem + (2 + 2 * st) * TB;
    if (jt + 1 < ntiles) {
      const int sn = (jt + 1) & 1;
      uint8_t* Qn = smem + (2 + 2 * sn) * TB;
      load_tile(W, Qn, q, row_stride, t0 + ROWS, T, ld, tid, WG);
      load_tile(W, Qn + TB, d_o, do_stride, t0 + ROWS, T, ld, tid, WG);
      load_vec(Ls + sn * ROWS, lse, t0 + ROWS, T, tid, WG);
      load_vec(Dl + sn * ROWS, delta, t0 + ROWS, T, tid, WG);
      cp_commit();
      tiles_ready<1>();
    } else {
      tiles_ready<0>();
    }
    const float* ls = Ls + st * ROWS;
    const float* dl = Dl + st * ROWS;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
    mma_scores<HDK>(s, ka, smem_addr(Qt));
    mma_scores<HDK>(dp, va, smem_addr(Qt + TB));
    mma_commit();
    mma_wait();
    reg_fence(s);
    reg_fence(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
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
    mma_acc_rows<HDK>(acc, s, smem_addr(role == 0 ? Qt + TB : Qt));
    __syncthreads();
  }
  store_rows<HDK>(acc, out + (long)k0 * out_stride, out_stride, nkeys, hd,
                  role == 0 ? 1.f : scale);
}

}  // namespace tc
}  // namespace rd
