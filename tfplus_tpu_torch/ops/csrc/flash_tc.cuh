// Hopper building blocks shared by the tensor-core flash kernels
// (flash_fwd_tc.cu, flash_bwd_tc.cu): cp.async loads of bf16 tiles into the
// 128-byte swizzled shared-memory layout that wgmma's descriptors read, the
// descriptors themselves, and wgmma.mma_async in inline PTX (sm_90a only).
//
// Tile layout. A tile of R rows by D (64 or 128) bf16 columns is stored as
// D/64 column chunks of R rows of 128 bytes each; in row r the 16-byte piece
// j (columns 8j..8j+7 of the chunk) sits at piece j ^ (r % 8). That is the
// layout TMA's SWIZZLE_128B writes and that a SW128 descriptor describes,
// with tiles 1024-byte aligned. One such tile serves as a K-major operand
// (rows are M or N, the columns K: q kᵀ with either side) and as an MN-major
// B operand (rows are K, the columns N: p v).
//
// Accumulator fragment of m64nNk16 (f32), thread t = threadIdx.x % 128 of
// the warpgroup, warp w = t / 32, lane = t % 32: d[4j + e] is row
// 16w + lane/4 + 8·(e/2), column 8j + 2·(lane%4) + e%2. The A fragment of
// m64k16 from registers (four bf16x2 words) has the same rows and columns
// 16kk.. of d[8kk .. 8kk+7], so an accumulator converts to the next
// product's A operand in place: word i = bf16x2(d[2i], d[2i+1]).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int kRowBytes = 128;                 // one swizzled row of a chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fills the rest
// (0: the whole piece is zero and nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async
// included) visible to the async proxy that wgmma reads through; a barrier
// after it publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, 64) of a [rows_valid, D] row-major bf16 matrix at src into the
// swizzled tile at shared address dst; rows >= rows_valid are zero-filled.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int rows_valid) {
  constexpr int kPieces = D / 8;               // 16-byte pieces per row
  static_assert(64 * kPieces % kThreads == 0, "whole pieces per thread");
#pragma unroll
  for (int it = 0; it < 64 * kPieces / kThreads; ++it) {
    const int i = it * kThreads + static_cast<int>(threadIdx.x) % kThreads;
    const int r = i / kPieces, p = i % kPieces;
    const int c = p / 8, j = p % 8;
    const bool ok = r < rows_valid;
    const uint32_t at = dst + c * 64 * kRowBytes + r * kRowBytes + ((j ^ (r & 7)) << 4);
    cp_async16(at, ok ? src + static_cast<size_t>(r) * D + p * 8 : src, ok ? 16 : 0);
  }
}

// n 4-byte words src[0, n) into dst, zero past valid.
template <int kThreads>
__device__ __forceinline__ void load_words(uint32_t dst, const void* src, int n, int valid) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  for (int i = threadIdx.x % kThreads; i < n; i += kThreads) {
    const bool ok = i < valid;
    cp_async4(dst + 4 * i, ok ? s + i : s, ok ? 4 : 0);
  }
}

// SW128 matrix descriptor: start address, leading byte offset (the stride
// between 64-column chunks along MN of an MN-major operand; unused K-major),
// stride byte offset 1024 (eight 128-byte rows), layout type 1 (128B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand of a 64-row tile: the 16 columns 16kk.. (k-step kk).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * 64 * kRowBytes + (kk % 4) * 32, 16);
}

// MN-major B operand of a 64-row tile (rows are K): rows 16kk.. (k-step kk),
// all columns (N = D, chunks 64 rows apart).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * kRowBytes, 64 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of these registers across
// the asynchronous products (called after a wait and before a fence).
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t mix_bits(uint32_t x) {  // murmur3 finalizer
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t drop_base(uint32_t seed, int bi, int hi) {
  return seed * 0x9E3779B9u + static_cast<uint32_t>(bi) * 0x7FEB352Du +
         static_cast<uint32_t>(hi) * 0x846CA68Bu;
}

// The dropout keep bit of global (row, col), as _dropout_keep_dense.
__device__ __forceinline__ bool keep(uint32_t base, int row, int col, uint32_t thresh) {
  return mix_bits(base + static_cast<uint32_t>(row) * 0x27D4EB2Fu +
                  static_cast<uint32_t>(col)) >= thresh;
}

// d[32] (+)= A·B for m64n64k16, A and B from shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d[32] (+)= A·B for m64n64k16: A from registers (four bf16x2 words per
// thread, the accumulator's fragment layout), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// d[64] (+)= A·B for m64n128k16: A from registers (four bf16x2 words per
// thread, the accumulator's fragment layout), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

}  // namespace tc
