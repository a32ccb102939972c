// Monotone compactor kernel for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by tfplus_tpu_torch/ops/compactor.py.
//
// Replaces the Pallas kernel of tfplus_tpu/ops/compactor.py (`_kernel`,
// launched by `compact`): pack the live rows of an append arena A[M, W] (f32)
// into a dense prefix of `packed`, in arena order, and write new_loc[j], live
// row j's packed position (0 for a dead row). Live rows at or past `out_rows`
// are dropped.
//
// The TPU kernel walks the arena in R-row grid steps IN ORDER, places each
// block's live rows with an exact one-hot f32 matmul and carries the rows
// that overflow its output block to the next step in a VMEM carry block. On
// Hopper the blocks run in parallel, and each can write its own disjoint
// output range, since the caller hands in out_start[b], the exclusive prefix
// of the per-block live counts (computed with two tensor ops, as the JAX
// entry point computes it outside its pallas_call). So:
//   * one CUDA block per R-row input block; it reads its R live flags in
//     chunks of blockDim.x and forms each row's exclusive in-block rank with
//     __ballot_sync / __popc inside a warp and a pass over the warps' counts
//     in shared memory;
//   * it writes new_loc for its rows and copies each live row to
//     packed[out_start[b] + rank], a warp per row in 16-byte words (4-byte
//     words when a pointer or the row width is not 16-byte aligned);
//   * no atomics, so a rerun is bit-identical; dead rows are never read, and
//     packed[n_live:] is never written.
//
// Bound on an H100 SXM: bytes. The least traffic reads each live row once and
// writes it once, reads the live mask and writes new_loc: at the study shape
// (M = 1,572,864 x W = 256 f32, 2/3 live) about 2.16 GB, 0.64 ms at
// 3.35 TB/s. There is no arithmetic worth counting. The design reads no dead
// row and no byte twice; cp.async/TMA staging and more rows in flight per
// warp are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
compact_kernel(const V* __restrict__ arena, const uint8_t* __restrict__ live,
               const int32_t* __restrict__ out_start, V* __restrict__ packed,
               int32_t* __restrict__ new_loc, int64_t block_rows,
               int64_t words, int64_t out_rows) {
  __shared__ int warp_count[kMaxWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  int64_t base = out_start[blockIdx.x];  // packed position of the chunk's first live row

  for (int64_t c = 0; c < block_rows; c += blockDim.x) {
    const int64_t r = c + tid;
    const bool in_block = r < block_rows;
    const bool lv = in_block && live[row0 + r] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, lv);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int k = warp_count[w];
      before += w < warp ? k : 0;
      total += k;
    }
    const int64_t warp_base = base + before;
    if (in_block) {
      new_loc[row0 + r] =
          lv ? static_cast<int32_t>(warp_base + __popc(ballot & lanes_below)) : 0;
    }
    // this warp's live rows, one after another, all lanes on one row
    unsigned todo = ballot;
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int64_t dst = warp_base + __popc(ballot & ((1u << i) - 1u));
      if (dst >= out_rows) break;  // ranks only grow along the chunk
      const V* src = arena + (row0 + c + (warp << 5) + i) * words;
      V* out = packed + dst * words;
      for (int64_t j = lane; j < words; j += 32) out[j] = src[j];
    }
    base += total;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }
}

template <typename V>
void launch(const void* arena, const uint8_t* live, const int32_t* out_start,
            void* packed, int32_t* new_loc, int64_t m, int64_t row_bytes,
            int64_t block_rows, int64_t out_rows, cudaStream_t stream) {
  int64_t threads = (block_rows + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  compact_kernel<V><<<static_cast<unsigned>(m / block_rows),
                      static_cast<unsigned>(threads), 0, stream>>>(
      static_cast<const V*>(arena), live, out_start, static_cast<V*>(packed),
      new_loc, block_rows, row_bytes / static_cast<int64_t>(sizeof(V)),
      out_rows);
}

}  // namespace

extern "C" {

// arena f32 [m, w], live uint8 [m] (torch.bool), out_start int32 [m / block_rows + 1]
// (exclusive prefix of the per-block live counts), packed f32 [out_rows, w],
// new_loc int32 [m]. m % block_rows == 0. Returns the launch's cudaError_t
// (0 = success).
int tfp_compact(const void* arena, const void* live, const void* out_start,
                void* packed, void* new_loc, long long m, long long w,
                long long block_rows, long long out_rows, void* stream) {
  if (m <= 0) return 0;
  if (block_rows <= 0 || m % block_rows != 0 || m / block_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = w * 4;
  const uintptr_t p = reinterpret_cast<uintptr_t>(arena) | reinterpret_cast<uintptr_t>(packed);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  const int32_t* os = static_cast<const int32_t*>(out_start);
  int32_t* nl = static_cast<int32_t*>(new_loc);
  if (row_bytes % 16 == 0 && p % 16 == 0) {
    launch<uint4>(arena, lv, os, packed, nl, m, row_bytes, block_rows, out_rows, s);
  } else {
    launch<uint32_t>(arena, lv, os, packed, nl, m, row_bytes, block_rows, out_rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
