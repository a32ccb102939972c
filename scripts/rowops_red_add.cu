// A scatter-add of f32 rows that adds with fire-and-forget atomics
// (red.global.add.f32) instead of reading the destination, for timing only:
// scripts/rowops_probe.py builds it and times it beside the port's
// scatter-add (tfplus_tpu_torch/ops/csrc/rowops.cu) and index_add_. No
// wrapper of the package launches it.
//
//   values[idx[i], :] += rows[i, :] for idx[i] in [0, c); others dropped.
//
// The mapping is the port's for rows of 4-byte words with one row in flight
// per lane: a group of L = min(32, next_pow2(words)) lanes per row, 32 / L
// rows per warp, a warp for every tile of rows; a row wider than 32 words
// takes several passes. Each lane loads its source word, then the index, and
// adds the word at the destination without waiting for it. For unique
// indices the sum is the same as a load, an add and a store, except that the
// atomic f32 add flushes subnormal inputs and results to zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
red_add_kernel(float* __restrict__ values, const float* __restrict__ rows,
               const int32_t* __restrict__ idx, int64_t n, int64_t c,
               int64_t words, int lshift) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> lshift;
  const int li = lane & ((1 << lshift) - 1);
  const int groups = 32 >> lshift;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t row = warp * groups + g;
  if (row >= n) return;
  const float* src = rows + row * words;
  const float a = li < words ? __ldg(src + li) : 0.0f;
  const int32_t d = __ldg(idx + row);
  if (d < 0 || d >= c) return;
  float* dst = values + static_cast<int64_t>(d) * words;
  if (li < words) atomicAdd(dst + li, a);
  for (int64_t j = li + (1 << lshift); j < words; j += 1 << lshift)
    atomicAdd(dst + j, __ldg(src + j));
}

}  // namespace

extern "C" {

// values f32 [c, words], idx int32 [n], rows f32 [n, words]; on the current
// stream. Returns the cudaError_t of the launch (0 = success).
int tfp_scatter_add_red(float* values, const int32_t* idx, const float* rows,
                        long long n, long long c, long long words,
                        void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int lshift = 0;
  while ((1 << lshift) < words && lshift < 5) ++lshift;
  const int64_t rows_per_block = (kThreads / 32) * (32 >> lshift);
  const int64_t grid = (n + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  red_add_kernel<<<static_cast<int>(grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(values, rows, idx, n,
                                                        c, words, lshift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
