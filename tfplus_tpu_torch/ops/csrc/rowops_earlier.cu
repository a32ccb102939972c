// The earlier row gather / scatter kernels (one warp per row), kept for
// timing only: no wrapper launches them. chip_smoke.py times them on the
// row-kernel cases' inputs beside the kernels of rowops.cu (``earlier_ms``),
// through ``rowops._gather_rows_earlier`` and
// ``rowops._scatter_rows_earlier``.
//
// Same contract as rowops.cu: gather clamps to [0, C - 1]; scatter drops
// idx < 0 and idx >= C; unique indices, no atomics; the add in f32, rounded
// to nearest even.
//
// Design: one warp per row in a grid-stride loop over rows; lanes move
// consecutive 16-byte words of the row when every row start and the base
// pointers are 16-byte aligned, else 4-byte words, else (bf16 rows of odd
// width) 2-byte words. The grid is min(ceil(n / 8), 132 * 16) blocks of 256
// threads. Each warp loads one index, then that row, then stores it: one
// dependent chain at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch rounds
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);      // round to nearest even
}

// Elementwise a + b over the T values packed in one word V.
template <typename V, typename T>
__device__ __forceinline__ V add_word(V a, V b) {
  constexpr int K = sizeof(V) / sizeof(T);
  T* pa = reinterpret_cast<T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int k = 0; k < K; ++k) pa[k] = from_float<T>(to_float(pa[k]) + to_float(pb[k]));
  return a;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ values, const int32_t* __restrict__ idx,
                   V* __restrict__ out, int64_t n, int64_t c, int64_t words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = warp; r < n; r += stride) {
    int64_t s = idx[r];
    s = s < 0 ? 0 : (s >= c ? c - 1 : s);
    const V* src = values + s * words;
    V* dst = out + r * words;
    for (int64_t j = lane; j < words; j += 32) dst[j] = src[j];
  }
}

template <typename V, typename T, bool ADD>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(V* __restrict__ values, const int32_t* __restrict__ idx,
                    const V* __restrict__ rows, int64_t n, int64_t c,
                    int64_t words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = warp; r < n; r += stride) {
    const int64_t d = idx[r];
    if (d < 0 || d >= c) continue;
    const V* src = rows + r * words;
    V* dst = values + d * words;
    for (int64_t j = lane; j < words; j += 32) {
      if constexpr (ADD) {
        dst[j] = add_word<V, T>(dst[j], src[j]);
      } else {
        dst[j] = src[j];
      }
    }
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Widest word (16, 4 or 2 bytes) that divides the row and aligns every
// pointer handed in.
int word_bytes(int64_t row_bytes, const void* a, const void* b) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  if (row_bytes % 16 == 0 && p % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && p % 4 == 0) return 4;
  return 2;
}

template <typename V>
void launch_gather(const void* values, const int32_t* idx, void* out, int64_t n,
                   int64_t c, int64_t row_bytes, cudaStream_t stream) {
  gather_rows_kernel<V><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const V*>(values), idx, static_cast<V*>(out), n, c,
      row_bytes / static_cast<int64_t>(sizeof(V)));
}

template <typename V, typename T>
void launch_scatter(void* values, const int32_t* idx, const void* rows, int64_t n,
                    int64_t c, int64_t row_bytes, int add, cudaStream_t stream) {
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(V));
  if (add) {
    scatter_rows_kernel<V, T, true><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<V*>(values), idx, static_cast<const V*>(rows), n, c, words);
  } else {
    scatter_rows_kernel<V, T, false><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<V*>(values), idx, static_cast<const V*>(rows), n, c, words);
  }
}

template <typename T>
void dispatch_scatter(void* values, const int32_t* idx, const void* rows, int64_t n,
                      int64_t c, int64_t row_bytes, int add, cudaStream_t stream) {
  switch (word_bytes(row_bytes, values, rows)) {
    case 16: launch_scatter<uint4, T>(values, idx, rows, n, c, row_bytes, add, stream); break;
    case 4: launch_scatter<uint32_t, T>(values, idx, rows, n, c, row_bytes, add, stream); break;
    default: launch_scatter<uint16_t, T>(values, idx, rows, n, c, row_bytes, add, stream); break;
  }
}

}  // namespace

extern "C" {

// values [c, row_bytes] (any 2- or 4-byte type), idx int32 [n], out [n, row_bytes].
// Returns the cudaError_t of the launch (0 = success).
int tfp_gather_rows_earlier(const void* values, const void* idx, void* out, long long n,
                    long long c, long long row_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  switch (word_bytes(row_bytes, values, out)) {
    case 16: launch_gather<uint4>(values, ix, out, n, c, row_bytes, s); break;
    case 4: launch_gather<uint32_t>(values, ix, out, n, c, row_bytes, s); break;
    default: launch_gather<uint16_t>(values, ix, out, n, c, row_bytes, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. add: 0 = set, 1 = accumulate.
int tfp_scatter_rows_earlier(void* values, const void* idx, const void* rows, long long n,
                     long long c, long long row_bytes, int dtype, int add,
                     void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (dtype == 0) {
    dispatch_scatter<float>(values, ix, rows, n, c, row_bytes, add, s);
  } else if (dtype == 1) {
    dispatch_scatter<__nv_bfloat16>(values, ix, rows, n, c, row_bytes, add, s);
  } else if (dtype == 2) {
    dispatch_scatter<__half>(values, ix, rows, n, c, row_bytes, add, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
