// Row gather / scatter kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by tfplus_tpu_torch/ops/rowops.py.
//
// Replaces the Pallas kernels of tfplus_tpu/ops/rowops.py:
//   * tfp_gather_rows  <- _gather_pallas (_gather_kernel), rowops.py:71-93
//       out[i, :] = values[clamp(idx[i], 0, C - 1), :]
//     (values[jnp.maximum(idx, 0)] including JAX's clamp of out-of-range
//     gathers; the caller masks the rows of negative indices).
//   * tfp_scatter_rows <- _scatter_pallas (_scatter_set_kernel,
//     _scatter_add_kernel), rowops.py:109-144
//       values[idx[i], :] = rows[i, :]   (add: values[idx[i], :] += rows[i, :])
//     in place; rows whose idx < 0 or >= C are dropped (the jnp path's
//     mode="drop"). Indices are unique by the engine's dedup contract, so no
//     atomics are used; duplicates are undefined, as on the TPU. The add is
//     computed in f32 and rounded to nearest even.
//
// Bound on an H100 SXM: bytes. Each kernel reads every index once, reads N
// rows and writes N rows (the add also reads the N destination rows); it
// does no arithmetic worth counting. At 3.35 TB/s a 32,768 x 128 f32 gather
// moves 33.7 MB, about 10 us. At the widths and counts the engine gives
// them (rows of 4-2,048 bytes, 2,048-32,768 indices) most calls move far
// less, and the time goes to the launch (a kernel that does nothing takes
// about 5 us from event to event, timed as the row cases are) and to the
// chain index -> row -> store.
//
// Design (the Pallas kernels' grid of one (1, 1, d) block per row is not
// carried over):
//   * Words. A row moves in words of 16, 8, 4 or 2 bytes: the widest that
//     divides the row and the alignment of both base pointers.
//   * Width-adaptive lane groups. A row of `words` words gets a group of
//     L = min(32, next_pow2(words)) lanes, so a warp moves 32 / L rows side
//     by side (f32 width 1: 32 rows; f32 width 3 in 4-byte words: 8; bf16
//     width 64 in 16-byte words: 4). A wider row gives each lane K =
//     next_pow2(ceil(words / 32)) of its words, at most 8, and rows wider
//     still take several passes.
//   * Rows in flight. A lane holds U * K words in registers: K words of each
//     of U rows of its group. A step loads the U indices, then every source
//     word (and for the add every destination word) of those rows, and only
//     then stores. The scatter's source rows need no index, so they are
//     loaded before anything that waits on one. More rows per lane cost
//     registers, and so resident warps: U is 1, and 2 only where K is 1 and
//     the rows outnumber twice what one wave of one-row lanes holds (the
//     2^19-row fills; f32 width 128 at 32,768). U and K are template
//     arguments: with either known only at run time the compiler branched
//     around every slot and put its instructions between an index's arrival
//     and the row loads. The warp's groups take neighbouring rows, so each
//     index load and each gather store is one coalesced run.
//   * Grid. Every tile of rows gets a warp of its own, and the grid as many
//     blocks as that takes: the card's block scheduler starts a block as
//     another ends, which was as fast as one wave of resident blocks
//     striding over the tiles, and needs no occupancy query.
//   * Cache hints. Indices and source rows are read through the
//     non-coherent path (ld.global.nc) and the gather's output is written
//     with streaming stores (st.global.cs), since the caller reads it once.
// tfp_rowops_plan returns the plan a call takes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxWarpsPerSm = 64;      // 2,048 resident threads on Hopper
constexpr int kMaxWordsPerLane = 8;     // words of a row a lane holds per pass
constexpr int64_t kMaxGrid = 0x7fffffff;  // blocks of one launch
constexpr int kMaxDevices = 64;

enum Kind { kGather = 0, kSet = 1, kAdd = 2 };

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

// Gather: dst = out [n, words], src = values [c, words].
// Set / add: dst = values [c, words], src = rows [n, words].
// Lanes per row L = 2^lshift; U rows in flight per lane, K words of each
// row per lane and pass. Each warp moves one tile of U * 32 / L rows: row u
// of the lane's group is t0 + u * groups + g. Indices and sources are read
// through the non-coherent path; the gather's output is written with
// streaming stores.
template <typename V, int U, int K, int KIND, typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(V* __restrict__ dst, const V* __restrict__ src,
            const int32_t* __restrict__ idx, int64_t n, int64_t c,
            int64_t words, int lshift) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> lshift;                // the lane's group in the warp
  const int li = lane & ((1 << lshift) - 1);   // the lane in its group
  const int groups = 32 >> lshift;
  const int64_t pass = static_cast<int64_t>(K) << lshift;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t t0 = warp * groups * U;
  if (t0 >= n) return;
  int64_t row[U];
  int32_t at[U];   // the table's row; -1: past n, or a dropped index
#pragma unroll
  for (int u = 0; u < U; ++u) {
    row[u] = t0 + static_cast<int64_t>(u) * groups + g;
    int32_t d = -1;
    if (row[u] < n) {
      d = __ldg(idx + row[u]);
      if constexpr (KIND == kGather) {
        d = d < 0 ? 0 : (d >= c ? static_cast<int32_t>(c - 1) : d);
      } else if (d < 0 || d >= c) {
        d = -1;
      }
    }
    at[u] = d;
  }
  for (int64_t w0 = 0; w0 < words; w0 += pass) {
    V a[U][K];   // source words
    V b[U][K];   // destination words (add)
    if constexpr (KIND != kGather) {   // the scatter's sources need no index
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t j = w0 + (static_cast<int64_t>(k) << lshift) + li;
          if (row[u] < n && j < words) a[u][k] = __ldg(src + row[u] * words + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t j = w0 + (static_cast<int64_t>(k) << lshift) + li;
        if (at[u] < 0 || j >= words) continue;
        const int64_t t = static_cast<int64_t>(at[u]) * words + j;
        if constexpr (KIND == kGather) a[u][k] = __ldg(src + t);
        if constexpr (KIND == kAdd) b[u][k] = dst[t];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t j = w0 + (static_cast<int64_t>(k) << lshift) + li;
        if (at[u] < 0 || j >= words) continue;
        const int64_t t = static_cast<int64_t>(at[u]) * words + j;
        if constexpr (KIND == kGather) {
          __stcs(dst + row[u] * words + j, a[u][k]);
        } else if constexpr (KIND == kSet) {
          dst[t] = a[u][k];
        } else {
          dst[t] = add_word<V, T>(b[u][k], a[u][k]);
        }
      }
    }
  }
}

// A plan, in the order tfp_rowops_plan writes it.
struct Plan {
  int word_bytes;      // 16, 8, 4 or 2
  int lanes;           // lanes per row, a power of two up to 32
  int words_per_lane;  // K: words of a row a lane holds per step
  int rows_in_flight;  // U: rows of its group a lane holds per step
  int grid;            // blocks
  int block;           // threads per block
};
constexpr int kPlanInts = 6;

struct Call {
  void* dst;
  const void* src;
  const int32_t* idx;
  int64_t n, c, words;
  int lshift, grid;
  cudaStream_t stream;
};

int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = dev >= 0 && dev < kMaxDevices ? counts[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
    if (dev >= 0 && dev < kMaxDevices) counts[dev] = sms;
  }
  return sms;
}

template <typename V, int U, int K, int KIND, typename T>
int launch(const Call& call) {
  rows_kernel<V, U, K, KIND, T><<<call.grid, kThreads, 0, call.stream>>>(
      static_cast<V*>(call.dst), static_cast<const V*>(call.src), call.idx,
      call.n, call.c, call.words, call.lshift);
  return 0;
}

// The (rows in flight, words per lane) pairs the plan rule takes.
template <typename V, int KIND, typename T>
int by_shape(int u, int k, const Call& call) {
  if (u == 1 && k == 1) return launch<V, 1, 1, KIND, T>(call);
  if (u == 2 && k == 1) return launch<V, 2, 1, KIND, T>(call);
  if (u == 1 && k == 2) return launch<V, 1, 2, KIND, T>(call);
  if (u == 1 && k == 4) return launch<V, 1, 4, KIND, T>(call);
  if (u == 1 && k == 8) return launch<V, 1, 8, KIND, T>(call);
  return -1;
}

template <int KIND, typename T>
int by_word(int word_bytes, int u, int k, const Call& call) {
  switch (word_bytes) {
    case 16: return by_shape<uint4, KIND, T>(u, k, call);
    case 8: return by_shape<uint2, KIND, T>(u, k, call);
    case 4: return by_shape<uint32_t, KIND, T>(u, k, call);
    case 2:
      if constexpr (KIND != kAdd || sizeof(T) == 2) {
        return by_shape<uint16_t, KIND, T>(u, k, call);
      }
      return -1;
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the add only).
int dispatch(int kind, int dtype, const Plan& p, const Call& call) {
  const int w = p.word_bytes, u = p.rows_in_flight, k = p.words_per_lane;
  if (kind == kGather) return by_word<kGather, float>(w, u, k, call);
  if (kind == kSet) return by_word<kSet, float>(w, u, k, call);
  if (kind != kAdd) return -1;
  if (dtype == 0) return by_word<kAdd, float>(w, u, k, call);
  if (dtype == 1) return by_word<kAdd, __nv_bfloat16>(w, u, k, call);
  if (dtype == 2) return by_word<kAdd, __half>(w, u, k, call);
  return -1;
}

int log2_of(int64_t x) {   // x a power of two
  int l = 0;
  while ((static_cast<int64_t>(1) << l) < x) ++l;
  return l;
}

int64_t next_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The largest power of two that divides both addresses (256 for nulls).
int64_t align_of(const void* a, const void* b) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return p == 0 ? 256 : static_cast<int64_t>(p & (~p + 1));
}

bool word_fits(int word_bytes, int64_t row_bytes, int64_t align, int dtype,
               int kind) {
  if (row_bytes % word_bytes != 0 || align % word_bytes != 0) return false;
  return kind != kAdd || dtype != 0 || word_bytes >= 4;
}

int make_plan(int64_t row_bytes, int64_t n, int64_t align, int dtype, int kind,
              Plan* p) {
  if (row_bytes <= 0 || n < 0 || dtype < 0 || dtype > 2 || kind < kGather ||
      kind > kAdd)
    return static_cast<int>(cudaErrorInvalidValue);
  int wb = 16;
  while (wb >= 2 && !word_fits(wb, row_bytes, align, dtype, kind)) wb >>= 1;
  if (wb < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = row_bytes / wb;
  p->word_bytes = wb;
  p->lanes = static_cast<int>(words >= 32 ? 32 : next_pow2(words));
  int64_t k = words > 32 ? next_pow2((words + 31) / 32) : 1;
  p->words_per_lane = static_cast<int>(k < kMaxWordsPerLane ? k : kMaxWordsPerLane);
  // two rows in flight per lane once the rows outnumber twice what one
  // wave of one-row lanes holds (64 warps on each SM), where a lane holds
  // one word of a row
  const int64_t wave_rows =
      static_cast<int64_t>(sm_count()) * kMaxWarpsPerSm * (32 / p->lanes);
  p->rows_in_flight = p->words_per_lane == 1 && n > 2 * wave_rows ? 2 : 1;
  // a warp for every tile of rows
  const int64_t rows_per_block = static_cast<int64_t>(kWarpsPerBlock) *
                                 (32 / p->lanes) * p->rows_in_flight;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  p->grid = static_cast<int>(blocks < 1 ? 1 : blocks);
  p->block = kThreads;
  return 0;
}

int run(int kind, int dtype, void* dst, const void* src, const void* idx,
        int64_t n, int64_t c, int64_t row_bytes, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int err = make_plan(row_bytes, n, align_of(dst, src), dtype, kind, &p);
  if (err) return err;
  const Call call{dst, src, static_cast<const int32_t*>(idx), n, c,
                  row_bytes / p.word_bytes, log2_of(p.lanes), p.grid, stream};
  if (dispatch(kind, dtype, p, call) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// values [c, row_bytes] (any 2- or 4-byte type), idx int32 [n], out [n, row_bytes].
// Returns the cudaError_t of the launch (0 = success).
int tfp_gather_rows(const void* values, const void* idx, void* out, long long n,
                    long long c, long long row_bytes, void* stream) {
  return run(kGather, 0, out, values, idx, n, c, row_bytes,
             static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. add: 0 = set, 1 = accumulate.
int tfp_scatter_rows(void* values, const void* idx, const void* rows, long long n,
                     long long c, long long row_bytes, int dtype, int add,
                     void* stream) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  return run(add ? kAdd : kSet, dtype, values, rows, idx, n, c, row_bytes,
             static_cast<cudaStream_t>(stream));
}

// The plan a call of n rows of row_bytes takes, where every base pointer is
// a multiple of align (a power of two): plan[0..5] = word bytes, lanes per
// row, words per lane, rows in flight per lane, grid, block.
// kind: 0 = gather, 1 = scatter (set), 2 = scatter (add); dtype as above.
// Returns 0 or cudaErrorInvalidValue.
int tfp_rowops_plan(long long row_bytes, long long n, long long align,
                    int dtype, int kind, int* plan) {
  Plan p;
  const int err = make_plan(row_bytes, n, align, dtype, kind, &p);
  if (err) return err;
  const int out[kPlanInts] = {p.word_bytes, p.lanes, p.words_per_lane,
                              p.rows_in_flight, p.grid, p.block};
  for (int i = 0; i < kPlanInts; ++i) plan[i] = out[i];
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
