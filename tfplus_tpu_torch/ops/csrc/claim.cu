// Claim-insert kernel for Hopper (sm_90a), with a plain C interface loaded
// through ctypes by tfplus_tpu_torch/ops/claim.py.
//
// Replaces no Pallas kernel. The JAX package places a batch's new keys with
// XLA code, the `lax.while_loop` of tfplus_tpu/kv/table.py `_claim_insert`;
// the port ran that loop as Python rounds of eager tensor ops
// (tfplus_tpu_torch/kv/table.py `_claim_rounds`, still the CPU path and the
// oracle of this kernel), which cost ~60-75 launches and ~4 host reads a
// round. Here every round of one call runs in one launch, and nothing is
// read back.
//
// What it computes, exactly as `_claim_rounds` (the header it leaves, and
// `placed`, are bit for bit the same). Keys whose `need` byte is set are
// compacted into a list once (their two buckets b1, b2 from the murmur3
// finaliser of kv/hashing.py `bucket_choices`). Round j = 0..max_probes-1:
//   1. every still-unplaced listed key reads the key lanes of its j-th
//      candidate slot (lane j of b1 for j < 16, lane j-16 of b2 after that),
//      the header as it was before this round's writes; where the slot is
//      free (EMPTY or TOMB) it bids its query index with atomicMin on a claim
//      word of that slot;
//   2. the lowest bidder of each slot writes key_lo and key_hi there and
//      puts the claim word back to "unclaimed" (a loser reads either the
//      winner's index or "unclaimed", never its own);
//   3. after the writes, every still-unplaced key whose slot now holds its
//      own key adopts the slot (the winner, and a twin that lost to it); the
//      others are counted as still active.
// A round after the first runs only if some key was still active before
// it. Claimed slots keep meta 0. Then, where the caller passes the init
// pool, each placed key writes its initial payload row into row i of the
// caller's staging buffer (not into the table): embedding columns
// (pool[r1] + pool[r2]) * 0.5 rounded as torch rounds it (for 16-bit types
// the sum is rounded to the type first), r1 and r2 from kv/hashing.py
// `init_row_indices`, and zeros in the slot columns; the table scatters
// them into its payload with the row kernel (rowops.cu) at `placed`, as on
// the CPU. Last, the call adds misses, rounds, inserted and unplaced into
// the caller's int64[4] counter buffer.
//
// One launch shape: a cooperative grid with grid-wide barriers between the
// phases, as many blocks as the keys need up to what the card holds at once
// (4 blocks for a DCN table's 2,048 ids, all SMs for a table's load). The
// claim words live in a caller-owned int32 buffer of >= capacity entries
// that is all "unclaimed" at rest: a round resets only the words it touched.
//
// Bound on an H100 SXM: latency, not bytes or operations. The bytes are
// tiny (each listed key reads its 8-byte key and its two header lanes a
// round, writes 8 header bytes, reads two pool rows and writes its staging
// row: ~0.2 MB for a DCN table a step, 0.06 us at 3.35 TB/s), but each
// round is three dependent trips to L2 (read, bid, adopt) behind grid
// barriers. The design keeps every round on the device and touches only
// the listed keys. The hashing is kv_hash.cuh's, which the probe kernel
// (probe.cu) shares.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

// control words at the head of the scratch buffer
constexpr int kCount = 0;    // listed keys
constexpr int kActive = 1;   // + (j & 1): keys still active after round j
constexpr int kCtlWords = 4;

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Args {
  int32_t* header;          // [groups * 64], bucket-planar
  uint32_t bucket_mask;     // groups - 1 (groups a power of two)
  const int32_t* q;         // [n, 2] key words
  const uint8_t* need;      // [n]
  int64_t n;
  int max_probes;
  int32_t* placed;          // [n] out: slot or -1
  int32_t* claim;           // [>= capacity], "unclaimed" at rest
  int32_t* ctl;             // [kCtlWords]
  int32_t* list;            // [n] listed keys' query indices
  uint32_t* b1;             // [n] their buckets
  uint32_t* b2;
  int32_t* bid;             // [n] 1 where the key bid this round
  long long* counts;        // [4] misses, claim_rounds, inserted, unplaced
  const void* pool;         // [pool_rows, dim] or nullptr: no initial rows
  int64_t pool_rows;
  void* rows;               // [n, width] staging rows
  int64_t width;
  int64_t dim;
  int dtype;
};

__device__ __forceinline__ int64_t slot_of(int j, uint32_t b1, uint32_t b2) {
  return j < 16 ? static_cast<int64_t>(b1) * 16 + j
                : static_cast<int64_t>(b2) * 16 + (j - 16);
}

// flat positions of a slot's key lanes in the planar header
__device__ __forceinline__ int64_t lo_pos(int64_t s) {
  return (s >> 4) * 64 + (s & 15);
}
__device__ __forceinline__ int64_t hi_pos(int64_t s) {
  return (s >> 4) * 64 + 16 + (s & 15);
}

template <typename T>
__device__ __forceinline__ void init_row(const T* pool, T* row, int64_t r1,
                                         int64_t r2, int64_t dim,
                                         int64_t width, int lane);

template <>
__device__ __forceinline__ void init_row<float>(const float* pool, float* row,
                                                int64_t r1, int64_t r2,
                                                int64_t dim, int64_t width,
                                                int lane) {
  for (int64_t c = lane; c < width; c += 32)
    row[c] = c < dim ? __fmul_rn(__fadd_rn(pool[r1 * dim + c],
                                           pool[r2 * dim + c]), 0.5f)
                     : 0.0f;
}

template <>
__device__ __forceinline__ void init_row<__nv_bfloat16>(
    const __nv_bfloat16* pool, __nv_bfloat16* row, int64_t r1, int64_t r2,
    int64_t dim, int64_t width, int lane) {
  for (int64_t c = lane; c < width; c += 32) {
    if (c < dim) {
      const __nv_bfloat16 s = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(pool[r1 * dim + c]),
                    __bfloat162float(pool[r2 * dim + c])));
      row[c] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(s), 0.5f));
    } else {
      row[c] = __float2bfloat16_rn(0.0f);
    }
  }
}

template <>
__device__ __forceinline__ void init_row<__half>(const __half* pool,
                                                 __half* row, int64_t r1,
                                                 int64_t r2, int64_t dim,
                                                 int64_t width, int lane) {
  for (int64_t c = lane; c < width; c += 32) {
    if (c < dim) {
      const __half s = __float2half_rn(__fadd_rn(
          __half2float(pool[r1 * dim + c]), __half2float(pool[r2 * dim + c])));
      row[c] = __float2half_rn(__fmul_rn(__half2float(s), 0.5f));
    } else {
      row[c] = __float2half_rn(0.0f);
    }
  }
}

// a warp a placed key: its initial row into row i of the staging buffer
template <typename T>
__device__ void init_rows(const Args& a, int32_t count, int64_t warp,
                          int64_t warps, int lane) {
  const T* pool = static_cast<const T*>(a.pool);
  T* rows = static_cast<T*>(a.rows);
  for (int64_t k = warp; k < count; k += warps) {
    const int32_t i = __ldcg(&a.list[k]);
    if (__ldcg(&a.placed[i]) < 0) continue;
    const int32_t* key = a.q + 2 * static_cast<int64_t>(i);
    const uint32_t lo = static_cast<uint32_t>(key[0]);
    const uint32_t hi = static_cast<uint32_t>(key[1]);
    const int64_t r1 = kvh::hash_words(lo, hi, 0x1B873593u) % a.pool_rows;
    const int64_t r2 = kvh::hash_words(lo, hi, 0xCC9E2D51u) % a.pool_rows;
    init_row<T>(pool, rows + static_cast<int64_t>(i) * a.width, r1, r2,
                a.dim, a.width, lane);
  }
}

// Every loop over keys below strides by the whole grid from the thread's
// own index, so the k-th listed key is handled by the same thread in every
// phase: a listed key's `bid` is only ever touched by it, and its `placed`
// only by it after the listing. What another thread (on another SM) may
// have written is read with __ldcg, from L2, after a barrier, so no stale
// L1 line is read.
__global__ void __launch_bounds__(kThreads) claim_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const unsigned below = (1u << lane) - 1u;

  if (tid == 0) {
    for (int w = 0; w < kCtlWords; ++w) a.ctl[w] = 0;
  }
  grid.sync();

  // list the keys that need a slot (warp-aggregated: one atomic a warp)
  for (int64_t base = tid - lane; base < a.n; base += nthreads) {
    const int64_t i = base + lane;
    bool nd = false;
    if (i < a.n) {
      a.placed[i] = -1;
      nd = a.need[i] != 0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, nd);
    if (m == 0) continue;
    const int leader = __ffs(m) - 1;
    int off = 0;
    if (lane == leader) off = atomicAdd(&a.ctl[kCount], __popc(m));
    off = __shfl_sync(0xffffffffu, off, leader);
    if (nd) {
      const int64_t k = off + __popc(m & below);
      a.list[k] = static_cast<int32_t>(i);
      kvh::bucket_choices(static_cast<uint32_t>(a.q[2 * i]),
                          static_cast<uint32_t>(a.q[2 * i + 1]),
                          a.bucket_mask, &a.b1[k], &a.b2[k]);
    }
  }
  grid.sync();
  const int32_t count = __ldcg(&a.ctl[kCount]);
  if (count == 0) return;  // the same on every thread: no barrier is left

  int rounds = 0;
  for (int j = 0; j < a.max_probes; ++j) {
    if (j > 0 && __ldcg(&a.ctl[kActive + ((j - 1) & 1)]) == 0) break;
    ++rounds;
    // 1. read the candidate slot as it was; bid on it where it is free
    for (int64_t k = tid; k < count; k += nthreads) {
      const int32_t i = __ldcg(&a.list[k]);
      int32_t bid = 0;
      if (__ldcg(&a.placed[i]) < 0) {
        const int64_t s = slot_of(j, __ldcg(&a.b1[k]), __ldcg(&a.b2[k]));
        const int32_t lo = __ldcg(&a.header[lo_pos(s)]);
        const int32_t hi = __ldcg(&a.header[hi_pos(s)]);
        if (kvh::is_free(lo, hi)) {
          atomicMin(&a.claim[s], i);
          bid = 1;
        }
      }
      a.bid[k] = bid;
    }
    grid.sync();
    // 2. the lowest bidder writes its key and frees the claim word
    for (int64_t k = tid; k < count; k += nthreads) {
      if (!a.bid[k]) continue;
      const int32_t i = __ldcg(&a.list[k]);
      const int64_t s = slot_of(j, __ldcg(&a.b1[k]), __ldcg(&a.b2[k]));
      if (__ldcg(&a.claim[s]) == i) {
        const int32_t* key = a.q + 2 * static_cast<int64_t>(i);
        a.header[lo_pos(s)] = key[0];
        a.header[hi_pos(s)] = key[1];
        a.claim[s] = 0x7fffffff;
      }
    }
    // every thread read last round's count before the barrier above
    if (tid == 0) a.ctl[kActive + ((j + 1) & 1)] = 0;
    grid.sync();
    // 3. adopt the slot that now holds the key's own words; count the rest
    for (int64_t base = tid - lane; base < count; base += nthreads) {
      const int64_t k = base + lane;
      bool active = false;
      if (k < count) {
        const int32_t i = __ldcg(&a.list[k]);
        if (__ldcg(&a.placed[i]) < 0) {
          const int64_t s = slot_of(j, __ldcg(&a.b1[k]), __ldcg(&a.b2[k]));
          const int32_t* key = a.q + 2 * static_cast<int64_t>(i);
          if (__ldcg(&a.header[lo_pos(s)]) == key[0] &&
              __ldcg(&a.header[hi_pos(s)]) == key[1]) {
            a.placed[i] = static_cast<int32_t>(s);
          } else {
            active = true;
          }
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, active);
      if (lane == 0 && m) atomicAdd(&a.ctl[kActive + (j & 1)], __popc(m));
    }
    grid.sync();
  }

  if (tid == 0) {
    const int32_t unplaced = __ldcg(&a.ctl[kActive + ((rounds - 1) & 1)]);
    atomicAdd(reinterpret_cast<unsigned long long*>(&a.counts[0]),
              static_cast<unsigned long long>(count));
    atomicAdd(reinterpret_cast<unsigned long long*>(&a.counts[1]),
              static_cast<unsigned long long>(rounds));
    atomicAdd(reinterpret_cast<unsigned long long*>(&a.counts[2]),
              static_cast<unsigned long long>(count - unplaced));
    atomicAdd(reinterpret_cast<unsigned long long*>(&a.counts[3]),
              static_cast<unsigned long long>(unplaced));
  }
  if (a.pool == nullptr) return;
  const int64_t warp = tid >> 5;
  const int64_t warps = nthreads >> 5;
  switch (a.dtype) {
    case kF32: init_rows<float>(a, count, warp, warps, lane); break;
    case kBF16: init_rows<__nv_bfloat16>(a, count, warp, warps, lane); break;
    default: init_rows<__half>(a, count, warp, warps, lane); break;
  }
}

// blocks the card holds at once (cached a device)
int resident_blocks(int* blocks) {
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, claim_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm <= 0)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = sms * per_sm;
  }
  *blocks = resident[dev];
  return 0;
}

}  // namespace

extern "C" {

// header int32 [groups, 64] (groups a power of two), q int32 [n, 2], need
// uint8 [n] (torch.bool), placed int32 [n] (out), claim int32 [>= groups *
// 16] all 0x7fffffff at rest, scratch int32 [4 + 4 n], counts int64 [4].
// pool [pool_rows, dim] and rows [n, width] of `dtype` (0 f32, 1 bf16, 2
// f16), or pool null for no initial rows. Returns the launch's cudaError_t
// (0 = success).
int tfp_claim_insert(void* header, long long groups, const void* q,
                     const void* need, long long n, int max_probes,
                     void* placed, void* claim, void* scratch, void* counts,
                     const void* pool, long long pool_rows, void* rows,
                     long long width, long long dim, int dtype,
                     void* stream) {
  if (n <= 0) return 0;
  if (groups <= 0 || (groups & (groups - 1)) != 0 || groups > (1LL << 26) ||
      n >= 0x7fffffffLL || max_probes < 1 || max_probes > 32 ||
      (pool != nullptr && (pool_rows <= 0 || dim <= 0 || width < dim)))
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* scr = static_cast<int32_t*>(scratch);
  Args a;
  a.header = static_cast<int32_t*>(header);
  a.bucket_mask = static_cast<uint32_t>(groups - 1);
  a.q = static_cast<const int32_t*>(q);
  a.need = static_cast<const uint8_t*>(need);
  a.n = n;
  a.max_probes = max_probes;
  a.placed = static_cast<int32_t*>(placed);
  a.claim = static_cast<int32_t*>(claim);
  a.ctl = scr;
  a.list = scr + kCtlWords;
  a.b1 = reinterpret_cast<uint32_t*>(scr + kCtlWords + n);
  a.b2 = reinterpret_cast<uint32_t*>(scr + kCtlWords + 2 * n);
  a.bid = scr + kCtlWords + 3 * n;
  a.counts = static_cast<long long*>(counts);
  a.pool = pool;
  a.pool_rows = pool_rows;
  a.rows = rows;
  a.width = width;
  a.dim = dim;
  a.dtype = dtype;
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != 0) return err;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(claim_kernel), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
