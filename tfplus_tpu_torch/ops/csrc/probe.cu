// Probe kernel for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by tfplus_tpu_torch/ops/probe.py.
//
// Replaces no Pallas kernel. The JAX package's probe, tfplus_tpu/kv/table.py
// `find`, is XLA code; the port ran it as eager tensor ops
// (tfplus_tpu_torch/kv/table.py `_find_plain`, still the CPU path and the
// oracle of this kernel): the two murmur3 hashes, two bucket-row gathers,
// two lane scans and the choice between them, ~180 launches a call, paid on
// the host at every table's lookup. Here one launch does all of it.
//
// What it computes, exactly as `_find_plain` (every output bit for bit).
// For each query key i (its words lo, hi):
//   1. valid = valid[i] (1 where the caller passes none) and the key is not
//      a reserved id (EMPTY or TOMBSTONE words);
//   2. its buckets b1, b2 (kv_hash.cuh `bucket_choices`, as the claim
//      kernel takes them);
//   3. the key-lo, key-hi and meta planes of both buckets' header rows, and
//      the pad plane only when the caller wants it; a lane matches where its
//      key words are the query's (and the key is valid), and is free where
//      its words are EMPTY's or TOMBSTONE's;
//   4. slot: b1's first matching lane, else b2's, else -1; found; insert
//      slot: b1's first free lane, else b2's, else -1, and -1 where not
//      valid; meta: the sum of the matching lanes' meta words as uint32, in
//      int64, b1's where b1 matched, else b2's (0 where none matched); pad
//      the same sum wrapped to int32.
// It adds the valid keys (probed) and the found keys into the caller's
// int64[2] counter buffer, one atomic a block for each.
//
// Shape: 16 threads a key, one bucket lane each, so each plane of a bucket
// row is one 64-byte read of consecutive words; the first matching and the
// first free lane come from a half-warp ballot and __ffs, the meta and pad
// sums from shuffles within the half-warp. Blocks of 256 threads (16 keys),
// as many as the keys need up to 8 a multiprocessor, each walking the keys
// by the grid's stride. It reads 8 bytes of key (and a valid byte) a key,
// 2 x 3 x 64 bytes of lanes (2 x 4 x 64 with the pad plane), and writes 17
// bytes (21 with pad): ~0.8 MB at a DCN table's 2,048 keys, ~0.25 us at
// 3.35 TB/s, so at the lookups' sizes it is bound by the latency of one
// dependent read of the key and then of both bucket rows, not by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;
constexpr int kLanes = 16;  // slots a bucket: one 64-lane header row

struct Args {
  const int32_t* __restrict__ header;  // [groups * 64], bucket-planar
  uint32_t bucket_mask;                // groups - 1 (groups a power of two)
  const int32_t* __restrict__ q;       // [n, 2] key words
  const uint8_t* __restrict__ valid;   // [n] or nullptr: all valid
  int64_t n;
  int want_pad;
  int32_t* slot;                       // [n] out
  uint8_t* found;                      // [n] out (torch.bool)
  int32_t* insert_slot;                // [n] out
  long long* meta;                     // [n] out
  int32_t* pad;                        // [n] out, only with want_pad
  unsigned long long* counts;          // [2] probed, found
};

// the sum over the 16 lanes of this thread's half-warp
template <typename T>
__device__ __forceinline__ T half_warp_sum(T x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, kLanes);
  return x;
}

__global__ void __launch_bounds__(kThreads) probe_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);  // the bucket lane this thread reads
  const int shift = lane & kLanes;      // this half-warp's bits of a ballot
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  unsigned probed = 0, hits = 0;  // this warp's keys, summed in every lane

  // both half-warps of a warp run the same iterations: the ballots and
  // shuffles below take the whole warp
  for (int64_t base = 2 * warp; base < a.n; base += 2 * warps) {
    const int64_t i = base + (shift ? 1 : 0);
    const bool in = i < a.n;
    int32_t lo = 0, hi = 0;
    bool valid = false;
    uint32_t b1 = 0, b2 = 0;
    if (in) {
      lo = a.q[2 * i];
      hi = a.q[2 * i + 1];
      valid = (a.valid == nullptr || a.valid[i] != 0) &&
              !kvh::is_free(lo, hi);
      kvh::bucket_choices(static_cast<uint32_t>(lo),
                          static_cast<uint32_t>(hi), a.bucket_mask, &b1, &b2);
    }
    int32_t lo1 = 0, hi1 = 0, meta1 = 0, pad1 = 0;
    int32_t lo2 = 0, hi2 = 0, meta2 = 0, pad2 = 0;
    if (in) {
      const int32_t* r1 = a.header + static_cast<int64_t>(b1) * 64 + sub;
      const int32_t* r2 = a.header + static_cast<int64_t>(b2) * 64 + sub;
      lo1 = r1[0];
      hi1 = r1[kLanes];
      meta1 = r1[2 * kLanes];
      lo2 = r2[0];
      hi2 = r2[kLanes];
      meta2 = r2[2 * kLanes];
      if (a.want_pad) {
        pad1 = r1[3 * kLanes];
        pad2 = r2[3 * kLanes];
      }
    }
    const bool match1 = valid && lo1 == lo && hi1 == hi;
    const bool match2 = valid && lo2 == lo && hi2 == hi;
    const unsigned m1 =
        (__ballot_sync(0xffffffffu, match1) >> shift) & 0xffffu;
    const unsigned m2 =
        (__ballot_sync(0xffffffffu, match2) >> shift) & 0xffffu;
    const unsigned f1 =
        (__ballot_sync(0xffffffffu, in && kvh::is_free(lo1, hi1)) >> shift) &
        0xffffu;
    const unsigned f2 =
        (__ballot_sync(0xffffffffu, in && kvh::is_free(lo2, hi2)) >> shift) &
        0xffffu;
    // masked sums, as the plain version takes them (at most one lane of a
    // bucket holds a key, so each is that lane's word or 0)
    const long long s1 = half_warp_sum<long long>(
        match1 ? static_cast<long long>(static_cast<uint32_t>(meta1)) : 0);
    const long long s2 = half_warp_sum<long long>(
        match2 ? static_cast<long long>(static_cast<uint32_t>(meta2)) : 0);
    uint32_t p1 = 0, p2 = 0;
    if (a.want_pad) {  // the same for every thread of the grid
      p1 = half_warp_sum<uint32_t>(match1 ? static_cast<uint32_t>(pad1) : 0);
      p2 = half_warp_sum<uint32_t>(match2 ? static_cast<uint32_t>(pad2) : 0);
    }
    if (in && sub == 0) {
      const int32_t s1b = static_cast<int32_t>(b1) * kLanes;
      const int32_t s2b = static_cast<int32_t>(b2) * kLanes;
      a.slot[i] = m1 ? s1b + __ffs(m1) - 1 : (m2 ? s2b + __ffs(m2) - 1 : -1);
      a.found[i] = (m1 | m2) != 0;
      a.meta[i] = m1 ? s1 : s2;
      if (a.want_pad) a.pad[i] = static_cast<int32_t>(m1 ? p1 : p2);
      a.insert_slot[i] =
          valid && (f1 | f2)
              ? (f1 ? s1b + __ffs(f1) - 1 : s2b + __ffs(f2) - 1)
              : -1;
    }
    const bool head = in && sub == 0;
    probed += __popc(__ballot_sync(0xffffffffu, head && valid));
    hits += __popc(__ballot_sync(0xffffffffu, head && (m1 | m2) != 0));
  }

  __shared__ unsigned long long block_counts[2];
  if (threadIdx.x == 0) block_counts[0] = block_counts[1] = 0;
  __syncthreads();
  if (lane == 0 && (probed | hits)) {
    atomicAdd(&block_counts[0], static_cast<unsigned long long>(probed));
    atomicAdd(&block_counts[1], static_cast<unsigned long long>(hits));
  }
  __syncthreads();
  if (threadIdx.x == 0 && (block_counts[0] | block_counts[1])) {
    atomicAdd(&a.counts[0], block_counts[0]);
    atomicAdd(&a.counts[1], block_counts[1]);
  }
}

// the most blocks a launch takes (cached a device)
int max_blocks(int* blocks) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = sms * kBlocksPerSm;
  }
  *blocks = cached[dev];
  return 0;
}

}  // namespace

extern "C" {

// header int32 [groups, 64] (groups a power of two), q int32 [n, 2], valid
// uint8 [n] (torch.bool) or null; out: slot int32 [n], found uint8 [n],
// insert_slot int32 [n], meta int64 [n], and pad int32 [n] when want_pad
// (else null); counts int64 [2] (probed, found), added to. Returns the
// launch's cudaError_t (0 = success).
int tfp_probe(const void* header, long long groups, const void* q,
              const void* valid, long long n, int want_pad, void* slot,
              void* found, void* insert_slot, void* meta, void* pad,
              void* counts, void* stream) {
  if (n <= 0) return 0;
  if (groups < 2 || (groups & (groups - 1)) != 0 || groups > (1LL << 26) ||
      n >= 0x7fffffffLL || (want_pad && pad == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.header = static_cast<const int32_t*>(header);
  a.bucket_mask = static_cast<uint32_t>(groups - 1);
  a.q = static_cast<const int32_t*>(q);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n;
  a.want_pad = want_pad ? 1 : 0;
  a.slot = static_cast<int32_t*>(slot);
  a.found = static_cast<uint8_t*>(found);
  a.insert_slot = static_cast<int32_t*>(insert_slot);
  a.meta = static_cast<long long*>(meta);
  a.pad = static_cast<int32_t*>(pad);
  a.counts = static_cast<unsigned long long*>(counts);
  int cap = 0;
  const int err = max_blocks(&cap);
  if (err != 0) return err;
  const long long keys_per_block = kThreads / kLanes;
  const long long want = (n + keys_per_block - 1) / keys_per_block;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<void*>(probe_kernel), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
