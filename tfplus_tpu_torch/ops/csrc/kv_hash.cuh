// The table's key hashing on the device, shared by the claim-insert kernel
// (claim.cu) and the probe kernel (probe.cu), so that both pick the same
// buckets: the murmur3 finaliser and the two-choice buckets of
// tfplus_tpu_torch/kv/hashing.py (`hash_words`, `bucket_choices`), and the
// sentinel words of a free slot.
#pragma once

#include <stdint.h>

namespace kvh {

constexpr int32_t kEmptyLo = -1;  // EMPTY = 2**64 - 1: (-1, -1)
constexpr int32_t kTombLo = -2;   // TOMBSTONE = 2**64 - 2: (-2, -1)
constexpr int32_t kFreeHi = -1;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// kv/hashing.py `hash_words`
__device__ __forceinline__ uint32_t hash_words(uint32_t lo, uint32_t hi,
                                               uint32_t seed) {
  const uint32_t h = fmix32(lo + seed);
  return fmix32(h ^ (hi * 0x9E3779B9u) ^ (seed * 0x01000193u));
}

// kv/hashing.py `bucket_choices`: b1, b2 < groups (bucket_mask = groups - 1,
// groups a power of two), b2 != b1
__device__ __forceinline__ void bucket_choices(uint32_t lo, uint32_t hi,
                                               uint32_t bucket_mask,
                                               uint32_t* b1, uint32_t* b2) {
  const uint32_t c1 = hash_words(lo, hi, 0x2545F491u) & bucket_mask;
  uint32_t c2 = hash_words(lo, hi, 0x6A09E667u) & bucket_mask;
  if (c2 == c1) c2 = (c2 + 1) & bucket_mask;
  *b1 = c1;
  *b2 = c2;
}

// a slot's key words say it is free (EMPTY or TOMBSTONE); a query key with
// these words is reserved
__device__ __forceinline__ bool is_free(int32_t lo, int32_t hi) {
  return hi == kFreeHi && (lo == kEmptyLo || lo == kTombLo);
}

}  // namespace kvh
