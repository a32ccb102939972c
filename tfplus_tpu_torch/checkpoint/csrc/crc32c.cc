// CRC32C (Castagnoli, reflected polynomial 0x82F63B78) for TensorFlow
// TensorBundle checkpoints: every tensor's bytes and every table block of a
// bundle's .index carry a masked CRC32C (tensorflow/core/lib/hash/crc32c.h).
//
// On x86-64 with SSE4.2 the hardware instruction takes 8 bytes a step in
// three independent streams (the three partial CRCs are joined by shifting
// through zeros with a precomputed operator); elsewhere a slicing-by-8 table
// loop. Both compute the same value; the tests hold this file against a
// bytewise Python version.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared [-msse4.2] crc32c.cc
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__) && defined(__x86_64__)
#include <nmmintrin.h>
#define TFP_CRC32C_HW 1
#else
#define TFP_CRC32C_HW 0
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kPoly : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xffu];
  }
};

const Tables& tables() {
  static const Tables tab;
  return tab;
}

// Raw (pre- and post-inverted by the caller) CRC over n bytes, table loop.
uint32_t raw_sw(uint32_t c, const uint8_t* p, size_t n) {
  const Tables& tab = tables();
  while (n && (reinterpret_cast<uintptr_t>(p) & 7u)) {
    c = tab.t[0][(c ^ *p++) & 0xffu] ^ (c >> 8);
    --n;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= c;
    c = tab.t[7][w & 0xff] ^ tab.t[6][(w >> 8) & 0xff] ^
        tab.t[5][(w >> 16) & 0xff] ^ tab.t[4][(w >> 24) & 0xff] ^
        tab.t[3][(w >> 32) & 0xff] ^ tab.t[2][(w >> 40) & 0xff] ^
        tab.t[1][(w >> 48) & 0xff] ^ tab.t[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = tab.t[0][(c ^ *p++) & 0xffu] ^ (c >> 8);
  return c;
}

#if TFP_CRC32C_HW
// GF(2) helpers to move a raw CRC state past `len` zero bytes: the operator
// is a 32x32 bit matrix, applied as a vector of columns.
uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  for (int i = 0; vec; vec >>= 1, ++i)
    if (vec & 1u) sum ^= mat[i];
  return sum;
}

void gf2_square(uint32_t* sq, const uint32_t* mat) {
  for (int n = 0; n < 32; ++n) sq[n] = gf2_times(mat, mat[n]);
}

// Operator that advances a raw CRC state by `len` zero bytes.
struct Shift {
  uint32_t m[32];
  explicit Shift(size_t len) {
    uint32_t odd[32], even[32], cur[32];
    odd[0] = kPoly;  // one zero bit
    for (int n = 1; n < 32; ++n) odd[n] = 1u << (n - 1);
    gf2_square(even, odd);  // two zero bits
    gf2_square(odd, even);  // four
    gf2_square(cur, odd);   // eight: one zero byte
    for (int n = 0; n < 32; ++n) m[n] = 1u << n;  // identity
    // m = cur^len by squaring (powers of one operator commute)
    for (size_t l = len; l; l >>= 1) {
      uint32_t next[32];
      if (l & 1u) {
        for (int n = 0; n < 32; ++n) next[n] = gf2_times(cur, m[n]);
        std::memcpy(m, next, sizeof(m));
      }
      gf2_square(next, cur);
      std::memcpy(cur, next, sizeof(cur));
    }
  }
  uint32_t apply(uint32_t c) const { return gf2_times(m, c); }
};

constexpr size_t kStripe = 8192;  // bytes per stream and round

const Shift& stripe_shift() {
  static const Shift s(kStripe);
  return s;
}

uint32_t raw_hw(uint32_t c, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7u)) {
    c = _mm_crc32_u8(c, *p++);
    --n;
  }
  if (n >= 3 * kStripe) {
    const Shift& sh = stripe_shift();
    while (n >= 3 * kStripe) {
      uint64_t c0 = c, c1 = 0, c2 = 0;
      const uint8_t* p1 = p + kStripe;
      const uint8_t* p2 = p + 2 * kStripe;
      for (size_t i = 0; i < kStripe; i += 8) {
        uint64_t w0, w1, w2;
        std::memcpy(&w0, p + i, 8);
        std::memcpy(&w1, p1 + i, 8);
        std::memcpy(&w2, p2 + i, 8);
        c0 = _mm_crc32_u64(c0, w0);
        c1 = _mm_crc32_u64(c1, w1);
        c2 = _mm_crc32_u64(c2, w2);
      }
      // the raw state is linear: crc(A||B) = shift(crc(A), |B|) ^ crc0(B)
      c = sh.apply(sh.apply(static_cast<uint32_t>(c0)) ^
                   static_cast<uint32_t>(c1)) ^
          static_cast<uint32_t>(c2);
      p += 3 * kStripe;
      n -= 3 * kStripe;
    }
  }
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c64 = _mm_crc32_u64(c64, w);
    p += 8;
    n -= 8;
  }
  c = static_cast<uint32_t>(c64);
  while (n--) c = _mm_crc32_u8(c, *p++);
  return c;
}
#endif

}  // namespace

extern "C" {

// CRC32C of n bytes at p, continuing from `crc` (0 for a fresh value):
// crc32c_extend(crc32c_extend(0, a), b) == crc32c of a followed by b.
uint32_t tfp_crc32c_extend(uint32_t crc, const uint8_t* p, int64_t n) {
  uint32_t c = ~crc;
#if TFP_CRC32C_HW
  c = raw_hw(c, p, static_cast<size_t>(n));
#else
  c = raw_sw(c, p, static_cast<size_t>(n));
#endif
  return ~c;
}

// The table loop alone, whatever the machine (for the tests and the rate).
uint32_t tfp_crc32c_extend_sw(uint32_t crc, const uint8_t* p, int64_t n) {
  return ~raw_sw(~crc, p, static_cast<size_t>(n));
}

int tfp_crc32c_hardware() { return TFP_CRC32C_HW; }

}  // extern "C"
