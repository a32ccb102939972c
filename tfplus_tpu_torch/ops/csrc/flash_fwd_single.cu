// Flash-attention forward for a KV that fits one block (Hopper, sm_90a),
// skipping padding, with a plain C interface loaded through ctypes by
// tfplus_tpu_torch/ops/flash_attention.py (flash_fwd_single).
//
// Replaces the Pallas kernel _fwd_single (_fwd_single_kernel :222,
// pallas_call :293) of tfplus_tpu/ops/flash_attention.py:267: non-causal,
// the whole KV of one (batch, head) at once, one q k^T, one softmax, one pv,
// no online rescale. It computes what that kernel computes, under the
// contract of flash_fwd.cu:
//   s = q k^T * sm_scale + (valid ? 0 : mask_value)   (the mask is ADDED),
//       valid = same segment, neither segment < 0;
//   m = row max, p = exp(s - m), l = sum of p BEFORE dropout;
//   out = (dropout(p) rounded to q's type) v / l, the product summed in f32,
//       with inverted dropout from the counter hash of (seed, b, h, global
//       row, global col), bit for bit;
//   a row whose m <= mask_value / 2 (it hits no valid key) writes out 0 and
//   l 0, and m as it is.
// Sq need not equal Skv. D is a multiple of 8 up to 128 (the wrapper
// zero-pads other widths); the wrapper's single_fits bounds Skv, and
// single_fwd_smem_bytes mirrors the layout below.
//
// Bound on an H100 SXM. At BST's heads (f32 B2048 H8 S128 D8, about 11 of
// 128 tokens valid) the valid pairs need 0.085 GFLOP (1.3 us at 67 TFLOP/s
// f32) on about 87 MB: the valid rows of q, k and v and the segment ids
// read once, and all of out written once (67 MB, nearly all of it the zeros
// of padding). Bytes bound it: 26 us at 3.35 TB/s. The earlier single-pass
// kernel (flash_fwd.cu flash_fwd_single_kernel) reads every padded row and
// key and forms all 64 x 128 scores of each of its two blocks per (b, h).
//
// Design. Padding is skipped exactly. A key whose segment id is < 0 scores
// s + mask_value, within an ulp of mask_value, so exp(s - m) is exactly 0 in
// f32 on every row that hits a valid key: it adds exact zeros to l and out.
// A row whose segment id is < 0 hits no key, so its outputs are known
// without reading q, k or v: out 0, l 0 and m = mask_value (qk*scale +
// mask_value rounds to mask_value for any |qk*scale| < 1e30). So a block
// lists, by a warp ballot over the segment ids, the keys of its batch row
// with segment >= 0 and its own rows with segment >= 0, keeping each one's
// global position (for the dropout hash and the stores: BST's candidate
// sits at position 20, after the history), loads only those rows and keys
// (cp.async), and while they are in flight writes the unlisted rows' out,
// l and m with 16-byte stores. When no key is listed, no row is: every row
// then takes that path, so m never stays at -FLT_MAX.
//
// The forward sums nothing across rows, so a problem's rows are split into
// positional chunks of `rows` across blocks, with no second pass. A block
// also takes `heads` heads of one batch row, which share the segment ids:
// it lists once, and the heads' listed Q, K and V rows go into slots of the
// space that one head takes at its largest, as many heads at once as fit
// (all eight of BST's). Then, per batch row's listed keys:
//   * with segments, at most 32 keys and D <= 32 (BST's heads): one thread
//     per (head, listed row), its q and output rows in registers; a pass
//     over the keys for the row max, a second that forms each score again,
//     p, l and the pv. The work follows the listed pairs, and no thread
//     waits on another (at BST's heads the tiles below spend about 17
//     pairs for each listed one);
//   * otherwise the earlier kernel's register tiles over the listed rows and
//     keys: a thread owns 4 rows and, within each 64-key chunk, 64 / kTX
//     keys of them, so the kTX lanes that share rows reduce a row's max and
//     sum by xor shuffles; one masked q k^T into an f32 score tile of all
//     listed keys (a listed row may still meet no listed key of its
//     segment), one softmax in place, one pv in which the thread owns
//     columns tx + kTX j of its rows. kTX is 16 (32-row tiles, a score
//     tile half as large) with segments up to D 32, else 8 (64-row tiles,
//     the earlier kernel's shape). Without segments every row and key is
//     listed in order with no ballot, the work is the earlier kernel's, and
//     the kernel is built without the path above.
// Every output element is computed by one thread in one fixed order, with
// no atomics, and which path a row takes depends only on its batch row's
// keys, so reruns, and other splits of rows and heads across blocks, are
// bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "flash_tc.cuh"   // cp.async and the dropout hash

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = kThreads;              // rows (or keys) one ballot lists
constexpr int kRows = 4;                     // rows per thread
constexpr int kBK = 64;                      // keys per chunk
constexpr int kShortKeys = 32;               // most listed keys of short_rows
constexpr size_t kMaxSmem = 232448;          // 227 KB per block on an H100
constexpr size_t kDefaultSmem = 48 * 1024;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_seg;   // [B, Sq] or null (no segments)
  const int32_t* kv_seg;  // [B, Skv] or null
  void* out;
  float* l;               // [B, H, Sq] or null (no residuals)
  float* m;
  int h, sq, skv, d;
  int rows, heads;        // rows and heads per block
  int n_rc, n_hc;         // row chunks per problem, head chunks per batch row
  float sm_scale, mask_value, drop_scale;
  uint32_t seed, drop_thresh;  // drop_thresh 0: no dropout
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offsets of one block's shared memory (mirrored by
// single_fwd_smem_bytes in flash_attention.py): the listed rows' Q and the
// listed keys' K (their own type, rows padded by 16 bytes) and V (unpadded),
// the f32 score tile of `tile` rows by every key chunk, the listed keys'
// positions and segments, the listed rows' positions and segments, each row
// of the chunk's flag, and the ballot counts.
struct Smem {
  size_t q, k, v, p, kidx, kseg, ridx, rseg, rflag, counts, total;
  int ld, ldp;
};

__host__ __device__ inline Smem smem_layout(int d, int skv, int esz, int rows, int tile) {
  Smem s;
  const int nkp = round_up(skv, kBK);
  s.ld = d + 16 / esz;
  s.ldp = nkp + 4;
  s.q = 0;
  s.k = align16(s.q + static_cast<size_t>(rows) * s.ld * esz);
  s.v = align16(s.k + static_cast<size_t>(nkp) * s.ld * esz);
  s.p = align16(s.v + static_cast<size_t>(nkp) * d * esz);
  s.kidx = align16(s.p + static_cast<size_t>(tile) * s.ldp * 4);
  s.kseg = s.kidx + static_cast<size_t>(nkp) * 4;
  s.ridx = s.kseg + static_cast<size_t>(nkp) * 4;
  s.rseg = s.ridx + static_cast<size_t>(rows) * 4;
  s.rflag = s.rseg + static_cast<size_t>(rows) * 4;
  s.counts = s.rflag + static_cast<size_t>(rows) * 4;
  s.total = align16(s.counts + kWarps * 4);
  return s;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as JAX's astype
}

// p as the pv product takes it: rounded to v's type.
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<T>(p));
}

// Four consecutive elements from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int kTX> __device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < kTX; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int kTX> __device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kTX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// This thread's place among the block's threads whose `pred` holds, in
// thread order, or -1; `total` gets their number. `counts` is kWarps ints
// of shared memory; the barriers are inside.
__device__ __forceinline__ int list_place(bool pred, int* counts, int& total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? counts[w] : 0;
    total += counts[w];
  }
  __syncthreads();  // counts is rewritten by the next pass
  return pred ? before + __popc(ballot & ((1u << lane) - 1u)) : -1;
}

// For each of `heads` heads: n rows of `pieces` 16-byte pieces from global
// rows idx[i] (row stride `stride` bytes, heads `src_head` bytes apart) into
// shared rows of `ld_bytes` (heads `dst_head` bytes apart), asynchronously.
__device__ __forceinline__ void gather_rows(unsigned char* dst, int dst_head, int ld_bytes,
                                            const unsigned char* src, size_t src_head,
                                            size_t stride, const int* idx, int n, int pieces,
                                            int heads) {
  const int per_head = n * pieces;
  for (int i = threadIdx.x; i < heads * per_head; i += kThreads) {
    const int hs = i / per_head, e = i - hs * per_head;
    const int r = e / pieces, p = e - r * pieces;
    tc::cp_async16(tc::smem_u32(dst + hs * dst_head + r * ld_bytes + p * 16),
                   src + hs * src_head + static_cast<size_t>(idx[r]) * stride + p * 16, 16);
  }
}

// s[i][j] += Q[row i] . K[key j] over d columns for this thread's rows
// 4ty+i and keys k0 + tx + kTX j of the tile, Q and K in shared memory with
// row stride ld. Rows past nr and keys past nk read the last listed one
// (their scores are not used), so nothing past the listed rows is read.
template <typename T, int kTX>
__device__ __forceinline__ void qk_tile(float (&s)[kRows][kBK / kTX], const T* Qs,
                                        const T* Ks, int ld, int d, int ty, int tx, int k0,
                                        int nr, int nk) {
  constexpr int kCols = kBK / kTX;
  int qo[kRows], ko[kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) qo[i] = min(ty * kRows + i, nr - 1) * ld;
#pragma unroll
  for (int j = 0; j < kCols; ++j) ko[j] = min(k0 + tx + kTX * j, nk - 1) * ld;
  for (int dd = 0; dd < d; dd += 4) {
    float4 qv[kRows], kv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qv[i] = load4(Qs + qo[i] + dd);
#pragma unroll
    for (int j = 0; j < kCols; ++j) kv[j] = load4(Ks + ko[j] + dd);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }
}

// acc[i][jd] += sum over keys [0, n) of P[row 4ty+i][key] * V[key][tx + kTX jd]
// (n a multiple of 4; columns past d are skipped).
template <typename T, int kTX, int DJ>
__device__ __forceinline__ void pv_tile(float (&acc)[kRows][DJ], const float* Ps, int ldp,
                                        const T* Vs, int d, int ty, int tx, int n) {
  for (int c = 0; c < n; c += 4) {
    float4 p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty * kRows + i) * ldp + c);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      const int col = tx + kTX * jd;
      if (col < d) {
        const T* vc = Vs + c * d + col;
        const float v0 = to_f(vc[0]), v1 = to_f(vc[d]), v2 = to_f(vc[2 * d]),
                    v3 = to_f(vc[3 * d]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][jd] = fmaf(p[i].x, v0, acc[i][jd]);
          acc[i][jd] = fmaf(p[i].y, v1, acc[i][jd]);
          acc[i][jd] = fmaf(p[i].z, v2, acc[i][jd]);
          acc[i][jd] = fmaf(p[i].w, v3, acc[i][jd]);
        }
      }
    }
  }
}

// out, l and m of the nr listed rows of one head, whose Q, K and V rows sit
// in shared memory: tiles of kTile rows, each one masked q k^T over the nk
// listed keys into the score tile, one softmax in place, one pv.
template <typename T, int kTX, int DJ>
__device__ __forceinline__ void head_rows(const Args& a, const T* Qs, const T* Ks,
                                          const T* Vs, float* Ps, const int* ridx,
                                          const int* rseg, const int* kidx, const int* kseg,
                                          int nr, int nk, int ld, int ldp, int bi, int hi) {
  constexpr int kCols = kBK / kTX;
  constexpr int kTile = kThreads / kTX * kRows;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int d = a.d;
  const size_t bh = static_cast<size_t>(bi) * a.h + hi;
  const uint32_t base = tc::drop_base(a.seed, bi, hi);
  T* out = static_cast<T*>(a.out) + bh * a.sq * d;
#pragma unroll 1
  for (int t0 = 0; t0 < nr; t0 += kTile) {
    // one q k^T over the listed keys: masked scores into the tile, row max
    float m[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) m[i] = -FLT_MAX;
    for (int c0 = 0; c0 < nk; c0 += kBK) {
      float s[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      qk_tile<T, kTX>(s, Qs + static_cast<size_t>(t0) * ld, Ks, ld, d, ty, tx, c0, nr - t0,
                      nk);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rl = ty * kRows + i;
        const int qs = rseg[t0 + rl];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + tx + kTX * j;
          float x = s[i][j];
          if (a.sm_scale != 1.f) x *= a.sm_scale;
          if (qs != kseg[c]) x += a.mask_value;   // keys past nk: segment -1
          Ps[rl * ldp + c] = x;
          m[i] = fmaxf(m[i], x);
        }
      }
    }
    // one softmax: p = exp(s - m) in place (this thread's own entries), l
    float l[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rl = ty * kRows + i;
      const int grow = ridx[t0 + rl];
      m[i] = group_max<kTX>(m[i]);
      float sum = 0.f;
      for (int c0 = 0; c0 < nk; c0 += kBK) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + tx + kTX * j;
          float* ps = Ps + rl * ldp + c;
          const float p = expf(*ps - m[i]);
          sum += p;
          float pd = p;
          if (a.drop_thresh != 0u) {
            pd = tc::keep(base, grow, kidx[c], a.drop_thresh) ? p * a.drop_scale : 0.f;
          }
          *ps = round_p<T>(pd);
        }
      }
      l[i] = group_sum<kTX>(sum);
    }
    __syncthreads();
    // one pv over the listed keys (V's rows past nk are zeros)
    float acc[kRows][DJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
    pv_tile<T, kTX, DJ>(acc, Ps, ldp, Vs, d, ty, tx, round_up(nk, 4));
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = t0 + ty * kRows + i;
      if (lr >= nr) continue;
      const int grow = ridx[lr];
      const bool never_hit = m[i] <= 0.5f * a.mask_value;
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      T* o = out + static_cast<size_t>(grow) * d;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        const int col = tx + kTX * jd;
        if (col < d) o[col] = from_f<T>(never_hit ? 0.f : acc[i][jd] / l_safe);
      }
      if (a.l != nullptr && tx == 0) {
        a.l[bh * a.sq + grow] = never_hit ? 0.f : l[i];
        a.m[bh * a.sq + grow] = m[i];
      }
    }
    __syncthreads();  // the next tile rewrites the score tile
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Four f32 values stored as four consecutive elements of type T.
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// out, l and m of the listed rows of `gn` heads at once, for at most 32
// listed keys and D of at most 4 DQ: one thread per (head, listed row),
// its q row and its output row in registers. A first pass over the keys
// finds the row max, a second forms each score again (bit for bit), p, l
// and the pv. All threads of a warp read the same key rows of a head, so
// those reads are broadcasts, and nothing waits on another thread.
template <typename T, int DQ>
__device__ __forceinline__ void short_rows(const Args& a, const unsigned char* qkv,
                                           int per_head, int fq, int fk, const int* ridx,
                                           const int* rseg, const int* kidx, const int* kseg,
                                           int nr, int nk, int ld, int bi, int h0, int gn) {
  const int d = a.d, nq = d / 4;
#pragma unroll 1
  for (int t = threadIdx.x; t < gn * nr; t += kThreads) {
    const int hs = t / nr, i = t - hs * nr;
    const T* Qs = reinterpret_cast<const T*>(qkv + hs * per_head);
    const T* Ks = reinterpret_cast<const T*>(qkv + hs * per_head + fq);
    const T* Vs = reinterpret_cast<const T*>(qkv + hs * per_head + fq + fk);
    float4 q[DQ], acc[DQ];
#pragma unroll
    for (int u = 0; u < DQ; ++u) {
      q[u] = u < nq ? load4(Qs + i * ld + 4 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int qs = rseg[i];
    auto score = [&](int j) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < DQ; ++u)
        if (u < nq) s = dot4(q[u], load4(Ks + j * ld + 4 * u), s);
      if (a.sm_scale != 1.f) s *= a.sm_scale;
      return qs != kseg[j] ? s + a.mask_value : s;
    };
    float m = -FLT_MAX;
#pragma unroll 1
    for (int j = 0; j < nk; ++j) m = fmaxf(m, score(j));
    const int hi = h0 + hs, grow = ridx[i];
    const uint32_t base = tc::drop_base(a.seed, bi, hi);
    float l = 0.f;
#pragma unroll 1
    for (int j = 0; j < nk; ++j) {
      const float p = expf(score(j) - m);
      l += p;
      float pd = p;
      if (a.drop_thresh != 0u) {
        pd = tc::keep(base, grow, kidx[j], a.drop_thresh) ? p * a.drop_scale : 0.f;
      }
      pd = round_p<T>(pd);
#pragma unroll
      for (int u = 0; u < DQ; ++u)
        if (u < nq) fma4(acc[u], pd, load4(Vs + j * d + 4 * u));
    }
    const bool never_hit = m <= 0.5f * a.mask_value;
    const float l_safe = l == 0.f ? 1.f : l;
    const size_t r = (static_cast<size_t>(bi) * a.h + hi) * a.sq + grow;
    T* o = static_cast<T*>(a.out) + r * d;
#pragma unroll
    for (int u = 0; u < DQ; ++u) {
      if (u < nq) {
        const float4 x = acc[u];
        store4(o + 4 * u, never_hit ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : make_float4(x.x / l_safe, x.y / l_safe,
                                                  x.z / l_safe, x.w / l_safe));
      }
    }
    if (a.l != nullptr) {
      a.l[r] = never_hit ? 0.f : l;
      a.m[r] = m;
    }
  }
}

// Score-tile rows: 32 (kTX 16) with segments up to D 32, else 64 (kTX 8).
__host__ __device__ inline int tile_rows(int d, bool segments) {
  return segments && d <= 32 ? 32 : 64;
}

// kShort compiles in short_rows (segments and D <= 32). Up to D 64 the
// kernel keeps to 128 registers, four blocks to an SM: BST's heads and
// dense work at small Skv need that many blocks resident.
template <typename T, int kTX, int DJ, bool kShort>
__global__ void __launch_bounds__(kThreads, DJ == 16 ? 1 : 4)
flash_fwd_single_skip_kernel(Args a) {
  constexpr int kTile = kThreads / kTX * kRows;  // rows per tile: 64 or 32
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(a.d, a.skv, sizeof(T), a.rows, kTile);
  unsigned char* qkv = smem + L.q;
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  int* kidx = reinterpret_cast<int*>(smem + L.kidx);
  int* kseg = reinterpret_cast<int*>(smem + L.kseg);
  int* ridx = reinterpret_cast<int*>(smem + L.ridx);
  int* rseg = reinterpret_cast<int*>(smem + L.rseg);
  int* rflag = reinterpret_cast<int*>(smem + L.rflag);
  int* counts = reinterpret_cast<int*>(smem + L.counts);

  const int tid = threadIdx.x;
  const int rc = static_cast<int>(blockIdx.x % a.n_rc);
  const int hb = static_cast<int>(blockIdx.x / a.n_rc);
  const int bi = hb / a.n_hc;
  const int h0 = hb % a.n_hc * a.heads, hn = min(a.heads, a.h - h0);
  const int d = a.d, ld = L.ld, ldp = L.ldp;
  const int esz = static_cast<int>(sizeof(T));
  const int pieces = d * esz / 16;                 // 16-byte pieces per row
  const size_t row_bytes = static_cast<size_t>(d) * esz;
  const int r0 = rc * a.rows, rows = min(a.rows, a.sq - r0);
  const int32_t* qs_g = a.q_seg ? a.q_seg + static_cast<size_t>(bi) * a.sq : nullptr;
  const int32_t* ks_g = a.kv_seg ? a.kv_seg + static_cast<size_t>(bi) * a.skv : nullptr;
  // this thread's row of the chunk and the first key window's ids, together
  const int row = r0 + tid;
  const bool has_row = tid < rows;
  const int rs = has_row ? (qs_g ? qs_g[row] : 0) : -1;
  const int ks0 = tid < a.skv && ks_g ? ks_g[tid] : -1;

  int nk = 0, nr, at;
  if (qs_g == nullptr) {
    // no segments: every key and row is listed, in order, with no ballot
    nk = a.skv;
    nr = rows;
    at = has_row ? tid : -1;
    for (int j = tid; j < nk; j += kThreads) {
      kidx[j] = j;
      kseg[j] = 0;
    }
  } else {
    // list the keys that are not padding
    for (int c0 = 0; c0 < a.skv; c0 += kScan) {
      const int c = c0 + tid;
      const int seg = c0 == 0 ? ks0 : (c < a.skv ? ks_g[c] : -1);
      int n;
      const int place = list_place(seg >= 0, counts, n);
      if (place >= 0) {
        kidx[nk + place] = c;
        kseg[nk + place] = seg;
      }
      nk += n;
    }
    // list this chunk's rows that are not padding: none when no key is
    // listed (every row then hits nothing)
    at = list_place(rs >= 0 && nk > 0, counts, nr);
  }
  if (tid < a.rows) rflag[tid] = at >= 0;
  if (at >= 0) {
    ridx[at] = row;
    rseg[at] = rs;
  }
  // keys past nk up to whole chunks match no row
  const int nkc = round_up(nk, kBK);
  for (int j = nk + tid; j < nkc; j += kThreads) {
    kidx[j] = 0;
    kseg[j] = -1;
  }
  // Each head's listed Q, K and V rows take one slot of the Q, K and V
  // space, which holds one head at its largest; as many heads as fit load
  // at once. V's rows past nk up to a multiple of 4 are zeros (pv reads
  // them), written once: the loads never touch them.
  const int fq = nr * ld * esz, fk = nk * ld * esz, fv = round_up(nk, 4) * d * esz;
  const int per_head = fq + fk + fv;
  const int slots = nr == 0 ? hn : min(hn, static_cast<int>((L.p - L.q) / per_head));
  const int tail = (round_up(nk, 4) - nk) * pieces;
  for (int i = tid; i < (nr == 0 ? 0 : slots * tail); i += kThreads) {
    const int hs = i / tail;
    *reinterpret_cast<uint4*>(qkv + hs * per_head + fq + fk + nk * d * esz +
                              (i - hs * tail) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

#pragma unroll 1
  for (int g0 = 0; g0 < hn; g0 += slots) {
    const int gn = min(slots, hn - g0);
    const size_t bh = static_cast<size_t>(bi) * a.h + h0 + g0;
    const size_t q_head = static_cast<size_t>(a.sq) * row_bytes;
    const size_t kv_head = static_cast<size_t>(a.skv) * row_bytes;
    if (nr > 0) {
      gather_rows(qkv, per_head, ld * esz,
                  static_cast<const unsigned char*>(a.q) + bh * q_head, q_head, row_bytes,
                  ridx, nr, pieces, gn);
      gather_rows(qkv + fq, per_head, ld * esz,
                  static_cast<const unsigned char*>(a.k) + bh * kv_head, kv_head, row_bytes,
                  kidx, nk, pieces, gn);
      gather_rows(qkv + fq + fk, per_head, d * esz,
                  static_cast<const unsigned char*>(a.v) + bh * kv_head, kv_head, row_bytes,
                  kidx, nk, pieces, gn);
      tc::cp_async_commit();
    }
    // meanwhile the unlisted rows of these heads: out 0, l 0, m = mask_value
    unsigned char* out_rows = static_cast<unsigned char*>(a.out) + (bh * a.sq + r0) * row_bytes;
    const int chunk = rows * pieces;
    for (int i = tid; i < (nr < rows ? gn * chunk : 0); i += kThreads) {
      const int hs = i / chunk, e = i - hs * chunk;
      if (!rflag[e / pieces]) {
        *reinterpret_cast<uint4*>(out_rows + hs * q_head + static_cast<size_t>(e) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (a.l != nullptr && has_row && at < 0) {
      for (int hs = 0; hs < gn; ++hs) {
        a.l[(bh + hs) * a.sq + row] = 0.f;
        a.m[(bh + hs) * a.sq + row] = a.mask_value;
      }
    }
    if (nr == 0) continue;
    tc::cp_async_wait_all();
    __syncthreads();
    bool done = false;
    if constexpr (kShort) {  // few keys: one thread per row
      if (nk <= kShortKeys) {
        short_rows<T, 4 * DJ>(a, qkv, per_head, fq, fk, ridx, rseg, kidx, kseg, nr, nk, ld,
                              bi, h0 + g0, gn);
        done = true;
      }
    }
#pragma unroll 1
    for (int hs = 0; hs < (done ? 0 : gn); ++hs) {
      head_rows<T, kTX, DJ>(a, reinterpret_cast<const T*>(qkv + hs * per_head),
                            reinterpret_cast<const T*>(qkv + hs * per_head + fq),
                            reinterpret_cast<const T*>(qkv + hs * per_head + fq + fk), Ps,
                            ridx, rseg, kidx, kseg, nr, nk, ld, ldp, bi, h0 + g0 + hs);
    }
    __syncthreads();  // the next loads may overwrite the slots
  }
}

template <typename T, int kTX, int DJ, bool kShort = false>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kTile = kThreads / kTX * kRows;
  const long long blocks = static_cast<long long>(batch) * a.n_hc * a.n_rc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Smem L = smem_layout(a.d, a.skv, sizeof(T), a.rows, kTile);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_single_skip_kernel<T, kTX, DJ, kShort>;
  if (L.total > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The accumulator is sized for the next power of two of the columns a
// thread owns, ceil(d / kTX).
template <typename T>
int dispatch(const Args& a, int batch, cudaStream_t stream) {
  if (a.q_seg != nullptr && a.d <= 32) {
    return a.d <= 16 ? launch<T, 16, 1, true>(a, batch, stream)
                     : launch<T, 16, 2, true>(a, batch, stream);
  }
  if (a.d <= 8) return launch<T, 8, 1>(a, batch, stream);
  if (a.d <= 16) return launch<T, 8, 2>(a, batch, stream);
  if (a.d <= 32) return launch<T, 8, 4>(a, batch, stream);
  if (a.d <= 64) return launch<T, 8, 8>(a, batch, stream);
  return launch<T, 8, 16>(a, batch, stream);
}

}  // namespace

extern "C" {

// q [b,h,sq,d], k/v [b,h,skv,d] of dtype (0 = float32, 1 = bfloat16), d a
// multiple of 8 up to 128, contiguous, 16-byte aligned; q_seg [b,sq] /
// kv_seg [b,skv] int32 or both null; out like q; l, m f32 [b,h,sq] or both
// null. Not causal. A block takes `rows` positional rows (a multiple of
// the score tile's rows, tile_rows, at most 128) of `heads` heads of one
// batch row. drop_thresh 0 turns dropout off. Returns the cudaError_t of
// the launch (0 = success).
int tfp_flash_fwd_single_skip(const void* q, const void* k, const void* v, const void* q_seg,
                              const void* kv_seg, void* out, void* l, void* m, int b, int h,
                              int sq, int skv, int d, int dtype, int rows, int heads,
                              float sm_scale, float mask_value, unsigned seed,
                              unsigned drop_thresh, float drop_scale, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || d < 8 || d % 8 != 0 || d > 128 ||
      rows <= 0 || rows > kScan || rows % tile_rows(d, q_seg != nullptr) != 0 ||
      heads <= 0 || (l == nullptr) != (m == nullptr) ||
      (q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_seg = static_cast<const int32_t*>(q_seg);
  a.kv_seg = static_cast<const int32_t*>(kv_seg);
  a.out = out;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.rows = rows;
  a.heads = heads;
  a.n_rc = (sq + rows - 1) / rows;
  a.n_hc = (h + heads - 1) / heads;
  a.sm_scale = sm_scale;
  a.mask_value = mask_value;
  a.drop_scale = drop_scale;
  a.seed = seed;
  a.drop_thresh = drop_thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of shared memory one block takes at (d, skv, dtype, rows, with
// segments or not): the layout that single_fwd_smem_bytes in
// flash_attention.py mirrors.
long long tfp_flash_fwd_single_skip_smem(int d, int skv, int dtype, int rows, int segments) {
  return static_cast<long long>(
      smem_layout(d, skv, dtype == 0 ? 4 : 2, rows, tile_rows(d, segments != 0)).total);
}

}  // extern "C"
