// Flash-attention forward kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by tfplus_tpu_torch/ops/flash_attention.py.
//
// Replaces the two Pallas forward kernels of tfplus_tpu/ops/flash_attention.py:
//   * tfp_flash_fwd        <- _fwd (_fwd_kernel), flash_attention.py:103-408:
//     online softmax over KV tiles, tiles above the diagonal skipped when
//     causal.
//   * tfp_flash_fwd_single <- _fwd_single (_fwd_single_kernel), :222-317:
//     non-causal, the whole KV of one (batch, head) in one block: one qk^T,
//     one softmax, one pv, no online rescale.
// Both compute, for q [B,H,Sq,D], k/v [B,H,Skv,D] (f32 or bf16, contiguous):
//   s = q k^T * sm_scale + (valid ? 0 : mask_value), valid = same segment,
//       neither segment < 0, col < Skv, and col <= row when causal;
//   out = softmax(s) v with inverted dropout on p from the counter hash of
//       (seed, b, h, row, col) (the JAX _dropout_keep, bit for bit);
//   l = sum of p BEFORE dropout, m = row max; rows whose max stays at about
//       mask_value (never hit a valid key) write out 0 and l 0.
// mask_value is finite, and m starts at -FLT_MAX, so no infinity enters the
// arithmetic. f32 runs in full f32 on the CUDA cores (no TF32); bf16 inputs
// are widened to f32, and p is rounded to bf16 before the pv product as the
// JAX kernels round it. Sequence lengths need not divide the tiles: the Q, K
// and V tiles are zero-filled past the end and those keys masked. D is any
// multiple of 8 (the wrapper zero-pads other widths).
//
// Bound on an H100 SXM. The bench's causal bf16 B4 H8 S2048 D128 does
// 4*B*H*S^2*D/2 = 34.4 GFLOP on 67 MB of q, k, v and out: 35 us at the bf16
// tensor-core rate, so operations bound it; these kernels use FMA on the
// CUDA cores (67 TFLOP/s, 513 us at best). bf16 at D 64/128 takes the
// tensor-core kernel of flash_fwd_tc.cu instead; these serve f32 and the
// other widths. BST's heads (B2048 H8 S128 D8 f32, about 11 valid tokens of
// 128) need 0.085 GFLOP of valid work on 87 MB (the valid rows of q, k, v
// and all of out): bytes bound them (26 us); the single-pass kernel here
// reads the padded rows too. So flash_fwd_single now launches the kernel of
// flash_fwd_single.cu, which skips padding; tfp_flash_fwd_single stays as
// the earlier route, which chip_smoke.py times beside it on the same
// inputs, and no wrapper launches it.
//
// Design. A block of 128 threads owns 64 query rows of one (b, h): thread
// (ty = tid / 8, tx = tid % 8) owns rows 4ty..4ty+3 and, within each 64-key
// tile, keys tx + 8j (j < 8), so the 8 lanes that share rows reduce a row's
// max and sum with three xor shuffles; for the pv product it owns output
// columns tx + 8j (j < D/8) of the same rows, so the rescale by alpha needs
// no exchange. Q, K and V sit in shared memory in their own type, rows padded
// by 16 bytes (conflict-free 16-byte reads of four d at a time); p goes
// through a [64, keys + 4] f32 tile. The tiled kernel loops over 64-key
// tiles carrying m, l and the accumulator in registers (on the TPU the grid
// ran in order; here nothing carries between blocks). The single-pass kernel
// keeps all keys of the row in the score tile, which bounds it to what fits
// (the wrapper routes larger KV, and D above 128, to the tiled kernel).
// (flash_fwd_single.cu keeps this kernel's tiles for the listed rows and
// keys.) Causal blocks are launched heaviest first. The accumulator is sized for
// the next power of two of D/8, up to 16 (D 128). The tiled kernel takes
// any D: a block holds at most kDC = 128 columns of a tile at a time, so
// above that the grid splits the output's D into 128-column chunks; each
// block forms s over the full D, streaming Q and K through its tiles chunk
// by chunk in one fixed order (the same s, bit for bit, in every chunk),
// multiplies p by its own chunk of V, and writes its chunk of out; chunk 0
// writes l and m.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 8;                       // lanes that share rows
constexpr int kRows = 4;                     // rows per thread
constexpr int kBQ = (kThreads / kTX) * kRows;  // 64 query rows per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kCols = kBK / kTX;             // keys per thread per tile
constexpr int kDC = 128;                     // head-dim columns a tile holds
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
  int h, sq, skv, d, causal;
  float sm_scale, mask_value, drop_scale;
  uint32_t seed, drop_thresh;  // drop_thresh 0: no dropout
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Columns of a tile: all of D, or one kDC chunk of it.
__host__ __device__ inline int tile_cols(int d) { return d < kDC ? d : kDC; }

// Byte offsets of one block's shared memory for tiles of d columns
// (mirrored by _smem_bytes in flash_attention.py, which routes on the total).
struct Smem {
  size_t q, k, v, p, qseg, kseg, total;
  int ld, ldp;
};

__host__ __device__ inline Smem smem_layout(int d, int n_keys, int esz) {
  Smem s;
  s.ld = d + 16 / esz;
  s.ldp = n_keys + 4;
  s.q = 0;
  s.k = align16(s.q + static_cast<size_t>(kBQ) * s.ld * esz);
  s.v = align16(s.k + static_cast<size_t>(n_keys) * s.ld * esz);
  s.p = align16(s.v + static_cast<size_t>(n_keys) * d * esz);
  s.qseg = align16(s.p + static_cast<size_t>(kBQ) * s.ldp * 4);
  s.kseg = align16(s.qseg + kBQ * 4);
  s.total = align16(s.kseg + static_cast<size_t>(n_keys) * 4);
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

// rows x w elements from global (row stride d) into shared memory (row
// stride ld) in 16-byte words; rows >= rows_valid are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int d, int rows,
                                          int rows_valid, int w) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = w / E;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * E;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      x = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * d + c));
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + c) = x;
  }
}

// Segment ids of positions [p0, p0 + n): the caller's, 0 without segments,
// and -1 past the sequence's end (the ragged edge masks as padding).
__device__ __forceinline__ void load_seg(int* dst, const int32_t* seg, int p0, int n,
                                         int len) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int p = p0 + i;
    dst[i] = p < len ? (seg ? seg[p] : 0) : -1;
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < kTX; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kTX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t mix_bits(uint32_t x) {  // murmur3 finalizer
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t drop_base(const Args& a, int bi, int hi) {
  return a.seed * 0x9E3779B9u + static_cast<uint32_t>(bi) * 0x7FEB352Du +
         static_cast<uint32_t>(hi) * 0x846CA68Bu;
}

// p after inverted dropout at global (row, col).
__device__ __forceinline__ float dropout(const Args& a, uint32_t base, int row, int col,
                                         float p) {
  if (a.drop_thresh == 0u) return p;
  const uint32_t x = mix_bits(base + static_cast<uint32_t>(row) * 0x27D4EB2Fu +
                              static_cast<uint32_t>(col));
  return x >= a.drop_thresh ? p * a.drop_scale : 0.f;
}

// Scaled score with the mask added.
__device__ __forceinline__ float masked(const Args& a, float s, int row, int col, int qs,
                                        int ks) {
  if (a.sm_scale != 1.f) s *= a.sm_scale;
  bool ok = qs == ks && qs >= 0 && ks >= 0;
  if (a.causal) ok = ok && col <= row;
  return ok ? s : s + a.mask_value;
}

__device__ __forceinline__ void zero(float (&s)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
}

// s[i][j] += Q[row 4ty+i] . K[key k0 + tx + 8j] over the tiles' w columns,
// Q and K in shared memory.
template <typename T>
__device__ __forceinline__ void qk_tile(float (&s)[kRows][kCols], const T* Qs, const T* Ks,
                                        int ld, int w, int ty, int tx, int k0) {
  for (int dd = 0; dd < w; dd += 4) {
    float4 qv[kRows], kv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qv[i] = load4(Qs + (ty * kRows + i) * ld + dd);
#pragma unroll
    for (int j = 0; j < kCols; ++j) kv[j] = load4(Ks + (k0 + tx + kTX * j) * ld + dd);
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

// acc[i][j] += sum over keys [0, n) of P[row 4ty+i][key] * V[key][tx + 8j],
// V a tile of d columns.
template <typename T, int DJ>
__device__ __forceinline__ void pv_tile(float (&acc)[kRows][DJ], const float* Ps, int ldp,
                                        const T* Vs, int d, int ty, int tx, int n) {
  const int dj = d / kTX;
  for (int c = 0; c < n; c += 4) {
    float4 p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty * kRows + i) * ldp + c);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      if (jd < dj) {
        const T* vc = Vs + c * d + tx + kTX * jd;
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

struct Block {
  int tx, ty, bh, bi, hi, q0;
};

// Block `tile` of the (b, h, q tile) grid.
__device__ __forceinline__ Block block_coords(const Args& a, int n_qt, int tile) {
  Block b;
  b.tx = threadIdx.x % kTX;
  b.ty = threadIdx.x / kTX;
  // heaviest q tiles first: under causal masking the last tiles do the most
  const int qt = n_qt - 1 - tile % n_qt;
  b.bh = tile / n_qt;
  b.bi = b.bh / a.h;
  b.hi = b.bh % a.h;
  b.q0 = qt * kBQ;
  return b;
}

// Columns [oc0, oc0 + w) of out (and, from chunk 0, l and m when asked) of
// this thread's rows.
template <typename T, int DJ, bool kSingle>
__device__ __forceinline__ void store_rows(const Args& a, const Block& b,
                                           const float (&acc)[kRows][DJ],
                                           const float (&m)[kRows], const float (&l)[kRows],
                                           int oc0, int w) {
  const int dj = w / kTX;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = b.q0 + b.ty * kRows + i;
    if (row >= a.sq) continue;
    const bool never_hit = m[i] <= 0.5f * a.mask_value;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float l_inv = 1.f / l_safe;
    const size_t o = (static_cast<size_t>(b.bh) * a.sq + row) * a.d + oc0 + b.tx;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      if (jd < dj) {
        // as the JAX kernels: the tiled one multiplies by 1/l, the single
        // one divides by l
        const float val = kSingle ? acc[i][jd] / l_safe : acc[i][jd] * l_inv;
        out[o + kTX * jd] = from_f<T>(never_hit ? 0.f : val);
      }
    }
    if (a.l != nullptr && b.tx == 0 && oc0 == 0) {
      const size_t r = static_cast<size_t>(b.bh) * a.sq + row;
      a.l[r] = never_hit ? 0.f : l[i];
      a.m[r] = m[i];
    }
  }
}

// kChunked (D > kDC) streams Q and K through their tiles in chunks; without
// it the chunk loop below is one pass, unrolled, over a resident Q.
template <typename T, int DJ, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tiled_kernel(Args a, int n_qt, int n_dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(kChunked ? kDC : a.d, kBK, sizeof(T));
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  int* qseg = reinterpret_cast<int*>(smem + L.qseg);
  int* kseg = reinterpret_cast<int*>(smem + L.kseg);
  // this block's chunk of out's columns, [oc0, oc0 + ow)
  const int oc0 = kChunked ? static_cast<int>(blockIdx.x % n_dc) * kDC : 0;
  const int ow = kChunked ? tile_cols(a.d - oc0) : a.d;
  const Block b = block_coords(
      a, n_qt, static_cast<int>(kChunked ? blockIdx.x / n_dc : blockIdx.x));
  const T* q = static_cast<const T*>(a.q) + (static_cast<size_t>(b.bh) * a.sq + b.q0) * a.d;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(b.bh) * a.skv * a.d;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(b.bh) * a.skv * a.d;
  const int32_t* ks_g = a.kv_seg ? a.kv_seg + static_cast<size_t>(b.bi) * a.skv : nullptr;

  if (!kChunked) load_rows(Qs, L.ld, q, a.d, kBQ, a.sq - b.q0, a.d);
  load_seg(qseg, a.q_seg ? a.q_seg + static_cast<size_t>(b.bi) * a.sq : nullptr, b.q0, kBQ,
           a.sq);

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }
  const uint32_t base = drop_base(a, b.bi, b.hi);
  // causal: tiles that start past this q tile's last row are skipped
  const int kv_end = a.causal ? min(a.skv, b.q0 + kBQ) : a.skv;

  for (int c0 = 0; c0 < kv_end; c0 += kBK) {
    float s[kRows][kCols];
    // s over the full D, one chunk of columns at a time, in a fixed order
    for (int d0 = 0; d0 < (kChunked ? a.d : 1); d0 += kDC) {
      const int w = kChunked ? tile_cols(a.d - d0) : a.d;
      __syncthreads();  // the last products are done with Qs, Ks, Vs and Ps
      if (kChunked) load_rows(Qs, L.ld, q + d0, a.d, kBQ, a.sq - b.q0, w);
      load_rows(Ks, L.ld, k + static_cast<size_t>(c0) * a.d + d0, a.d, kBK, a.skv - c0, w);
      if (d0 == 0) {
        load_rows(Vs, ow, v + static_cast<size_t>(c0) * a.d + oc0, a.d, kBK, a.skv - c0, ow);
        load_seg(kseg, ks_g, c0, kBK, a.skv);
      }
      __syncthreads();
      if (d0 == 0) zero(s);
      qk_tile(s, Qs, Ks, L.ld, w, b.ty, b.tx, 0);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rl = b.ty * kRows + i;
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int cl = b.tx + kTX * j;
        s[i][j] = masked(a, s[i][j], b.q0 + rl, c0 + cl, qseg[rl], kseg[cl]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_next = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int cl = b.tx + kTX * j;
        const float p = expf(s[i][j] - m_next);
        sum += p;
        Ps[rl * L.ldp + cl] = round_p<T>(dropout(a, base, b.q0 + rl, c0 + cl, p));
      }
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_next;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
    pv_tile<T, DJ>(acc, Ps, L.ldp, Vs, ow, b.ty, b.tx, kBK);
  }
  store_rows<T, DJ, false>(a, b, acc, m, l, oc0, ow);
}

template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_single_kernel(Args a, int n_qt, int n_keys) {
  // the wrapper sends D > kDC to the tiled kernel: one chunk, out's columns
  // all this block's
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(a.d, n_keys, sizeof(T));
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  int* qseg = reinterpret_cast<int*>(smem + L.qseg);
  int* kseg = reinterpret_cast<int*>(smem + L.kseg);
  const Block b = block_coords(a, n_qt, static_cast<int>(blockIdx.x));
  const T* q = static_cast<const T*>(a.q) + (static_cast<size_t>(b.bh) * a.sq + b.q0) * a.d;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(b.bh) * a.skv * a.d;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(b.bh) * a.skv * a.d;

  load_rows(Qs, L.ld, q, a.d, kBQ, a.sq - b.q0, a.d);
  load_rows(Ks, L.ld, k, a.d, n_keys, a.skv, a.d);
  load_rows(Vs, a.d, v, a.d, n_keys, a.skv, a.d);
  load_seg(qseg, a.q_seg ? a.q_seg + static_cast<size_t>(b.bi) * a.sq : nullptr, b.q0, kBQ,
           a.sq);
  load_seg(kseg, a.kv_seg ? a.kv_seg + static_cast<size_t>(b.bi) * a.skv : nullptr, 0, n_keys,
           a.skv);
  __syncthreads();

  // one qk^T over all keys: masked scores into the score tile, row max
  float m[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) m[i] = -FLT_MAX;
  for (int c0 = 0; c0 < n_keys; c0 += kBK) {
    float s[kRows][kCols];
    zero(s);
    qk_tile(s, Qs, Ks, L.ld, a.d, b.ty, b.tx, c0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rl = b.ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + b.tx + kTX * j;
        const float x = masked(a, s[i][j], b.q0 + rl, c, qseg[rl], kseg[c]);
        Ps[rl * L.ldp + c] = x;
        m[i] = fmaxf(m[i], x);
      }
    }
  }
  // one softmax: p = exp(s - m) in place (this thread's own entries), l
  const uint32_t base = drop_base(a, b.bi, b.hi);
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rl = b.ty * kRows + i;
    m[i] = group_max(m[i]);
    float sum = 0.f;
    for (int c0 = 0; c0 < n_keys; c0 += kBK) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + b.tx + kTX * j;
        float* ps = Ps + rl * L.ldp + c;
        const float p = expf(*ps - m[i]);
        sum += p;
        *ps = round_p<T>(dropout(a, base, b.q0 + rl, c, p));
      }
    }
    l[i] = group_sum(sum);
  }
  __syncthreads();
  // one pv
  float acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  pv_tile<T, DJ>(acc, Ps, L.ldp, Vs, a.d, b.ty, b.tx, n_keys);
  store_rows<T, DJ, true>(a, b, acc, m, l, 0, a.d);
}

template <typename T, int DJ, bool kChunked = false>
int launch(const Args& a, int batch, bool single, cudaStream_t stream) {
  const int n_qt = (a.sq + kBQ - 1) / kBQ;
  const int n_dc = (a.d + kDC - 1) / kDC;      // 1 for the single-pass kernel
  const long long blocks = static_cast<long long>(batch) * a.h * n_qt * n_dc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int n_keys = single ? (a.skv + kBK - 1) / kBK * kBK : kBK;
  const Smem L = smem_layout(tile_cols(a.d), n_keys, sizeof(T));
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (single) {
    auto kern = flash_fwd_single_kernel<T, DJ>;
    if (L.total > kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<grid, kThreads, L.total, stream>>>(a, n_qt, n_keys);
  } else {
    auto kern = flash_fwd_tiled_kernel<T, DJ, kChunked>;
    if (L.total > kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<grid, kThreads, L.total, stream>>>(a, n_qt, n_dc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int batch, bool single, cudaStream_t stream) {
  const int dj = tile_cols(a.d) / kTX;          // accumulator columns per chunk
  if (a.d > kDC) return launch<T, 16, true>(a, batch, single, stream);
  if (dj <= 1) return launch<T, 1>(a, batch, single, stream);
  if (dj <= 2) return launch<T, 2>(a, batch, single, stream);
  if (dj <= 4) return launch<T, 4>(a, batch, single, stream);
  if (dj <= 8) return launch<T, 8>(a, batch, single, stream);
  return launch<T, 16>(a, batch, single, stream);
}

int run(const void* q, const void* k, const void* v, const void* q_seg, const void* kv_seg,
        void* out, void* l, void* m, int b, int h, int sq, int skv, int d, int dtype,
        int causal, float sm_scale, float mask_value, unsigned seed, unsigned drop_thresh,
        float drop_scale, void* stream, bool single) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || d < 8 || d % 8 != 0 ||
      (single && d > kDC) || (l == nullptr) != (m == nullptr) ||
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
  a.causal = causal;
  a.sm_scale = sm_scale;
  a.mask_value = mask_value;
  a.drop_scale = drop_scale;
  a.seed = seed;
  a.drop_thresh = drop_thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, single, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, b, single, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [b,h,sq,d], k/v [b,h,skv,d] of dtype (0 = float32, 1 = bfloat16), d a
// multiple of 8; q_seg
// [b,sq] / kv_seg [b,skv] int32 or both null; out like q; l, m f32 [b,h,sq]
// or both null. drop_thresh 0 turns dropout off. Returns the cudaError_t of
// the launch (0 = success).
int tfp_flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                  const void* kv_seg, void* out, void* l, void* m, int b, int h, int sq,
                  int skv, int d, int dtype, int causal, float sm_scale, float mask_value,
                  unsigned seed, unsigned drop_thresh, float drop_scale, void* stream) {
  return run(q, k, v, q_seg, kv_seg, out, l, m, b, h, sq, skv, d, dtype, causal != 0,
             sm_scale, mask_value, seed, drop_thresh, drop_scale, stream, false);
}

// The same without causal masking; the whole KV must fit one block, and d
// is at most 128.
int tfp_flash_fwd_single(const void* q, const void* k, const void* v, const void* q_seg,
                         const void* kv_seg, void* out, void* l, void* m, int b, int h,
                         int sq, int skv, int d, int dtype, float sm_scale,
                         float mask_value, unsigned seed, unsigned drop_thresh,
                         float drop_scale, void* stream) {
  return run(q, k, v, q_seg, kv_seg, out, l, m, b, h, sq, skv, d, dtype, 0, sm_scale,
             mask_value, seed, drop_thresh, drop_scale, stream, true);
}

}  // extern "C"
