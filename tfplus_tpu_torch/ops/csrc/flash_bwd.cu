// Flash-attention backward kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by tfplus_tpu_torch/ops/flash_attention.py.
//
// Replace the two Pallas backward kernels that _bwd_pallas launches in
// tfplus_tpu/ops/flash_attention.py:
//   * tfp_flash_bwd_dkv <- _bwd_dkv_kernel (:438, pallas_call :589): dk, dv
//     of one kv tile, looping over the q tiles;
//   * tfp_flash_bwd_dq  <- _bwd_dq_kernel (:504, pallas_call :636): dq of one
//     q tile, looping over the kv tiles.
// Both recompute, for each (q tile, kv tile) pair, from the forward's
// residuals l (sum of p BEFORE dropout) and m (row max), f32 [B,H,Sq]:
//   s  = q k^T * sm_scale + (valid ? 0 : mask_value)   (the mask is ADDED)
//   p  = exp(s - m) / l, and 0 where l == 0 (rows that never hit a key)
//   dp = do v^T, gated by the dropout keep mask and scaled, as is p_d
//   ds = p * (dp - di) * sm_scale,  di = sum(do * o) (computed by the caller)
//   dv += p_d^T do,  dk += ds^T q,  dq += ds k
// with p_d and ds rounded to q's type before their products (bf16), the
// products summed in f32, the dropout keep mask the counter hash of (seed,
// b, h, global row, global col) bit for bit as in the forward, and, when
// causal, tile pairs wholly above the diagonal skipped. Valid = same
// segment, neither segment < 0, inside Sq and Skv, col <= row when causal.
// Ragged lengths are masked here (tiles zero-filled past the end), so no
// copy of q, k, v or do is padded along the sequence. D is any multiple of
// 8 (the wrapper zero-pads other widths).
//
// Determinism: the TPU's two-kernel split is kept. Every output element is
// summed by one block in a fixed order (no atomics), so a rerun on the same
// inputs is bit-identical.
//
// Bound on an H100 SXM. dkv does four products (q k^T, do v^T, p_d^T do,
// ds^T q) and dq three (q k^T, do v^T, ds k), 2·D operations each per valid
// (row, key) pair: at the bench's causal bf16 B4 H8 S2048 D128 that is 68.7
// and 51.5 GFLOP, 69.5 and 52.1 us at the bf16 tensor-core rate, so
// operations bound both. These kernels run FMA on the CUDA cores (67
// TFLOP/s f32: about 1.03 and 0.77 ms at best); bf16 at D 64/128 takes the
// tensor-core kernels of flash_bwd_tc.cu instead, and these serve f32 and
// the other widths. BST's heads (B2048 H8 S128 D8 f32, about 11 valid
// tokens of 128) are bound by bytes; these kernels read the padded rows
// too.
//
// Design. A block of 256 threads owns one kv tile of 64 keys (dkv) or one q
// tile of 64 rows (dq) of one (b, h). Per tile pair, thread (ty = tid / 8,
// tx = tid % 8) computes s and dp for rows 2ty, 2ty+1 and keys tx + 8j
// (j < 8) from Q, dO, K, V tiles in shared memory (their own type, rows
// padded by 16 bytes), and writes p_d and ds into [64, 68] f32 tiles. Then
// dkv's thread accumulates dk and dv for keys 2ty, 2ty+1 and columns
// tx + 8j (j < D/8) over the tile's 64 rows; dq's thread accumulates dq for
// rows 2ty, 2ty+1 over the tile's 64 keys. 256 threads keep each thread's
// two f32 accumulators at 2 x 2 x 16 registers for D = 128. dkv launches
// the kv tiles that see the most q tiles first when causal, dq the q tiles
// that see the most kv tiles. Any D: a tile holds at most kDC = 128
// columns, so above that the grid splits the outputs' D into 128-column
// chunks; each block forms s and dp over the full D, streaming its four
// tiles chunk by chunk in one fixed order (the same ds in every chunk),
// then reloads its own chunk of Q and dO (dkv) or K (dq) for the products
// and writes its chunk of dk, dv or dq.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 8;                         // lanes that share rows
constexpr int kRows = 2;                       // rows (or keys) per thread
constexpr int kBQ = (kThreads / kTX) * kRows;  // 64 query rows per tile
constexpr int kBK = 64;                        // keys per tile
constexpr int kCols = kBK / kTX;               // keys per thread per tile
constexpr int kLdp = kBK + 4;                  // f32 stride of the p_d/ds tiles
constexpr int kDC = 128;                       // head-dim columns a tile holds
constexpr size_t kMaxSmem = 232448;            // 227 KB per block on an H100
constexpr size_t kDefaultSmem = 48 * 1024;
static_assert(kBQ == kBK, "the causal tile skip assumes square tiles");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* l;         // [B, H, Sq]
  const float* m;
  const float* di;
  const int32_t* q_seg;   // [B, Sq] or null (no segments)
  const int32_t* kv_seg;  // [B, Skv] or null
  void* dq;               // [B, H, Sq, D] (dq kernel)
  void* dk;               // [B, H, Skv, D] (dkv kernel)
  void* dv;
  int h, sq, skv, d, causal;
  float sm_scale, mask_value, drop_scale;
  uint32_t seed, drop_thresh;  // drop_thresh 0: no dropout
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Columns of a tile: all of D, or one kDC chunk of it.
__host__ __device__ inline int tile_cols(int d) { return d < kDC ? d : kDC; }

// Byte offsets of one block's shared memory, for tiles of d columns.
struct Smem {
  size_t q, dout, k, v, pd, ds, l, m, di, qseg, kseg, total;
  int ld;
};

__host__ __device__ inline Smem smem_layout(int d, int esz, bool with_pd) {
  Smem s;
  s.ld = d + 16 / esz;
  const size_t tile = static_cast<size_t>(kBQ) * s.ld * esz;
  const size_t ptile = static_cast<size_t>(kBQ) * kLdp * 4;
  s.q = 0;
  s.dout = align16(s.q + tile);
  s.k = align16(s.dout + tile);
  s.v = align16(s.k + tile);
  s.pd = align16(s.v + tile);
  s.ds = align16(s.pd + (with_pd ? ptile : 0));
  s.l = align16(s.ds + ptile);
  s.m = align16(s.l + kBQ * 4);
  s.di = align16(s.m + kBQ * 4);
  s.qseg = align16(s.di + kBQ * 4);
  s.kseg = align16(s.qseg + kBQ * 4);
  s.total = align16(s.kseg + kBK * 4);
  return s;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as JAX's astype
}

// A value as its product takes it: rounded to q's type.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// l, m and di of rows [q0, q0 + kBQ); rows past Sq read l = 0 (p = 0).
__device__ __forceinline__ void load_stats(float* ls, float* ms, float* dis, const Args& a,
                                           size_t row_base, int q0) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int r = q0 + i;
    const bool in = r < a.sq;
    ls[i] = in ? a.l[row_base + r] : 0.f;
    ms[i] = in ? a.m[row_base + r] : 0.f;
    dis[i] = in ? a.di[row_base + r] : 0.f;
  }
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

__device__ __forceinline__ bool keep(uint32_t base, int row, int col, uint32_t thresh) {
  return mix_bits(base + static_cast<uint32_t>(row) * 0x27D4EB2Fu +
                  static_cast<uint32_t>(col)) >= thresh;
}

struct Tiles {
  const void* q;
  const void* dout;
  const void* k;
  const void* v;
  float* pd;
  float* ds;
  float* l;
  float* m;
  float* di;
  int* qseg;
  int* kseg;
  int ld;
};

template <typename T>
__device__ __forceinline__ Tiles tiles(unsigned char* smem, const Smem& L) {
  Tiles t;
  t.q = smem + L.q;
  t.dout = smem + L.dout;
  t.k = smem + L.k;
  t.v = smem + L.v;
  t.pd = reinterpret_cast<float*>(smem + L.pd);
  t.ds = reinterpret_cast<float*>(smem + L.ds);
  t.l = reinterpret_cast<float*>(smem + L.l);
  t.m = reinterpret_cast<float*>(smem + L.m);
  t.di = reinterpret_cast<float*>(smem + L.di);
  t.qseg = reinterpret_cast<int*>(smem + L.qseg);
  t.kseg = reinterpret_cast<int*>(smem + L.kseg);
  t.ld = L.ld;
  return t;
}

// s += Q K^T and dp += dO V^T for rows 2ty+i and keys tx+8j, over the
// tiles' w columns.
template <typename T>
__device__ __forceinline__ void sdp_tile(float (&s)[kRows][kCols], float (&dp)[kRows][kCols],
                                         const Tiles& t, int w, int ty, int tx) {
  const T* Qs = static_cast<const T*>(t.q);
  const T* Os = static_cast<const T*>(t.dout);
  const T* Ks = static_cast<const T*>(t.k);
  const T* Vs = static_cast<const T*>(t.v);
  for (int dd = 0; dd < w; dd += 4) {
    float4 qv[kRows], ov[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qv[i] = load4(Qs + (ty * kRows + i) * t.ld + dd);
      ov[i] = load4(Os + (ty * kRows + i) * t.ld + dd);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float4 kv = load4(Ks + (tx + kTX * j) * t.ld + dd);
      const float4 vv = load4(Vs + (tx + kTX * j) * t.ld + dd);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i][j] = dot4(qv[i], kv, s[i][j]);
        dp[i][j] = dot4(ov[i], vv, dp[i][j]);
      }
    }
  }
}

// One (q tile at q0, kv tile at k0) pair: s and dp over the full D, one
// chunk of columns at a time in a fixed order (kChunked, D > kDC), or in
// one pass, unrolled. `load` fills the tiles with the chunk of columns
// [d0, d0 + w) it is given (and, at d0 = 0, what else the pair needs); the
// barriers around it are here.
template <typename T, bool kChunked, typename Load>
__device__ __forceinline__ void sdp_pair(float (&s)[kRows][kCols], float (&dp)[kRows][kCols],
                                         const Args& a, const Tiles& t, int ty, int tx,
                                         Load load) {
  for (int d0 = 0; d0 < (kChunked ? a.d : 1); d0 += kDC) {
    const int w = kChunked ? tile_cols(a.d - d0) : a.d;
    __syncthreads();  // the last products are done with the tiles
    load(d0, w);
    __syncthreads();
    if (d0 == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    sdp_tile<T>(s, dp, t, w, ty, tx);
  }
}

// p_d (when kPd) and ds of rows 2ty+i and keys tx+8j from s and dp, into
// the shared f32 tiles, rounded to T.
template <typename T, bool kPd>
__device__ __forceinline__ void ds_tile(const Args& a, const Tiles& t,
                                        const float (&s)[kRows][kCols],
                                        const float (&dp)[kRows][kCols], int ty, int tx,
                                        int q0, int k0, uint32_t base) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rl = ty * kRows + i;
    const int row = q0 + rl;
    const float li = t.l[rl], mi = t.m[rl], dii = t.di[rl];
    const int qs = t.qseg[rl];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int cl = tx + kTX * j;
      const int col = k0 + cl;
      const int ks = t.kseg[cl];
      bool ok = qs == ks && qs >= 0 && ks >= 0;
      if (a.causal) ok = ok && col <= row;
      float x = s[i][j] * a.sm_scale;
      if (!ok) x += a.mask_value;
      const float p = li == 0.f ? 0.f : expf(x - mi) / li;
      float pd = p, dpg = dp[i][j];
      if (a.drop_thresh != 0u) {
        const bool kp = keep(base, row, col, a.drop_thresh);
        pd = kp ? p * a.drop_scale : 0.f;
        dpg = kp ? dpg * a.drop_scale : 0.f;
      }
      const float ds = p * (dpg - dii) * a.sm_scale;
      if (kPd) t.pd[rl * kLdp + cl] = round_to<T>(pd);
      t.ds[rl * kLdp + cl] = round_to<T>(ds);
    }
  }
}

// kChunked: D > kDC, streamed through the tiles in chunks (sdp_pair).
template <typename T, int DJ, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a, int n_kt, int n_dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(kChunked ? kDC : a.d, sizeof(T), true);
  const Tiles t = tiles<T>(smem, L);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Os = reinterpret_cast<T*>(smem + L.dout);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  // this block's chunk of dk's and dv's columns, [oc0, oc0 + ow)
  const int oc0 = kChunked ? static_cast<int>(blockIdx.x % n_dc) * kDC : 0;
  const int ow = kChunked ? tile_cols(a.d - oc0) : a.d;
  const int tile = static_cast<int>(kChunked ? blockIdx.x / n_dc : blockIdx.x);
  // kv tile 0 sees the most q tiles under causal masking: launched first
  const int kt = tile % n_kt;
  const int bh = tile / n_kt;
  const int bi = bh / a.h, hi = bh % a.h;
  const int k0 = kt * kBK;
  const size_t qbase = static_cast<size_t>(bh) * a.sq;
  const size_t kbase = static_cast<size_t>(bh) * a.skv;
  const T* q = static_cast<const T*>(a.q) + qbase * a.d;
  const T* dout = static_cast<const T*>(a.dout) + qbase * a.d;
  const T* k = static_cast<const T*>(a.k) + (kbase + k0) * a.d;
  const T* v = static_cast<const T*>(a.v) + (kbase + k0) * a.d;

  // D <= kDC: K and V stay in their tiles; wider heads stream them
  if (!kChunked) {
    load_rows(Ks, t.ld, k, a.d, kBK, a.skv - k0, a.d);
    load_rows(Vs, t.ld, v, a.d, kBK, a.skv - k0, a.d);
  }
  load_seg(t.kseg, a.kv_seg ? a.kv_seg + static_cast<size_t>(bi) * a.skv
                                              : nullptr, k0, kBK, a.skv);
  const int32_t* qs_g = a.q_seg ? a.q_seg + static_cast<size_t>(bi) * a.sq : nullptr;

  float dk[kRows][DJ], dv[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dk[i][jd] = dv[i][jd] = 0.f;
  const uint32_t base = drop_base(a, bi, hi);
  const int dj = ow / kTX;
  // causal: q tiles whose last row lies above this kv tile's first key skip
  const int q_begin = a.causal ? (k0 / kBQ) * kBQ : 0;

  for (int q0 = q_begin; q0 < a.sq; q0 += kBQ) {
    const T* qt = q + static_cast<size_t>(q0) * a.d;
    const T* ot = dout + static_cast<size_t>(q0) * a.d;
    float s[kRows][kCols], dp[kRows][kCols];
    sdp_pair<T, kChunked>(s, dp, a, t, ty, tx, [&](int d0, int w) {
      if (kChunked) {
        load_rows(Ks, t.ld, k + d0, a.d, kBK, a.skv - k0, w);
        load_rows(Vs, t.ld, v + d0, a.d, kBK, a.skv - k0, w);
      }
      load_rows(Qs, t.ld, qt + d0, a.d, kBQ, a.sq - q0, w);
      load_rows(Os, t.ld, ot + d0, a.d, kBQ, a.sq - q0, w);
      if (d0 == 0) {
        load_seg(t.qseg, qs_g, q0, kBQ, a.sq);
        load_stats(t.l, t.m, t.di, a, qbase, q0);
      }
    });
    ds_tile<T, true>(a, t, s, dp, ty, tx, q0, k0, base);
    __syncthreads();
    if (kChunked && oc0 + kDC < a.d) {  // the tiles hold the last chunk
      load_rows(Qs, t.ld, qt + oc0, a.d, kBQ, a.sq - q0, ow);
      load_rows(Os, t.ld, ot + oc0, a.d, kBQ, a.sq - q0, ow);
      __syncthreads();
    }
    // dv[key] += sum_r p_d[r][key] * dO[r]; dk[key] += sum_r ds[r][key] * Q[r]
    for (int r = 0; r < kBQ; ++r) {
      const float2 pd = *reinterpret_cast<const float2*>(t.pd + r * kLdp + ty * kRows);
      const float2 ds = *reinterpret_cast<const float2*>(t.ds + r * kLdp + ty * kRows);
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        if (jd < dj) {
          const int c = tx + kTX * jd;
          const float o = to_f(Os[r * t.ld + c]);
          const float qq = to_f(Qs[r * t.ld + c]);
          dv[0][jd] = fmaf(pd.x, o, dv[0][jd]);
          dv[1][jd] = fmaf(pd.y, o, dv[1][jd]);
          dk[0][jd] = fmaf(ds.x, qq, dk[0][jd]);
          dk[1][jd] = fmaf(ds.y, qq, dk[1][jd]);
        }
      }
    }
  }
  T* dk_out = static_cast<T*>(a.dk) + kbase * a.d + oc0;
  T* dv_out = static_cast<T*>(a.dv) + kbase * a.d + oc0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty * kRows + i;
    if (key >= a.skv) continue;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      if (jd < dj) {
        const size_t o = static_cast<size_t>(key) * a.d + tx + kTX * jd;
        dk_out[o] = from_f<T>(dk[i][jd]);
        dv_out[o] = from_f<T>(dv[i][jd]);
      }
    }
  }
}

template <typename T, int DJ, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a, int n_qt, int n_dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(kChunked ? kDC : a.d, sizeof(T), false);
  const Tiles t = tiles<T>(smem, L);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Os = reinterpret_cast<T*>(smem + L.dout);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  // this block's chunk of dq's columns, [oc0, oc0 + ow)
  const int oc0 = kChunked ? static_cast<int>(blockIdx.x % n_dc) * kDC : 0;
  const int ow = kChunked ? tile_cols(a.d - oc0) : a.d;
  const int tile = static_cast<int>(kChunked ? blockIdx.x / n_dc : blockIdx.x);
  // the last q tile sees the most kv tiles under causal masking: first
  const int qt = n_qt - 1 - tile % n_qt;
  const int bh = tile / n_qt;
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = qt * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * a.sq;
  const size_t kbase = static_cast<size_t>(bh) * a.skv;
  const T* q = static_cast<const T*>(a.q) + (qbase + q0) * a.d;
  const T* dout = static_cast<const T*>(a.dout) + (qbase + q0) * a.d;
  const T* k = static_cast<const T*>(a.k) + kbase * a.d;
  const T* v = static_cast<const T*>(a.v) + kbase * a.d;
  const int32_t* ks_g = a.kv_seg ? a.kv_seg + static_cast<size_t>(bi) * a.skv : nullptr;

  // D <= kDC: Q and dO stay in their tiles; wider heads stream them
  if (!kChunked) {
    load_rows(Qs, t.ld, q, a.d, kBQ, a.sq - q0, a.d);
    load_rows(Os, t.ld, dout, a.d, kBQ, a.sq - q0, a.d);
  }
  load_seg(t.qseg, a.q_seg ? a.q_seg + static_cast<size_t>(bi) * a.sq
                                             : nullptr, q0, kBQ, a.sq);
  load_stats(t.l, t.m, t.di, a, qbase, q0);

  float acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  const uint32_t base = drop_base(a, bi, hi);
  const int dj = ow / kTX;
  // causal: kv tiles that start past this q tile's last row skip
  const int kv_end = a.causal ? min(a.skv, q0 + kBQ) : a.skv;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const T* kt = k + static_cast<size_t>(k0) * a.d;
    const T* vt = v + static_cast<size_t>(k0) * a.d;
    float s[kRows][kCols], dp[kRows][kCols];
    sdp_pair<T, kChunked>(s, dp, a, t, ty, tx, [&](int d0, int w) {
      if (kChunked) {
        load_rows(Qs, t.ld, q + d0, a.d, kBQ, a.sq - q0, w);
        load_rows(Os, t.ld, dout + d0, a.d, kBQ, a.sq - q0, w);
      }
      load_rows(Ks, t.ld, kt + d0, a.d, kBK, a.skv - k0, w);
      load_rows(Vs, t.ld, vt + d0, a.d, kBK, a.skv - k0, w);
      if (d0 == 0) load_seg(t.kseg, ks_g, k0, kBK, a.skv);
    });
    ds_tile<T, false>(a, t, s, dp, ty, tx, q0, k0, base);
    __syncthreads();
    if (kChunked && oc0 + kDC < a.d) {  // Ks holds the last chunk
      load_rows(Ks, t.ld, kt + oc0, a.d, kBK, a.skv - k0, ow);
      __syncthreads();
    }
    // dq[row] += sum_key ds[row][key] * K[key]
    for (int c = 0; c < kBK; c += 4) {
      float4 ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        ds[i] = *reinterpret_cast<const float4*>(t.ds + (ty * kRows + i) * kLdp + c);
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        if (jd < dj) {
          const T* kc = Ks + c * t.ld + tx + kTX * jd;
          const float k0v = to_f(kc[0]), k1v = to_f(kc[t.ld]), k2v = to_f(kc[2 * t.ld]),
                      k3v = to_f(kc[3 * t.ld]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][jd] = fmaf(ds[i].x, k0v, acc[i][jd]);
            acc[i][jd] = fmaf(ds[i].y, k1v, acc[i][jd]);
            acc[i][jd] = fmaf(ds[i].z, k2v, acc[i][jd]);
            acc[i][jd] = fmaf(ds[i].w, k3v, acc[i][jd]);
          }
        }
      }
    }
  }
  T* dq_out = static_cast<T*>(a.dq) + qbase * a.d + oc0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      if (jd < dj) dq_out[static_cast<size_t>(row) * a.d + tx + kTX * jd] = from_f<T>(acc[i][jd]);
    }
  }
}

template <typename Kern>
int launch_kernel(Kern kern, const Smem& L, long long blocks, cudaStream_t stream,
                  const Args& a, int n_tiles, int n_dc) {
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, L.total, stream>>>(a, n_tiles, n_dc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DJ, bool kChunked = false>
int launch(const Args& a, int batch, bool dkv, cudaStream_t stream) {
  const int n_dc = (a.d + kDC - 1) / kDC;
  const long long bh = static_cast<long long>(batch) * a.h * n_dc;
  if (dkv) {
    const int n_kt = (a.skv + kBK - 1) / kBK;
    return launch_kernel(flash_bwd_dkv_kernel<T, DJ, kChunked>,
                         smem_layout(tile_cols(a.d), sizeof(T), true), bh * n_kt, stream, a,
                         n_kt, n_dc);
  }
  const int n_qt = (a.sq + kBQ - 1) / kBQ;
  return launch_kernel(flash_bwd_dq_kernel<T, DJ, kChunked>,
                       smem_layout(tile_cols(a.d), sizeof(T), false), bh * n_qt, stream, a,
                       n_qt, n_dc);
}

template <typename T>
int dispatch(const Args& a, int batch, bool dkv, cudaStream_t stream) {
  const int dj = tile_cols(a.d) / kTX;          // accumulator columns per chunk
  if (a.d > kDC) return launch<T, 16, true>(a, batch, dkv, stream);
  if (dj <= 1) return launch<T, 1>(a, batch, dkv, stream);
  if (dj <= 2) return launch<T, 2>(a, batch, dkv, stream);
  if (dj <= 4) return launch<T, 4>(a, batch, dkv, stream);
  if (dj <= 8) return launch<T, 8>(a, batch, dkv, stream);
  return launch<T, 16>(a, batch, dkv, stream);
}

int run(const void* q, const void* k, const void* v, const void* dout, const void* l,
        const void* m, const void* di, const void* q_seg, const void* kv_seg, void* dq,
        void* dk, void* dv, int b, int h, int sq, int skv, int d, int dtype, int causal,
        float sm_scale, float mask_value, unsigned seed, unsigned drop_thresh,
        float drop_scale, void* stream, bool dkv) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || d < 8 || d % 8 != 0 ||
      l == nullptr || m == nullptr || di == nullptr ||
      (q_seg == nullptr) != (kv_seg == nullptr) ||
      (dkv ? (dk == nullptr || dv == nullptr) : dq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.l = static_cast<const float*>(l);
  a.m = static_cast<const float*>(m);
  a.di = static_cast<const float*>(di);
  a.q_seg = static_cast<const int32_t*>(q_seg);
  a.kv_seg = static_cast<const int32_t*>(kv_seg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.causal = causal != 0;
  a.sm_scale = sm_scale;
  a.mask_value = mask_value;
  a.drop_scale = drop_scale;
  a.seed = seed;
  a.drop_thresh = drop_thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, dkv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, b, dkv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, do [b,h,sq,d] and k, v [b,h,skv,d] of dtype (0 = float32, 1 = bfloat16),
// d a multiple of 8, contiguous; l, m, di f32 [b,h,sq]; q_seg [b,sq] / kv_seg [b,skv] int32 or
// both null; dk, dv like k. drop_thresh 0 turns dropout off. Returns the
// cudaError_t of the launch (0 = success).
int tfp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* l, const void* m, const void* di, const void* q_seg,
                      const void* kv_seg, void* dk, void* dv, int b, int h, int sq,
                      int skv, int d, int dtype, int causal, float sm_scale,
                      float mask_value, unsigned seed, unsigned drop_thresh,
                      float drop_scale, void* stream) {
  return run(q, k, v, dout, l, m, di, q_seg, kv_seg, nullptr, dk, dv, b, h, sq, skv, d,
             dtype, causal, sm_scale, mask_value, seed, drop_thresh, drop_scale, stream, true);
}

// The same inputs; dq like q.
int tfp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* l, const void* m, const void* di, const void* q_seg,
                     const void* kv_seg, void* dq, int b, int h, int sq, int skv, int d,
                     int dtype, int causal, float sm_scale, float mask_value,
                     unsigned seed, unsigned drop_thresh, float drop_scale, void* stream) {
  return run(q, k, v, dout, l, m, di, q_seg, kv_seg, dq, nullptr, nullptr, b, h, sq, skv, d,
             dtype, causal, sm_scale, mask_value, seed, drop_thresh, drop_scale, stream, false);
}

}  // extern "C"
