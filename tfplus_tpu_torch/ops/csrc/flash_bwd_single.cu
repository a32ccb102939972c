// Flash-attention backward for a KV that fits one block (Hopper, sm_90a):
// dq, dk and dv in one launch, skipping padding, with a plain C interface
// loaded through ctypes by tfplus_tpu_torch/ops/flash_attention.py
// (flash_bwd_single).
//
// Replaces both Pallas backward kernels that _bwd_pallas launches in
// tfplus_tpu/ops/flash_attention.py, _bwd_dkv_kernel (:438, pallas_call
// :589) and _bwd_dq_kernel (:504, pallas_call :636), wherever the forward
// took the single-pass kernel (not causal, single_fits) and the dtype and
// head dim keep the CUDA cores (flash_route "cuda_core"). It computes what
// they compute, under the contract of flash_bwd.cu:
//   s  = q k^T * sm_scale + (valid ? 0 : mask_value)   (the mask is ADDED)
//   p  = exp(s - m) / l, and 0 where l == 0
//   dp = do v^T, gated by the dropout keep mask and scaled, as is p_d
//   ds = p * (dp - di) * sm_scale
//   dv = p_d^T do,  dk = ds^T q,  dq = ds k
// with p_d and ds rounded to q's type before their products, which sum in
// f32, and the keep mask the counter hash of (seed, b, h, global row,
// global col) bit for bit. Valid = same segment, neither segment < 0. Sq
// need not equal Skv. D is a multiple of 8 up to 128 (the wrapper zero-pads
// other widths); the wrapper's single_fits bounds Skv, and
// single_bwd_smem_bytes mirrors the layout below.
//
// Bound on an H100 SXM. At BST's heads (f32 B2048 H8 S128 D8, about 11 of
// 128 tokens valid) the work is 10·D operations per valid (row, key) pair,
// about 0.2 GFLOP (3 us at 67 TFLOP/s f32), on about 229 MB: the valid rows
// of q, do, k and v, the l, m and di of the valid rows and the segment ids
// read once, and all of dq, dk and dv written once (201 MB, nearly all of
// it zeros on padding). Bytes bound it: about 68 us at 3.35 TB/s. The two
// CUDA-core kernels of flash_bwd.cu read every padded row and key and form
// s and dp twice per pair, once in each kernel.
//
// Design. Padding is skipped exactly. A row whose segment id is < 0 hits no
// key, so the forward stored l = 0 for it and the contract gives it p = 0.
// A key whose segment id is < 0 scores about mask_value on every row, so
// exp(s - m) is exactly 0 in f32 on every row with l > 0. Neither adds
// anything to any output (up to the sign of a zero). So a block lists the
// other rows and keys, in order, by a warp ballot over the segment ids,
// keeping each one's global position (for the dropout hash and the stores),
// loads only those, and writes zeros to the gradients of the rest. A listed
// row whose segment meets no key has l = 0 and computes p = 0: l is read
// with the row's q and do, so testing it costs no extra round trip.
// One block of 128 threads owns one (b, h), so nothing is summed across
// blocks: the listed keys' K and V stay in shared memory beside f32 dk and
// dv accumulators; the listed rows pass in chunks of kRC, each against the
// listed keys in blocks of kKC. Per chunk and key block, one warp per row
// and one lane per key form s and dp once into p_d and ds tiles; then
// threads that own (key, 4 columns) add p_d^T dO and ds^T Q to dv and dk,
// and threads that own (row, 4 columns) add ds K to the chunk's dq, which
// is stored when the chunk is done. Every output element is summed by one
// thread in one order, with no atomics, so reruns are bit-identical. Loads
// go through cp.async, and the zero stores are issued while they are in
// flight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "flash_tc.cuh"   // cp.async and the dropout hash

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = kThreads;      // rows (or keys) one ballot pass lists
constexpr int kRC = 32;              // listed rows per chunk
constexpr int kKC = 32;              // listed keys per key block (one per lane)
constexpr int kLdt = kKC + 1;        // f32 stride of the p_d and ds tiles
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on an H100
constexpr size_t kDefaultSmem = 48 * 1024;

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
  void* dq;               // [B, H, Sq, D]
  void* dk;               // [B, H, Skv, D]
  void* dv;
  int h, sq, skv, d;
  float sm_scale, mask_value, drop_scale;
  uint32_t seed, drop_thresh;  // drop_thresh 0: no dropout
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of one block's shared memory (mirrored by
// single_bwd_smem_bytes in flash_attention.py): the listed keys' K and V
// (their own type, rows padded by 16 bytes) and f32 dk, dv accumulators;
// the chunk's Q and dO rows and f32 dq; the p_d and ds tiles; the chunk
// rows' l, m, di, segment and global row; the scan window's listed rows and
// flags; the listed keys' global index and segment, and each key's slot.
struct Smem {
  size_t k, v, dk, dv, q, dout, dq, pd, ds, rl, rm, rdi, rseg, rrow, wrow, wflag, kidx,
      kseg, kslot, counts, total;
  int ld;
};

__host__ __device__ inline Smem smem_layout(int d, int skv, int esz) {
  Smem s;
  s.ld = d + 16 / esz;
  const size_t kv_rows = static_cast<size_t>(skv) * s.ld * esz;
  const size_t q_rows = static_cast<size_t>(kRC) * s.ld * esz;
  const size_t tile = static_cast<size_t>(kRC) * kLdt * 4;
  s.k = 0;
  s.v = align16(s.k + kv_rows);
  s.dk = align16(s.v + kv_rows);
  s.dv = align16(s.dk + static_cast<size_t>(skv) * d * 4);
  s.q = align16(s.dv + static_cast<size_t>(skv) * d * 4);
  s.dout = align16(s.q + q_rows);
  s.dq = align16(s.dout + q_rows);
  s.pd = align16(s.dq + static_cast<size_t>(kRC) * d * 4);
  s.ds = align16(s.pd + tile);
  s.rl = align16(s.ds + tile);
  s.rm = s.rl + kRC * 4;
  s.rdi = s.rm + kRC * 4;
  s.rseg = s.rdi + kRC * 4;
  s.rrow = s.rseg + kRC * 4;
  s.wrow = s.rrow + kRC * 4;
  s.wflag = s.wrow + kScan * 4;
  s.kidx = s.wflag + kScan * 4;
  s.kseg = s.kidx + static_cast<size_t>(skv) * 4;
  s.kslot = s.kseg + static_cast<size_t>(skv) * 4;
  s.counts = s.kslot + static_cast<size_t>(skv) * 4;
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

// A value as its product takes it: rounded to q's type.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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

// n rows of `pieces` 16-byte pieces from global rows idx[i] (row stride
// `stride` bytes) into shared rows of `ld_bytes`, asynchronously.
__device__ __forceinline__ void gather_rows(unsigned char* dst, int ld_bytes,
                                            const unsigned char* src, size_t stride,
                                            const int* idx, int n, int pieces) {
  for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
    const int r = i / pieces, p = i - r * pieces;
    tc::cp_async16(tc::smem_u32(dst + r * ld_bytes + p * 16),
                   src + static_cast<size_t>(idx[r]) * stride + p * 16, 16);
  }
}

// Zeros into the rows [0, n) of a [n, pieces x 16 bytes] output whose
// flag (1 = listed) is 0.
__device__ __forceinline__ void zero_unlisted(unsigned char* out, const int* listed, int n,
                                              int pieces) {
  for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
    const int r = i / pieces;
    if (!listed[r]) {
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(r) * pieces + (i - r * pieces)) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_single_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(a.d, a.skv, sizeof(T));
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* dKa = reinterpret_cast<float*>(smem + L.dk);
  float* dVa = reinterpret_cast<float*>(smem + L.dv);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Os = reinterpret_cast<T*>(smem + L.dout);
  float* dQa = reinterpret_cast<float*>(smem + L.dq);
  float* Pd = reinterpret_cast<float*>(smem + L.pd);
  float* dS = reinterpret_cast<float*>(smem + L.ds);
  float* rl = reinterpret_cast<float*>(smem + L.rl);
  float* rm = reinterpret_cast<float*>(smem + L.rm);
  float* rdi = reinterpret_cast<float*>(smem + L.rdi);
  int* rseg = reinterpret_cast<int*>(smem + L.rseg);
  int* rrow = reinterpret_cast<int*>(smem + L.rrow);
  int* wrow = reinterpret_cast<int*>(smem + L.wrow);
  int* wflag = reinterpret_cast<int*>(smem + L.wflag);
  int* kidx = reinterpret_cast<int*>(smem + L.kidx);
  int* kseg = reinterpret_cast<int*>(smem + L.kseg);
  int* kslot = reinterpret_cast<int*>(smem + L.kslot);
  int* counts = reinterpret_cast<int*>(smem + L.counts);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h;
  const int d = a.d, ld = L.ld, q4 = d / 4;
  const int ld_bytes = ld * static_cast<int>(sizeof(T));
  const int pieces = d * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces per row
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const size_t qbase = static_cast<size_t>(bh) * a.sq;
  const size_t kbase = static_cast<size_t>(bh) * a.skv;
  const int32_t* qs_g = a.q_seg ? a.q_seg + static_cast<size_t>(bi) * a.sq : nullptr;
  const int32_t* ks_g = a.kv_seg ? a.kv_seg + static_cast<size_t>(bi) * a.skv : nullptr;
  // the first scan window's row segment ids, read beside the keys'
  const int seg0 = tid < a.sq ? (qs_g ? qs_g[tid] : 0) : -1;

  // list the keys that are not padding; their K and V rows, asynchronously
  int nk = 0;
  for (int c0 = 0; c0 < a.skv; c0 += kScan) {
    const int c = c0 + tid;
    const int seg = c < a.skv ? (ks_g ? ks_g[c] : 0) : -1;
    int n;
    const int at = list_place(seg >= 0, counts, n);
    if (c < a.skv) kslot[c] = at < 0 ? -1 : nk + at;
    if (at >= 0) {
      kidx[nk + at] = c;
      kseg[nk + at] = seg;
    }
    nk += n;
  }
  __syncthreads();
  gather_rows(reinterpret_cast<unsigned char*>(Ks), ld_bytes,
              static_cast<const unsigned char*>(a.k) + kbase * row_bytes, row_bytes, kidx, nk,
              pieces);
  gather_rows(reinterpret_cast<unsigned char*>(Vs), ld_bytes,
              static_cast<const unsigned char*>(a.v) + kbase * row_bytes, row_bytes, kidx, nk,
              pieces);
  tc::cp_async_commit();
  for (int i = tid; i < nk * d; i += kThreads) dKa[i] = dVa[i] = 0.f;
  unsigned char* dk_out = static_cast<unsigned char*>(a.dk) + kbase * row_bytes;
  unsigned char* dv_out = static_cast<unsigned char*>(a.dv) + kbase * row_bytes;
  for (int i = tid; i < a.skv * pieces; i += kThreads) {
    const int c = i / pieces;
    if (kslot[c] < 0) {
      const size_t o = static_cast<size_t>(i) * 16;
      *reinterpret_cast<uint4*>(dk_out + o) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv_out + o) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const uint32_t base = tc::drop_base(a.seed, bi, hi);
  T* dq_g = static_cast<T*>(a.dq) + qbase * d;
  const unsigned char* q_g = static_cast<const unsigned char*>(a.q) + qbase * row_bytes;
  const unsigned char* o_g = static_cast<const unsigned char*>(a.dout) + qbase * row_bytes;

  for (int r0 = 0; r0 < a.sq; r0 += kScan) {
    // list this window's rows that are not padding
    const int r = r0 + tid;
    const int seg = r0 == 0 ? seg0 : (r < a.sq ? (qs_g ? qs_g[r] : 0) : -1);
    int nr;
    const int at = list_place(seg >= 0, counts, nr);
    wflag[tid] = at >= 0;
    if (at >= 0) wrow[at] = r;
    __syncthreads();
    const int rows = min(kScan, a.sq - r0);

    for (int c0 = 0; c0 < nr; c0 += kRC) {
      const int cr = min(kRC, nr - c0);
      gather_rows(reinterpret_cast<unsigned char*>(Qs), ld_bytes, q_g, row_bytes,
                  wrow + c0, cr, pieces);
      gather_rows(reinterpret_cast<unsigned char*>(Os), ld_bytes, o_g, row_bytes,
                  wrow + c0, cr, pieces);
      tc::cp_async_commit();
      float l_r = 0.f, m_r = 0.f, di_r = 0.f;
      int seg_r = 0, row = 0;
      if (tid < cr) {
        row = wrow[c0 + tid];
        l_r = __ldg(a.l + qbase + row);
        m_r = __ldg(a.m + qbase + row);
        di_r = __ldg(a.di + qbase + row);
        seg_r = qs_g ? __ldg(qs_g + row) : 0;
      }
      if (c0 == 0) {  // the window's padding rows get zero dq meanwhile
        zero_unlisted(reinterpret_cast<unsigned char*>(dq_g + static_cast<size_t>(r0) * d),
                      wflag, rows, pieces);
      }
      if (tid < cr) {
        rl[tid] = l_r;
        rm[tid] = m_r;
        rdi[tid] = di_r;
        rseg[tid] = seg_r;
        rrow[tid] = row;
      }
      tc::cp_async_wait_all();
      __syncthreads();

      for (int j0 = 0; j0 < nk; j0 += kKC) {
        const int ck = min(kKC, nk - j0);
        // p_d and ds of (row i, key j0 + lane): s and dp once per pair
        if (lane < ck) {
          const int j = j0 + lane;
          const T* kr = Ks + j * ld;
          const T* vr = Vs + j * ld;
          const int ks = kseg[j], col = kidx[j];
          for (int i = warp; i < cr; i += kWarps) {
            const T* qr = Qs + i * ld;
            const T* orow = Os + i * ld;
            float s = 0.f, dp = 0.f;
            for (int dd = 0; dd < d; dd += 4) {
              s = dot4(load4(qr + dd), load4(kr + dd), s);
              dp = dot4(load4(orow + dd), load4(vr + dd), dp);
            }
            float x = s * a.sm_scale;
            if (rseg[i] != ks) x += a.mask_value;
            const float li = rl[i];
            const float p = li == 0.f ? 0.f : expf(x - rm[i]) / li;
            float pd = p, dpg = dp;
            if (a.drop_thresh != 0u) {
              const bool kp = tc::keep(base, rrow[i], col, a.drop_thresh);
              pd = kp ? p * a.drop_scale : 0.f;
              dpg = kp ? dpg * a.drop_scale : 0.f;
            }
            Pd[i * kLdt + lane] = round_to<T>(pd);
            dS[i * kLdt + lane] = round_to<T>(p * (dpg - rdi[i]) * a.sm_scale);
          }
        }
        __syncthreads();
        // dv[key] += sum_i p_d[i][key] dO[i]; dk[key] += sum_i ds[i][key] Q[i]
        for (int e = tid; e < ck * q4; e += kThreads) {
          const int j = e / q4, c = (e - j * q4) * 4;
          float* ka = dKa + (j0 + j) * d + c;
          float* va = dVa + (j0 + j) * d + c;
          float4 ak = load4(ka), av = load4(va);
          for (int i = 0; i < cr; ++i) {
            fma4(ak, dS[i * kLdt + j], load4(Qs + i * ld + c));
            fma4(av, Pd[i * kLdt + j], load4(Os + i * ld + c));
          }
          store4(ka, ak);
          store4(va, av);
        }
        // dq[i] += sum_key ds[i][key] K[key]
        for (int e = tid; e < cr * q4; e += kThreads) {
          const int i = e / q4, c = (e - i * q4) * 4;
          float4 acc = j0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : load4(dQa + i * d + c);
          for (int j = 0; j < ck; ++j) fma4(acc, dS[i * kLdt + j], load4(Ks + (j0 + j) * ld + c));
          store4(dQa + i * d + c, acc);
        }
        __syncthreads();
      }
      // the chunk's dq rows (zeros when no key is listed)
      for (int e = tid; e < cr * q4; e += kThreads) {
        const int i = e / q4, c = (e - i * q4) * 4;
        const float4 x = nk > 0 ? load4(dQa + i * d + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        store4(dq_g + static_cast<size_t>(rrow[i]) * d + c, x);
      }
      __syncthreads();  // the next chunk rewrites Qs, Os, dQa and the row stats
    }
    if (nr == 0) {
      zero_unlisted(reinterpret_cast<unsigned char*>(dq_g + static_cast<size_t>(r0) * d), wflag,
                    rows, pieces);
    }
    __syncthreads();  // the next window rewrites wrow and wflag
  }

  // the listed keys' dk and dv
  tc::cp_async_wait_all();  // K and V, where no row was listed
  __syncthreads();
  T* dk_g = static_cast<T*>(a.dk) + kbase * d;
  T* dv_g = static_cast<T*>(a.dv) + kbase * d;
  for (int e = tid; e < nk * q4; e += kThreads) {
    const int j = e / q4, c = (e - j * q4) * 4;
    const size_t o = static_cast<size_t>(kidx[j]) * d + c;
    store4(dk_g + o, load4(dKa + j * d + c));
    store4(dv_g + o, load4(dVa + j * d + c));
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * a.h;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Smem L = smem_layout(a.d, a.skv, sizeof(T));
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_single_kernel<T>;
  if (L.total > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, do [b,h,sq,d] and k, v [b,h,skv,d] of dtype (0 = float32, 1 = bfloat16),
// d a multiple of 8 up to 128, contiguous, 16-byte aligned; l, m, di f32
// [b,h,sq] from the forward; q_seg [b,sq] / kv_seg [b,skv] int32 or both
// null; dq like q, dk and dv like k. Not causal. drop_thresh 0 turns dropout
// off. Returns the cudaError_t of the launch (0 = success).
int tfp_flash_bwd_single(const void* q, const void* k, const void* v, const void* dout,
                         const void* l, const void* m, const void* di, const void* q_seg,
                         const void* kv_seg, void* dq, void* dk, void* dv, int b, int h,
                         int sq, int skv, int d, int dtype, float sm_scale, float mask_value,
                         unsigned seed, unsigned drop_thresh, float drop_scale, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || d < 8 || d % 8 != 0 || d > 128 ||
      l == nullptr || m == nullptr || di == nullptr || dq == nullptr || dk == nullptr ||
      dv == nullptr || (q_seg == nullptr) != (kv_seg == nullptr)) {
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
  a.sm_scale = sm_scale;
  a.mask_value = mask_value;
  a.drop_scale = drop_scale;
  a.seed = seed;
  a.drop_thresh = drop_thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of shared memory one block takes at (d, skv, dtype): the layout
// that single_bwd_smem_bytes in flash_attention.py mirrors.
long long tfp_flash_bwd_single_smem(int d, int skv, int dtype) {
  return static_cast<long long>(smem_layout(d, skv, dtype == 0 ? 4 : 2).total);
}

}  // extern "C"
