// Flash-attention backward on Hopper's tensor cores (sm_90a, wgmma), with a
// plain C interface loaded through ctypes by
// tfplus_tpu_torch/ops/flash_attention.py.
//
// Replaces, for bf16 inputs with head dim D of 64 or 128, the two Pallas
// kernels that _bwd_pallas launches in tfplus_tpu/ops/flash_attention.py:
//   * tfp_flash_bwd_dkv_tc <- _bwd_dkv_kernel (:438, pallas_call :589);
//   * tfp_flash_bwd_dq_tc  <- _bwd_dq_kernel (:504, pallas_call :636).
// f32 and the other widths keep the CUDA-core kernels of flash_bwd.cu,
// whose contract this is: for each (q tile, kv tile) pair, from the
// forward's residuals l (sum of p BEFORE dropout) and m (row max),
//   s  = q k^T * sm_scale + (valid ? 0 : mask_value)   (the mask is ADDED)
//   p  = exp(s - m) / l, and 0 where l == 0 (rows that never hit a key)
//   dp = do v^T, gated by the dropout keep mask and scaled, as is p_d
//   ds = p * (dp - di) * sm_scale,  di = sum(do * o) (computed by the caller)
//   dv += p_d^T do,  dk += ds^T q,  dq += ds k
// with p_d and ds rounded to bf16 before their products, the products
// summed in f32, the keep mask the counter hash of (seed, b, h, row, col)
// bit for bit as in the forward, and tile pairs wholly above the diagonal
// skipped when causal. Every output element is summed by one block in a
// fixed order (no atomics), so a rerun is bit-identical.
//
// Bound on an H100 SXM. dk/dv does four products of 2·D operations per
// valid (row, key) pair, dq three: 68.7 and 51.5 GFLOP at the bench's causal
// bf16 B4 H8 S2048 D128, 69.5 and 52.1 us at the 989 TFLOP/s bf16
// tensor-core rate, so operations bound both.
//
// Design of dk/dv. The transposed orientation, so that keys are wgmma's M dimension
// and nothing goes through shared memory: one warpgroup (128 threads) owns
// 64 keys of one (b, h), their K and V tiles resident in shared memory, and
// loops over the q tiles, whose Q and dO tiles (and l, m, di and segment
// ids) stream through a two-stage cp.async ring in the 128-byte swizzle
// (flash_tc.cuh). Per q tile: S^T = K Q^T and dP^T = V dO^T are D/16 wgmma
// m64n64k16 each (all four tiles K-major); p, p_d and ds are computed on the
// accumulator fragments, with l, m, di indexed by the fragment's column;
// p_d^T and ds^T go to bf16 in registers and are the A operands of 4 wgmma
// m64nDk16 each for dV += P_d^T dO and dK += dS^T Q (dO and Q the MN-major B
// operand, the same shared tiles read the other way). dK and dV stay in
// registers (D/2 + D/2 f32 a thread). When causal, the kv tiles that see the
// most q tiles launch first.
//
// Design of dq, the mirror: q rows are wgmma's M dimension. One warpgroup
// owns 64 q rows of one (b, h), their Q and dO tiles resident in shared
// memory, and loops over the kv tiles, whose K and V tiles (and 64 key
// segment ids) stream through a two-stage cp.async ring in the same
// swizzle. Per kv tile: S = Q K^T and dP = dO V^T are D/16 wgmma m64n64k16
// each (all four tiles K-major); p, the dropout replay and ds are computed
// on the accumulator fragments, with l, m, di indexed by the fragment's row,
// so each thread reads its two rows' l, m, di once, before the loop; dS
// goes to bf16 in registers and is the A operand of 4 wgmma m64nDk16 for
// dQ += dS K (K the MN-major B operand, the same shared tile read the other
// way). dQ stays in registers (D/2 f32 a thread). When causal, kv tiles
// wholly above the diagonal are skipped and the q tiles that see the most
// kv tiles launch first.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;                  // one warpgroup
constexpr int kBQ = 64;                        // query rows per q tile
constexpr int kBK = 64;                        // keys per block
constexpr size_t kMaxSmem = 232448;            // 227 KB per block on an H100

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* l;         // [B, H, Sq]
  const float* m;
  const float* di;
  const int32_t* q_seg;   // [B, Sq] or null (no segments)
  const int32_t* kv_seg;  // [B, Skv] or null
  bf16* dk;               // [B, H, Skv, D] (dk/dv kernel)
  bf16* dv;
  int h, sq, skv, causal;
  float sm_scale, mask_value, drop_scale;
  uint32_t seed, drop_thresh;  // drop_thresh 0: no dropout
  bf16* dq;               // [B, H, Sq, D] (dq kernel)
};

// Shared memory of one block (mirrored by tc_dkv_smem_bytes in
// flash_attention.py): K, V, two stages of Q and dO, two stages of the q
// tile's l, m, di and segment ids, and 1 KB of slack to align the tiles.
template <int D>
struct Layout {
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;         // stage s at kQ + s * kTile
  static constexpr int kDo = 4 * kTile;
  static constexpr int kStats = 6 * kTile;     // stage s at kStats + s * kStage
  static constexpr int kStage = 4 * kBQ * 4;   // l, m, di, q segment ids
  static constexpr int kBytes = kStats + 2 * kStage + 1024;
};

// Shared memory of one dq block (mirrored by tc_dq_smem_bytes in
// flash_attention.py): Q, dO, two stages of K and V, two stages of the key
// segment ids, and 1 KB of slack to align the tiles.
template <int D>
struct DqLayout {
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  static constexpr int kK = 2 * kTile;         // stage s at kK + s * kTile
  static constexpr int kV = 4 * kTile;
  static constexpr int kSeg = 6 * kTile;       // stage s at kSeg + s * kBK * 4
  static constexpr int kBytes = kSeg + 2 * kBK * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const Args a, const int n_kt) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // kv tile 0 sees the most q tiles under causal masking: launched first
  const int kt = static_cast<int>(blockIdx.x % n_kt);
  const int bh = static_cast<int>(blockIdx.x / n_kt);
  const int bi = bh / a.h, hi = bh % a.h;
  const int k0 = kt * kBK;
  const size_t qbase = static_cast<size_t>(bh) * a.sq;
  const size_t kbase = static_cast<size_t>(bh) * a.skv;
  const bool segs = a.kv_seg != nullptr;
  // causal: q tiles whose last row lies above this kv tile's first key skip
  const int q_begin = a.causal ? k0 : 0;
  const int n_q = q_begin < a.sq ? (a.sq - q_begin + kBQ - 1) / kBQ : 0;

  // this thread's two keys and its column offset in every 8-column group
  const int key0 = k0 + 16 * warp + lane / 4, key1 = key0 + 8;
  const int cb = 2 * (lane % 4);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_q > 0) {
    auto load_q = [&](int i) {
      const int q0 = q_begin + i * kBQ, st = i & 1;
      const size_t r0 = qbase + q0;
      tc::load_tile<D, kThreads>(base + L::kQ + st * L::kTile, a.q + r0 * D, a.sq - q0);
      tc::load_tile<D, kThreads>(base + L::kDo + st * L::kTile, a.dout + r0 * D, a.sq - q0);
      const uint32_t stats = base + L::kStats + st * L::kStage;
      tc::load_words<kThreads>(stats, a.l + r0, kBQ, a.sq - q0);
      tc::load_words<kThreads>(stats + kBQ * 4, a.m + r0, kBQ, a.sq - q0);
      tc::load_words<kThreads>(stats + 2 * kBQ * 4, a.di + r0, kBQ, a.sq - q0);
      if (segs) {
        tc::load_words<kThreads>(stats + 3 * kBQ * 4,
                                 a.q_seg + static_cast<size_t>(bi) * a.sq + q0, kBQ,
                                 a.sq - q0);
      }
      tc::cp_async_commit();
    };
    tc::load_tile<D, kThreads>(base + L::kK, a.k + (kbase + k0) * D, a.skv - k0);
    tc::load_tile<D, kThreads>(base + L::kV, a.v + (kbase + k0) * D, a.skv - k0);
    load_q(0);

    int ks0 = 0, ks1 = 0;
    if (segs) {
      const int32_t* ks_g = a.kv_seg + static_cast<size_t>(bi) * a.skv;
      ks0 = key0 < a.skv ? ks_g[key0] : -1;
      ks1 = key1 < a.skv ? ks_g[key1] : -1;
    }
    const uint32_t dbase = tc::drop_base(a.seed, bi, hi);

    for (int i = 0; i < n_q; ++i) {
      const int st = i & 1, q0 = q_begin + i * kBQ;
      tc::cp_async_wait_all();
      tc::fence_proxy_async();
      __syncthreads();          // q tile i landed; everyone is done with i-1
      if (i + 1 < n_q) load_q(i + 1);

      const uint32_t qt = base + L::kQ + st * L::kTile;
      const uint32_t ot = base + L::kDo + st * L::kTile;
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      tc::pin(s);
      tc::pin(dp);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        tc::wgmma_ss_n64(s, tc::desc_kmajor(base + L::kK, kk), tc::desc_kmajor(qt, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        tc::wgmma_ss_n64(dp, tc::desc_kmajor(base + L::kV, kk), tc::desc_kmajor(ot, kk), kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::pin(s);
      tc::pin(dp);

      // element (key, row) of S^T and dP^T: the fragment's row is the key,
      // its column the q row, whose l, m, di come from the stage's stats
      const float* st_l = reinterpret_cast<const float*>(smem + L::kStats + st * L::kStage);
      const float* st_m = st_l + kBQ;
      const float* st_di = st_l + 2 * kBQ;
      const int* st_seg = reinterpret_cast<const int*>(st_l + 3 * kBQ);
      const bool need_mask = segs || (a.causal && q0 < k0 + kBK - 1);
      uint32_t pda[16], dsa[16];
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        const int key = (w & 1) ? key1 : key0;
        const int kseg = (w & 1) ? ks1 : ks0;
        float pd2[2], ds2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = 8 * (w / 2) + cb + u;
          const int row = q0 + c;
          float x = s[2 * w + u] * a.sm_scale;
          if (need_mask) {
            bool ok = !a.causal || key <= row;
            if (segs) {
              const int qs = st_seg[c];
              ok = ok && qs == kseg && qs >= 0 && kseg >= 0;
            }
            if (!ok) x += a.mask_value;
          }
          const float lv = st_l[c];
          const float p = lv == 0.f ? 0.f : __fdividef(exp2f((x - st_m[c]) * tc::kLog2e), lv);
          float pd = p, dpg = dp[2 * w + u];
          if (a.drop_thresh != 0u) {
            const bool kp = tc::keep(dbase, row, key, a.drop_thresh);
            pd = kp ? p * a.drop_scale : 0.f;
            dpg = kp ? dpg * a.drop_scale : 0.f;
          }
          pd2[u] = pd;
          ds2[u] = p * (dpg - st_di[c]) * a.sm_scale;
        }
        pda[w] = tc::pack_bf16(pd2[0], pd2[1]);
        dsa[w] = tc::pack_bf16(ds2[0], ds2[1]);
      }

      tc::pin(dk);
      tc::pin(dv);
      tc::pin(pda);
      tc::pin(dsa);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        if constexpr (D == 128) {
          tc::wgmma_rs_n128(dv, pda + 4 * kk, tc::desc_mnmajor(ot, kk), 1);
        } else {
          tc::wgmma_rs_n64(dv, pda + 4 * kk, tc::desc_mnmajor(ot, kk), 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        if constexpr (D == 128) {
          tc::wgmma_rs_n128(dk, dsa + 4 * kk, tc::desc_mnmajor(qt, kk), 1);
        } else {
          tc::wgmma_rs_n64(dk, dsa + 4 * kk, tc::desc_mnmajor(qt, kk), 1);
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::pin(dk);
      tc::pin(dv);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= a.skv) continue;
    const size_t o = (kbase + key) * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * half;
      *reinterpret_cast<uint32_t*>(a.dk + o + 8 * j) = tc::pack_bf16(dk[e], dk[e + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + o + 8 * j) = tc::pack_bf16(dv[e], dv[e + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const Args a, const int n_qt) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int* kseg = reinterpret_cast<const int*>(smem_raw + (base - raw) + L::kSeg);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the last q tile sees the most kv tiles under causal masking: first
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = qt * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * a.sq;
  const bf16* k = a.k + static_cast<size_t>(bh) * a.skv * D;
  const bf16* v = a.v + static_cast<size_t>(bh) * a.skv * D;
  const int32_t* ks_g = a.kv_seg ? a.kv_seg + static_cast<size_t>(bi) * a.skv : nullptr;
  const bool segs = ks_g != nullptr;
  // causal: kv tiles that start past this q tile's last row are skipped
  const int kv_end = a.causal ? min(a.skv, q0 + kBQ) : a.skv;
  const int n_kt = (kv_end + kBK - 1) / kBK;

  auto load_kv = [&](int t) {
    const int c0 = t * kBK, st = t & 1;
    tc::load_tile<D, kThreads>(base + L::kK + st * L::kTile, k + static_cast<size_t>(c0) * D,
                               a.skv - c0);
    tc::load_tile<D, kThreads>(base + L::kV + st * L::kTile, v + static_cast<size_t>(c0) * D,
                               a.skv - c0);
    if (segs) tc::load_words<kThreads>(base + L::kSeg + st * kBK * 4, ks_g + c0, kBK, a.skv - c0);
    tc::cp_async_commit();
  };
  tc::load_tile<D, kThreads>(base + L::kQ, a.q + (qbase + q0) * D, a.sq - q0);
  tc::load_tile<D, kThreads>(base + L::kDo, a.dout + (qbase + q0) * D, a.sq - q0);
  load_kv(0);

  // this thread's two rows, their l, m, di and segment ids (rows past Sq
  // read l = 0, so p = 0), and its column offset in every 8-column group
  const int row0 = q0 + 16 * warp + lane / 4, row1 = row0 + 8;
  const int cb = 2 * (lane % 4);
  float l0 = 0.f, l1 = 0.f, m0 = 0.f, m1 = 0.f, di0 = 0.f, di1 = 0.f;
  if (row0 < a.sq) {
    l0 = a.l[qbase + row0];
    m0 = a.m[qbase + row0];
    di0 = a.di[qbase + row0];
  }
  if (row1 < a.sq) {
    l1 = a.l[qbase + row1];
    m1 = a.m[qbase + row1];
    di1 = a.di[qbase + row1];
  }
  int qs0 = 0, qs1 = 0;
  if (segs) {
    const int32_t* qs_g = a.q_seg + static_cast<size_t>(bi) * a.sq;
    qs0 = row0 < a.sq ? qs_g[row0] : -1;
    qs1 = row1 < a.sq ? qs_g[row1] : -1;
  }
  const uint32_t dbase = tc::drop_base(a.seed, bi, hi);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1, c0 = t * kBK;
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    __syncthreads();            // kv tile t landed; everyone is done with tile t-1
    if (t + 1 < n_kt) load_kv(t + 1);

    const uint32_t kt = base + L::kK + st * L::kTile;
    const uint32_t vt = base + L::kV + st * L::kTile;
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    tc::pin(s);
    tc::pin(dp);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      tc::wgmma_ss_n64(s, tc::desc_kmajor(base + L::kQ, kk), tc::desc_kmajor(kt, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      tc::wgmma_ss_n64(dp, tc::desc_kmajor(base + L::kDo, kk), tc::desc_kmajor(vt, kk), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::pin(s);
    tc::pin(dp);

    // element (row, key) of S and dP: the fragment's row is this thread's
    // row0 or row1, its column the key
    const bool need_mask = segs || c0 + kBK > a.skv || (a.causal && c0 + kBK - 1 > q0);
    const int* ks = kseg + st * kBK;
    uint32_t dsa[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const bool r1 = w & 1;
      const int row = r1 ? row1 : row0;
      const float lv = r1 ? l1 : l0, mv = r1 ? m1 : m0, dii = r1 ? di1 : di0;
      float ds2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cl = 8 * (w / 2) + cb + u;
        const int col = c0 + cl;
        float x = s[2 * w + u] * a.sm_scale;
        if (need_mask) {
          bool ok = col < a.skv && (!a.causal || col <= row);
          if (segs) {
            const int qs = r1 ? qs1 : qs0, kv = ks[cl];
            ok = ok && qs == kv && qs >= 0 && kv >= 0;
          }
          if (!ok) x += a.mask_value;
        }
        const float p = lv == 0.f ? 0.f : __fdividef(exp2f((x - mv) * tc::kLog2e), lv);
        float dpg = dp[2 * w + u];
        if (a.drop_thresh != 0u) {
          dpg = tc::keep(dbase, row, col, a.drop_thresh) ? dpg * a.drop_scale : 0.f;
        }
        ds2[u] = p * (dpg - dii) * a.sm_scale;
      }
      dsa[w] = tc::pack_bf16(ds2[0], ds2[1]);
    }

    tc::pin(dq);
    tc::pin(dsa);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (D == 128) {
        tc::wgmma_rs_n128(dq, dsa + 4 * kk, tc::desc_mnmajor(kt, kk), 1);
      } else {
        tc::wgmma_rs_n64(dq, dsa + 4 * kk, tc::desc_mnmajor(kt, kk), 1);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::pin(dq);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= a.sq) continue;
    bf16* dst = a.dq + (qbase + row) * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * half;
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = tc::pack_bf16(dq[e], dq[e + 1]);
    }
  }
}

template <typename Kern>
int launch_kernel(Kern kern, int smem, int n_tiles, int batch, const Args& a,
                  cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * a.h * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, stream>>>(a, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int batch, bool dkv, cudaStream_t stream) {
  static_assert(Layout<D>::kBytes <= kMaxSmem && DqLayout<D>::kBytes <= kMaxSmem,
                "the block's shared memory");
  if (dkv) {
    return launch_kernel(flash_bwd_dkv_tc_kernel<D>, Layout<D>::kBytes,
                         (a.skv + kBK - 1) / kBK, batch, a, stream);
  }
  return launch_kernel(flash_bwd_dq_tc_kernel<D>, DqLayout<D>::kBytes,
                       (a.sq + kBQ - 1) / kBQ, batch, a, stream);
}

int run(const void* q, const void* k, const void* v, const void* dout, const void* l,
        const void* m, const void* di, const void* q_seg, const void* kv_seg, void* dq,
        void* dk, void* dv, int b, int h, int sq, int skv, int d, int dtype, int causal,
        float sm_scale, float mask_value, unsigned seed, unsigned drop_thresh,
        float drop_scale, void* stream, bool dkv) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || dtype != 1 || (d != 64 && d != 128) ||
      l == nullptr || m == nullptr || di == nullptr ||
      (q_seg == nullptr) != (kv_seg == nullptr) ||
      (dkv ? (dk == nullptr || dv == nullptr) : dq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.l = static_cast<const float*>(l);
  a.m = static_cast<const float*>(m);
  a.di = static_cast<const float*>(di);
  a.q_seg = static_cast<const int32_t*>(q_seg);
  a.kv_seg = static_cast<const int32_t*>(kv_seg);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dq = static_cast<bf16*>(dq);
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal != 0;
  a.sm_scale = sm_scale;
  a.mask_value = mask_value;
  a.drop_scale = drop_scale;
  a.seed = seed;
  a.drop_thresh = drop_thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 128 ? launch<128>(a, b, dkv, s) : launch<64>(a, b, dkv, s);
}

}  // namespace

extern "C" {

// The signature of tfp_flash_bwd_dkv (flash_bwd.cu): q, do [b,h,sq,d] and
// k, v [b,h,skv,d] bfloat16 (dtype must be 1), d 64 or 128, contiguous and
// 16-byte aligned; l, m, di f32 [b,h,sq]; q_seg [b,sq] / kv_seg [b,skv]
// int32 or both null; dk, dv like k. drop_thresh 0 turns dropout off.
// Returns the cudaError_t of the launch (0 = success).
int tfp_flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                         const void* l, const void* m, const void* di, const void* q_seg,
                         const void* kv_seg, void* dk, void* dv, int b, int h, int sq, int skv,
                         int d, int dtype, int causal, float sm_scale, float mask_value,
                         unsigned seed, unsigned drop_thresh, float drop_scale, void* stream) {
  return run(q, k, v, dout, l, m, di, q_seg, kv_seg, nullptr, dk, dv, b, h, sq, skv, d, dtype,
             causal, sm_scale, mask_value, seed, drop_thresh, drop_scale, stream, true);
}

// The signature of tfp_flash_bwd_dq (flash_bwd.cu), with the inputs above;
// dq like q.
int tfp_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                        const void* l, const void* m, const void* di, const void* q_seg,
                        const void* kv_seg, void* dq, int b, int h, int sq, int skv, int d,
                        int dtype, int causal, float sm_scale, float mask_value,
                        unsigned seed, unsigned drop_thresh, float drop_scale, void* stream) {
  return run(q, k, v, dout, l, m, di, q_seg, kv_seg, dq, nullptr, nullptr, b, h, sq, skv, d,
             dtype, causal, sm_scale, mask_value, seed, drop_thresh, drop_scale, stream, false);
}

}  // extern "C"
