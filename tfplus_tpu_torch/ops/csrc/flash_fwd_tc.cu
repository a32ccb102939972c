// Tiled flash-attention forward on Hopper's tensor cores (sm_90a, wgmma),
// with a plain C interface loaded through ctypes by
// tfplus_tpu_torch/ops/flash_attention.py.
//
// Replaces, for bf16 inputs with head dim D of 64 or 128, the Pallas
// forward _fwd (_fwd_kernel) of tfplus_tpu/ops/flash_attention.py:103-408;
// f32 and the other widths keep the CUDA-core kernel of flash_fwd.cu. The
// contract is that kernel's: for q [B,H,Sq,D], k/v [B,H,Skv,D] bf16,
//   s = q k^T * sm_scale + (valid ? 0 : mask_value), valid = same segment,
//       neither segment < 0, col < Skv, and col <= row when causal;
//   out = softmax(s) v by an online softmax over 64-key tiles, inverted
//       dropout on p from the counter hash of (seed, b, h, row, col) (the
//       JAX _dropout_keep, bit for bit), p rounded to bf16 before pv;
//   l = sum of p BEFORE dropout, m = row max; rows that never hit a valid
//       key write out 0 and l 0.
// The products are bf16 with f32 accumulation, as the JAX kernel feeds the
// TPU's matrix unit (flash_attention.py:135-146, :183-184); the softmax is
// f32. The tensor cores sum q·k in another order than the plain version's
// f32 matmul, so s may differ in its last bits and a p that lies that close
// to a bf16 rounding tie may round the other way (chip_smoke.py allows for
// exactly those). Sq and Skv need not divide the tiles: tiles are
// zero-filled past the end and those keys masked, rows past Sq not stored.
//
// Bound on an H100 SXM. The bench's causal bf16 B4 H8 S2048 D128 does
// 4·D·H·(valid pairs) = 34.4 GFLOP on 67 MB: 35 us at the 989 TFLOP/s bf16
// tensor-core rate, so operations bound it, and only wgmma reaches that
// rate.
//
// Design. One warpgroup (128 threads) owns 64 query rows of one (b, h).
// Q sits in shared memory for the whole block; K and V stream through a
// two-stage cp.async ring of 64-key tiles, each tile in the 128-byte swizzle
// (flash_tc.cuh), so the next tile's load overlaps this tile's products.
// Per tile: S = Q K^T is D/16 wgmma m64n64k16 (Q and K both K-major from
// shared memory, no transpose); the row max and sum run on the accumulator
// fragment (each row lives in one quad of lanes: two xor shuffles), the mask
// and the dropout hash on its global coordinates; p goes to bf16 in
// registers and is the A operand of 4 wgmma m64nDk16 for O += P V (V the
// MN-major B operand), with O rescaled by alpha in its registers. No score
// or p tile goes through shared memory. Under causal masking the tiles
// wholly above the diagonal are skipped, only the tile on the diagonal (and
// a ragged last tile, or any tile with segments) pays for the mask, and the
// heaviest q tiles launch first.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;                  // one warpgroup
constexpr int kBQ = 64;                        // query rows per block
constexpr int kBK = 64;                        // keys per tile
constexpr size_t kMaxSmem = 232448;            // 227 KB per block on an H100

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int32_t* q_seg;   // [B, Sq] or null (no segments)
  const int32_t* kv_seg;  // [B, Skv] or null
  bf16* out;
  float* l;               // [B, H, Sq] or null (no residuals)
  float* m;
  int h, sq, skv, causal;
  float sm_scale, mask_value, drop_scale;
  uint32_t seed, drop_thresh;  // drop_thresh 0: no dropout
};

// Shared memory of one block (mirrored by tc_fwd_smem_bytes in
// flash_attention.py): Q, two stages of K and V, two stages of the key
// segment ids, and 1 KB of slack to align the tiles to 1024 bytes.
template <int D>
struct Layout {
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;             // stage s at kK + s * kTile
  static constexpr int kV = 3 * kTile;
  static constexpr int kSeg = 5 * kTile;       // stage s at kSeg + s * kBK * 4
  static constexpr int kBytes = kSeg + 2 * kBK * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const Args a, const int n_qt) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int* kseg = reinterpret_cast<const int*>(smem_raw + (base - raw) + L::kSeg);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // heaviest q tiles first: under causal masking the last tiles do the most
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int bi = bh / a.h, hi = bh % a.h;
  const int q0 = qt * kBQ;
  const bf16* k = a.k + static_cast<size_t>(bh) * a.skv * D;
  const bf16* v = a.v + static_cast<size_t>(bh) * a.skv * D;
  const int32_t* ks_g = a.kv_seg ? a.kv_seg + static_cast<size_t>(bi) * a.skv : nullptr;
  const bool segs = ks_g != nullptr;
  // causal: tiles that start past this q tile's last row are skipped
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
  tc::load_tile<D, kThreads>(base + L::kQ, a.q + (static_cast<size_t>(bh) * a.sq + q0) * D,
                             a.sq - q0);
  load_kv(0);

  // this thread's two rows and its column offset in every 8-column group
  const int row0 = q0 + 16 * warp + lane / 4, row1 = row0 + 8;
  const int cb = 2 * (lane % 4);
  int qs0 = 0, qs1 = 0;
  if (segs) {
    const int32_t* qs_g = a.q_seg + static_cast<size_t>(bi) * a.sq;
    qs0 = row0 < a.sq ? qs_g[row0] : -1;
    qs1 = row1 < a.sq ? qs_g[row1] : -1;
  }
  const uint32_t dbase = tc::drop_base(a.seed, bi, hi);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -FLT_MAX, m1 = -FLT_MAX, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1, c0 = t * kBK;
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    __syncthreads();            // tile t landed; everyone is done with tile t-1
    if (t + 1 < n_kt) load_kv(t + 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tc::pin(s);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      tc::wgmma_ss_n64(s, tc::desc_kmajor(base + L::kQ, kk),
                       tc::desc_kmajor(base + L::kK + st * L::kTile, kk), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::pin(s);

    // scale, mask (only where a tile can hold an invalid pair), row max
    const bool need_mask = segs || c0 + kBK > a.skv || (a.causal && c0 + kBK - 1 > q0);
    const int* ks = kseg + st * kBK;
    float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * a.sm_scale;
      if (need_mask) {
        const int row = (i & 2) ? row1 : row0;
        const int cl = 8 * (i / 4) + cb + (i & 1);
        const int col = c0 + cl;
        bool ok = col < a.skv && (!a.causal || col <= row);
        if (segs) {
          const int qs = (i & 2) ? qs1 : qs0, kv = ks[cl];
          ok = ok && qs == kv && qs >= 0 && kv >= 0;
        }
        if (!ok) x += a.mask_value;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, tc::quad_max(mx0)), mn1 = fmaxf(m1, tc::quad_max(mx1));
    const float al0 = exp2f((m0 - mn0) * tc::kLog2e), al1 = exp2f((m1 - mn1) * tc::kLog2e);
    m0 = mn0;
    m1 = mn1;

    // p = exp(s - m), summed before dropout, then dropped and rounded to
    // bf16 into the A fragment of the pv product
    uint32_t pa[16];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const bool r1 = w & 1;
      const float mrow = r1 ? mn1 : mn0;
      float p0 = exp2f((s[2 * w] - mrow) * tc::kLog2e);
      float p1 = exp2f((s[2 * w + 1] - mrow) * tc::kLog2e);
      if (r1) { sum1 += p0; sum1 += p1; } else { sum0 += p0; sum0 += p1; }
      if (a.drop_thresh != 0u) {
        const int row = r1 ? row1 : row0;
        const int col = c0 + 8 * (w / 2) + cb;
        p0 = tc::keep(dbase, row, col, a.drop_thresh) ? p0 * a.drop_scale : 0.f;
        p1 = tc::keep(dbase, row, col + 1, a.drop_thresh) ? p1 * a.drop_scale : 0.f;
      }
      pa[w] = tc::pack_bf16(p0, p1);
    }
    l0 = al0 * l0 + tc::quad_sum(sum0);
    l1 = al1 * l1 + tc::quad_sum(sum1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al1 : al0;

    tc::pin(o);
    tc::pin(pa);
    tc::wgmma_fence();
    const uint32_t vt = base + L::kV + st * L::kTile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (D == 128) {
        tc::wgmma_rs_n128(o, pa + 4 * kk, tc::desc_mnmajor(vt, kk), 1);
      } else {
        tc::wgmma_rs_n64(o, pa + 4 * kk, tc::desc_mnmajor(vt, kk), 1);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::pin(o);
  }

  // out = o / l (as the tiled JAX kernel: times 1/l), l and m
  const bool hit0 = m0 > 0.5f * a.mask_value, hit1 = m1 > 0.5f * a.mask_value;
  const float il0 = 1.f / (l0 == 0.f ? 1.f : l0), il1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= a.sq) continue;
    const bool hit = half ? hit1 : hit0;
    const float il = half ? il1 : il0;
    bf16* dst = a.out + (static_cast<size_t>(bh) * a.sq + row) * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = hit ? o[4 * j + 2 * half] * il : 0.f;
      const float x1 = hit ? o[4 * j + 2 * half + 1] * il : 0.f;
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = tc::pack_bf16(x0, x1);
    }
    if (a.l != nullptr && lane % 4 == 0) {
      const size_t r = static_cast<size_t>(bh) * a.sq + row;
      a.l[r] = hit ? (half ? l1 : l0) : 0.f;
      a.m[r] = half ? m1 : m0;
    }
  }
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int n_qt = (a.sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(batch) * a.h * n_qt;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<D>::kBytes;
  static_assert(smem <= kMaxSmem, "the block's shared memory");
  auto kern = flash_fwd_tc_kernel<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, stream>>>(a, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The signature of tfp_flash_fwd (flash_fwd.cu): q [b,h,sq,d], k/v
// [b,h,skv,d] bfloat16 (dtype must be 1), d 64 or 128, 16-byte aligned and
// contiguous; q_seg [b,sq] / kv_seg [b,skv] int32 or both null; out like q;
// l, m f32 [b,h,sq] or both null. drop_thresh 0 turns dropout off. Returns
// the cudaError_t of the launch (0 = success).
int tfp_flash_fwd_tc(const void* q, const void* k, const void* v, const void* q_seg,
                     const void* kv_seg, void* out, void* l, void* m, int b, int h, int sq,
                     int skv, int d, int dtype, int causal, float sm_scale, float mask_value,
                     unsigned seed, unsigned drop_thresh, float drop_scale, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || skv <= 0 || dtype != 1 || (d != 64 && d != 128) ||
      (l == nullptr) != (m == nullptr) || (q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.q_seg = static_cast<const int32_t*>(q_seg);
  a.kv_seg = static_cast<const int32_t*>(kv_seg);
  a.out = static_cast<bf16*>(out);
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
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
  return d == 128 ? launch<128>(a, b, s) : launch<64>(a, b, s);
}

}  // extern "C"
