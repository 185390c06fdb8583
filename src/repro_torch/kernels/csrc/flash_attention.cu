// Flash attention, forward, on Hopper (sm_90a).
//
// Replaces two TPU kernels and computes what they compute:
//   - flash_attention / _kernel of src/repro/kernels/flash_attention.py
//     (serving), and
//   - flash_attention_fwd_lse / _fwd_kernel of
//     src/repro/kernels/flash_attention_bwd.py (training: it also writes
//     each row's logsumexp, the one residual the backward kernels of
//     flash_attention_bwd.cu keep).
// Both go through the entry points below; lse is written where its
// pointer is not null.
//   o[b,h,s] = softmax_t(q[b,h,s] . k[b,h//g,t] / sqrt(D), masked) @ v[b,h//g]
// with GQA through the head index (K and V are never expanded), the masks
// t < T, causal t <= q_offset + s and window q_offset + s - t < window,
// float32 running max, denominator and accumulator, P cast to the input
// type before P.V, and the output in the input type.
//
// The TPU kernel walks the KV tiles as the sequential grid axis and keeps
// (m, l, acc) in VMEM scratch across it; here each block (or work item)
// walks its KV tiles in a loop and keeps them in registers.  Tiles that
// the masks leave empty for every row of the block are not visited (the
// TPU kernel runs them masked; the result is the same).  Three kernels,
// chosen by the wrapper (kernels/flash_attention.py, route):
//   - flash_fwd_hopper (bf16, head_dim 64 or 128, every tensor TMA can
//     address: the serving and training paths).  Persistent: one block of
//     three warpgroups per SM walks work items of 128 query rows of one
//     (batch, head), those with the most key tiles first.  Warpgroup 0 is
//     the producer: its first thread loads each item's Q into one of two
//     buffers and K and V tiles of 128 keys into a ring of stages (4 at
//     head_dim 64, 2 at 128), all by TMA with the 128-byte swizzle, each
//     load completing on a "full" mbarrier and each buffer freed by an
//     "empty" one.  Warpgroups 1 and 2 consume 64 rows each: S = Q.K^T as
//     wgmma m64n128k16 from shared memory (Q and K K-major), the online
//     softmax in float32 in base 2 (the running max in scale.log2(e)
//     units, one FFMA and one ex2.approx per score, the mask only on tiles
//     that cross the causal diagonal, the window's edge or T), P rounded
//     to bf16 in registers (the accumulator layout of S is the A layout of
//     the next product), and O += P.V as wgmma with A from registers and V
//     as a transposed (MN-major) B from shared memory.  Each tile's S
//     product is issued with the last tile's P.V, so the softmax runs
//     while the tensor cores finish P.V.  setmaxnreg moves registers from
//     the producer to the consumers.
//   - flash_fwd_bf16 (other bf16 inputs: head_dim 16, 20 or 32 in the
//     sweeps and the smoke config, strides TMA refuses): 64 query rows a
//     block, 4 warps of mma.sync.m16n8k16, each owning 16 rows, with K and
//     V loaded by plain loads (16 bytes a thread where they allow) and
//     head_dim padded with zeros to 32, 64 or 128 in shared memory.
//   - flash_fwd_f32 (float32: tests and the card-against-CPU checks): the
//     same tiling on CUDA cores, each thread owning 4 rows x 8 key columns
//     of S and 4 rows x D/8 columns of the output, in full float32.
//
// lse[b*H + h, s] = m + log(l), the row's max scaled score plus the log of
// its softmax denominator, natural-log units, in float32, written once per
// row after the KV loop.  All three are deterministic (no split over keys,
// no atomics), so a recomputation under activation checkpointing gives
// the same bits.  A row with no valid key (never on the model's paths:
// causal rows see themselves) returns zeros and lse = -inf: its running
// denominator stays 0 and masked scores add nothing.  The backward kernels
// give such a row zero gradients (every pair it has is masked).  The TPU
// kernels return the mean of V over the keys of the tiles they ran there,
// and their oracle the mean of V over all keys.
//
// Bound at the serving path's prefill shape, q (8, 15, 512, 64) and k/v
// (8, 5, 512, 64) bf16, causal: it must read q, k, v and write o once,
// 20.97 MB, which takes 6.26 us at 3.35 TB/s; the 131,328 causal pairs per
// head cost 4 * 8 * 15 * 64 * 131,328 = 4.03 GFLOP, 4.08 us at 989 TFLOP/s
// of bf16 tensor cores (H100 SXM data sheet, 700 W).  So bytes bound it.
// At the training shape, q (4, 15, 2048, 64) and k/v (4, 5, 2048, 64)
// bf16, causal, the 2,098,176 pairs per head cost 32.2 GFLOP (32.6 us)
// against 42.4 MB of bytes (12.7 us): operations bound it there, which is
// why the Hopper kernel feeds wgmma from a TMA ring rather than loading
// tiles through registers.  At head_dim 64 the exponentials come close
// too: one ex2 per visible pair, 126 M of them, take 30.1 us at 16 a clock
// on each of 132 SMs at 1,980 MHz, so the softmax's instructions count as
// much as the products'.
//
// Plain C entry points, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B*H, S) float32, or null (serving)
  int B, H, Hkv, S, T, D;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_ss;
  int causal;
  int has_window;
  int64_t window;
  int64_t q_offset;
  float scale;
};

// The range [k_begin, k_end) of keys that some row of the query tile
// [q0, q0 + rows) may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* k_begin, int* k_end,
                                          int rows = kBlockQ) {
  const int64_t qa_lo = p.q_offset + q0;
  const int64_t qa_hi = p.q_offset + min(q0 + rows, p.S) - 1;
  int64_t lo = 0, hi = p.T;
  if (p.causal && qa_hi + 1 < hi) hi = qa_hi + 1;
  if (p.has_window && qa_lo - p.window + 1 > lo) lo = qa_lo - p.window + 1;
  if (hi <= lo) lo = hi = 0;  // no row sees a key: visit no tile
  *k_begin = static_cast<int>(lo);
  *k_end = static_cast<int>(hi);
}

__device__ __forceinline__ bool visible(const Params& p, int64_t qpos, int kpos) {
  bool ok = kpos < p.T;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.has_window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// lse of one row: -inf where the row saw no key (l == 0)
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : -CUDART_INF_F;
}

// ----------------------------------------------------------------- bf16
template <int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int kLd = kD + 8;  // +16 bytes a row: the fragment loads hit distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * kLd;
  __nv_bfloat16* Vs = Ks + kBlockK * kLd;

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int row0 = warp * 16 + g;        // this thread's rows: row0 and row0 + 8

  load_tile_bf16<kD>(Qs, q, p.q_ss, q0, p.S, p.D);
  __syncthreads();
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) load_a_frag(qa[kk], Qs, kLd, warp * 16, kk * 16, g, t);

  float oacc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) oacc[nd][0] = oacc[nd][1] = oacc[nd][2] = oacc[nd][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int64_t qpos[2] = {p.q_offset + q0 + row0, p.q_offset + q0 + row0 + 8};

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<kD>(Ks, k, p.k_st, k0, p.T, p.D);
    load_tile_bf16<kD>(Vs, v, p.v_st, k0, p.T, p.D);
    __syncthreads();

    // S = Q K^T: 8 blocks of 8 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    mma_rows<kD>(s, qa, Ks, g, t);

    // scale, mask, online softmax; each row's 64 scores live in 4 lanes
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + nb * 8 + 2 * t + e;
          float& x = s[nb][2 * ri + e];
          x = visible(p, qpos[ri], kpos) ? x * p.scale : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[ri], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[ri] = expf(m[ri] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * ri + e];
          x = expf(x - m_use);  // a masked score is -inf: 0
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[ri] = l[ri] * alpha[ri] + sum;
      m[ri] = m_new;
    }
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      oacc[nd][0] *= alpha[0];
      oacc[nd][1] *= alpha[0];
      oacc[nd][2] *= alpha[1];
      oacc[nd][3] *= alpha[1];
    }

    // O += P V: P in bf16 from the S fragments, 4 slices of 16 keys
    mma_cols<kD>(oacc, s, Vs, g, t);
  }

  // o = acc / l, in bf16; lse from lane t == 0 of each row's quad
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = q0 + row0 + 8 * ri;
    if (r >= p.S) continue;
    const float inv = 1.f / fmaxf(l[ri], 1e-30f);
    __nv_bfloat16* orow = o + r * p.o_ss;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * t + e;
        if (d < p.D) orow[d] = __float2bfloat16(oacc[nd][2 * ri + e] * inv);
      }
    }
    if (p.lse != nullptr && t == 0) p.lse[int64_t(blockIdx.y) * p.S + r] = row_lse(m[ri], l[ri]);
  }
}

// ----------------------------------------------------------------- f32
template <int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int kLd = kD + 1;  // odd stride: a column walk hits distinct banks
  constexpr int kDj = kD / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBlockQ * kLd;
  float* Vs = Ks + kBlockK * kLd;
  float* Ps = Vs + kBlockK * kLd;  // (64, 65)

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // thread (ty, tx): rows 4*ty + i, score columns tx + 8*j, output columns tx + 8*j
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  load_tile_f32<kD>(Qs, q, p.q_ss, q0, p.S, p.D);

  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -CUDART_INF_F, l[i] = 0.f;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    load_tile_f32<kD>(Ks, k, p.k_st, k0, p.T, p.D);
    load_tile_f32<kD>(Vs, v, p.v_st, k0, p.T, p.D);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = p.q_offset + q0 + 4 * ty + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = visible(p, qpos, k0 + tx + 8 * j) ? s[i][j] * p.scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - m_use);
        sum += e;
        Ps[(4 * ty + i) * 65 + tx + 8 * j] = e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDj; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float vv[kDj];
#pragma unroll
      for (int j = 0; j < kDj; ++j) vv[j] = Vs[c * kLd + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = Ps[(4 * ty + i) * 65 + c];
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      const int d = tx + 8 * j;
      if (d < p.D) o[r * p.o_ss + d] = acc[i][j] * inv;
    }
    if (p.lse != nullptr && tx == 0) p.lse[int64_t(blockIdx.y) * p.S + r] = row_lse(m[i], l[i]);
  }
}

// --------------------------------------------------------------- Hopper
namespace fwd_hopper {

constexpr int kBlockM = 128;   // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;   // keys per tile
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kRowBytes = 128; // one swizzled row: 64 bf16 values
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
constexpr int64_t kMaxItems = int64_t(1) << 30;  // item indices stay in int

// Shared memory: two Q buffers (each kD / 64 panels of 128 rows) | K
// stages | V stages | barriers.  Each panel is rows of 128 bytes; every
// piece starts on a 1,024-byte boundary.  The second Q buffer lets the
// producer load the next item's Q and tiles while the consumers finish
// the last.  At least 116 KB, so that one block holds an SM and
// setmaxnreg's hand-over of registers has them to give.
template <int kD>
struct Layout {
  static constexpr int kPanels = kD / 64;
  static constexpr int kStages = kD == 64 ? 4 : 2;
  static constexpr int kQBytes = kBlockM * kD * 2;
  static constexpr int kTileBytes = kBlockN * kD * 2;  // one K or V tile
  static constexpr int kQPanel = kBlockM * kRowBytes;
  static constexpr int kKVPanel = kBlockN * kRowBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBars = 4 + 3 * kStages;  // Q full, free; K full, V full, free
  static constexpr int kSmem = kBar + 8 * kBars + 1024;  // + the base's alignment
  static_assert(kSmem > 116 * 1024 && kSmem <= 227 * 1024, "one block per SM");
};

template <int kD>
__device__ __forceinline__ void pv(float (&o)[kD / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_m64n64k16_rs_tb(o, a, db);
}
template <>
__device__ __forceinline__ void pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_m64n128k16_rs_tb(o, a, db);
}

__host__ __device__ __forceinline__ int64_t work_items(const Params& p) {
  return int64_t((p.S + kBlockM - 1) / kBlockM) * p.B * p.H;
}

// One work item: 128 query rows of one (batch, head) and the key tiles
// they see.  Item w is query tile n_q - 1 - w / (B H), the longest key
// walks first, of batch x head w % (B H).
struct Work {
  int q0, b, h, hk, kt0, n_tiles;
};

__device__ __forceinline__ Work work_item(const Params& p, int w) {
  const int bh = w % (p.B * p.H), n_q = (p.S + kBlockM - 1) / kBlockM;
  Work wk;
  wk.q0 = (n_q - 1 - w / (p.B * p.H)) * kBlockM;
  wk.b = bh / p.H;
  wk.h = bh % p.H;
  wk.hk = wk.h / (p.H / p.Hkv);
  int k_begin, k_end;
  key_range(p, wk.q0, &k_begin, &k_end, kBlockM);
  wk.kt0 = (k_begin / kBlockN) * kBlockN;
  wk.n_tiles = k_end > k_begin ? (k_end - wk.kt0 + kBlockN - 1) / kBlockN : 0;
  return wk;
}

// Persistent: one block per SM walks its items; the producer loads the next
// item's Q and tiles while the consumers finish the last.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<kD>;
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t base = (smem_u32(hopper_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  // barriers: per Q buffer Q full, Q free; per stage K full, V full, stage free
  const uint32_t bar_q = base + L::kBar, bar_qe = bar_q + 16;
  const uint32_t bar_k = bar_qe + 16, bar_v = bar_k + 8 * L::kStages;
  const uint32_t bar_e = bar_v + 8 * L::kStages;
  const int n_items = static_cast<int>(work_items(p));

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(bar_q + 8 * qb, 1);
      mbar_init(bar_qe + 8 * qb, 2 * 128);  // every consumer thread frees Q and the stages
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      int it = 0, qn = 0;  // tiles and Q loads so far: the ring's and Q's phases
      for (int r = 0, w; (w = item_of_round(r)) < n_items; ++r) {
        const Work wk = work_item(p, w);
        if (wk.n_tiles == 0) continue;
        const int qb = qn & 1;  // Q buffer
        mbar_wait(bar_qe + 8 * qb, ((qn >> 1) & 1) ^ 1);  // each buffer's first round is free
        ++qn;
        mbar_expect_tx(bar_q + 8 * qb, L::kQBytes);
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn)
          tma_load_4d(sQ + qb * L::kQBytes + pn * L::kQPanel, &tm_q, bar_q + 8 * qb, 64 * pn,
                      wk.q0, wk.h, wk.b);
        for (int i = 0; i < wk.n_tiles; ++i, ++it) {
          const int s = it % L::kStages;
          const int k0 = wk.kt0 + i * kBlockN;
          mbar_wait(bar_e + 8 * s, ((it / L::kStages) & 1) ^ 1);
          mbar_expect_tx(bar_k + 8 * s, L::kTileBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn)
            tma_load_4d(sK + s * L::kTileBytes + pn * L::kKVPanel, &tm_k, bar_k + 8 * s, 64 * pn,
                        k0, wk.hk, wk.b);
          mbar_expect_tx(bar_v + 8 * s, L::kTileBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn)
            tma_load_4d(sV + s * L::kTileBytes + pn * L::kKVPanel, &tm_v, bar_v + 8 * s, 64 * pn,
                        k0, wk.hk, wk.b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;  // rows [64c, 64c + 64) of each item
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r_lo = 16 * warp + g;  // this thread's rows: r_lo and r_lo + 8
    const float sl2 = p.scale * kLog2e;

    float o[kD / 2];                 // O of this thread's two rows
    float m[2], l[2];                // running max (base 2), this thread's part of the sum
    float sc[64];                    // S of the newest tile, then its P in float32
    uint32_t pa[kBlockN / 16][4];    // P of the tile before, in bf16: the A of P.V
    int64_t qa_lo = 0, qa_hi = 0;    // the positions of the item's first and last valid row
    uint32_t sQc = sQ;               // the item's Q buffer

    // S = Q K^T of stage s: kD / 16 steps of 16 columns, 32 bytes along a row each
    auto issue_s = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = desc_sw128(sQc + (kk / 4) * L::kQPanel + c * 64 * kRowBytes + col,
                                       16, 8 * kRowBytes);
        const uint64_t db = desc_sw128(sK + s * L::kTileBytes + (kk / 4) * L::kKVPanel + col,
                                       16, 8 * kRowBytes);
        wgmma_m64n128k16_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of stage s: V's rows are B's K axis (MN-major), 16 keys a step
    auto issue_pv = [&](int s) {
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pv<kD>(o, pa[kk], desc_sw128(sV + s * L::kTileBytes + kk * 16 * kRowBytes, L::kKVPanel,
                                     8 * kRowBytes));
      }
      wgmma_commit();
    };
    // mask (only where the tile crosses T, the causal diagonal or the
    // window's edge) and online softmax in base 2 of the tile at k0; a
    // row's 128 scores live in the 4 lanes of a quad.  Returns each row's
    // rescale factor of O in alpha.
    auto softmax = [&](int k0, float (&alpha)[2]) {
      fence_regs(sc);
      const bool inside = k0 + kBlockN <= p.T && (!p.causal || k0 + kBlockN - 1 <= qa_lo) &&
                          (!p.has_window || qa_hi - k0 < p.window);
      if (!inside) {
        // key column k0 + col is visible to a row at position k0 + d where
        // col < T - k0, col <= d (causal) and col > d - window: where
        // lo < col <= hi, the bounds clamped to [-1, kBlockN] (which keeps
        // every comparison's result) and taken less this lane's 2t, so
        // that each score compares a constant
        const int t_last = min(p.T - k0, kBlockN) - 1;
        int hi[2], lo[2];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int64_t d = qa_lo + r_lo + 8 * ri - k0;
          hi[ri] = min(p.causal ? clamp_col<kBlockN>(d) : kBlockN, t_last) - 2 * t;
          lo[ri] = (p.has_window ? clamp_col<kBlockN>(d - p.window) : -1) - 2 * t;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int col = 8 * j + x % 2;  // less 2t
            if (col > hi[x / 2] || col <= lo[x / 2]) sc[4 * j + x] = -CUDART_INF_F;
          }
        }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        // four chains each of maxima and of sums: shorter dependences
        float mq[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mq[j % 4] = fmaxf(mq[j % 4], fmaxf(sc[4 * j + 2 * ri], sc[4 * j + 2 * ri + 1]));
        }
        float mx = fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[ri], mx * sl2);
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[ri] = ex2(m[ri] - m_use);
        float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * ri + e];
            x = ex2(fmaf(x, sl2, -m_use));  // a masked score is -inf: 0
            sq[(2 * j + e) % 4] += x;
          }
        }
        l[ri] = l[ri] * alpha[ri] + ((sq[0] + sq[1]) + (sq[2] + sq[3]));
        m[ri] = m_new;
      }
    };
    // P in bf16: the S accumulator of keys [16kk, 16kk + 16) is the A fragment of step kk
    auto pack_p = [&] {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
      }
    };

    int it = 0, qn = 0;  // tiles and Q loads so far, as the producer counts them
    for (int r = 0, w; (w = item_of_round(r)) < n_items; ++r) {
      const Work wk = work_item(p, w);
      const int row0 = wk.q0 + 64 * c;
      qa_lo = p.q_offset + row0;
      qa_hi = p.q_offset + min(row0 + 64, p.S) - 1;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -CUDART_INF_F;
      l[0] = l[1] = 0.f;

      // Tile i's S product runs while tile i - 1's P.V does: the softmax
      // of S_i overlaps P_{i-1} V_{i-1} on the tensor cores.
      if (wk.n_tiles > 0) {
        float alpha[2];
        const int qb = qn & 1;
        sQc = sQ + qb * L::kQBytes;
        mbar_wait(bar_q + 8 * qb, (qn >> 1) & 1);
        ++qn;
        int s = it % L::kStages;
        mbar_wait(bar_k + 8 * s, (it / L::kStages) & 1);
        issue_s(s);
        wgmma_wait<0>();
        softmax(wk.kt0, alpha);
        pack_p();
        for (int i = 1; i < wk.n_tiles; ++i) {
          const int s_prev = s, it_prev = it++;
          s = it % L::kStages;
          mbar_wait(bar_k + 8 * s, (it / L::kStages) & 1);
          mbar_wait(bar_v + 8 * s_prev, (it_prev / L::kStages) & 1);
          issue_s(s);
          issue_pv(s_prev);
          wgmma_wait<1>();  // S_i is done, P_{i-1} V_{i-1} may still run
          softmax(wk.kt0 + i * kBlockN, alpha);
          wgmma_wait<0>();
          fence_regs(o);
          mbar_arrive(bar_e + 8 * s_prev);
#pragma unroll
          for (int i2 = 0; i2 < kD / 2; ++i2) o[i2] *= alpha[(i2 / 2) % 2];
          pack_p();
        }
        mbar_arrive(bar_qe + 8 * qb);  // every S product of the item is done: Q may be reloaded
        mbar_wait(bar_v + 8 * s, (it / L::kStages) & 1);
        issue_pv(s);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(bar_e + 8 * s);
        ++it;
      }

      // o = acc / l in bf16, in q's layout; lse from lane t == 0 of each quad
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + wk.b * p.o_sb + wk.h * p.o_sh;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float lr = l[ri];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int row = row0 + r_lo + 8 * ri;
        if (row >= p.S) continue;
        const float inv = 1.f / fmaxf(lr, 1e-30f);
        __nv_bfloat16* orow = out + row * p.o_ss + 2 * t;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * ri] * inv, o[4 * j + 2 * ri + 1] * inv);
        }
        if (p.lse != nullptr && t == 0) {
          p.lse[int64_t(wk.b * p.H + wk.h) * p.S + row] =
              lr > 0.f ? (m[ri] + log2f(lr)) * kLn2 : -CUDART_INF_F;
        }
      }
    }
  }
}

// The Hopper kernel on one call: the three tensor maps, the shared-memory
// limit and the launch.  Returns a cudaError_t.
template <int kD>
int launch_hopper(const Params& p, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  using hopper::encode_bhsd;
  int err = encode_bhsd(&tm_q, p.q, p.B, p.H, p.S, kD, p.q_sb, p.q_sh, p.q_ss, kBlockM);
  if (err == 0) err = encode_bhsd(&tm_k, p.k, p.B, p.Hkv, p.T, kD, p.k_sb, p.k_sh, p.k_st, kBlockN);
  if (err == 0) err = encode_bhsd(&tm_v, p.v, p.B, p.Hkv, p.T, kD, p.v_sb, p.v_sh, p.v_st, kBlockN);
  if (err != 0) return err;
  static int sms[hopper::kMaxDevices] = {};
  void* args[] = {&tm_q, &tm_k, &tm_v, const_cast<Params*>(&p)};
  return hopper::launch_persistent(flash_fwd_hopper<kD>, sms, work_items(p), kThreads,
                                   Layout<kD>::kSmem, args, stream);
}

}  // namespace fwd_hopper

template <int kD>
int launch_dtype(int dtype, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.B * p.H);
  if (dtype == 1) {
    return launch(flash_fwd_bf16<kD>, grid,
                  sizeof(__nv_bfloat16) * (kBlockQ + 2 * kBlockK) * (kD + 8), p, stream);
  }
  return launch(flash_fwd_f32<kD>, grid,
                sizeof(float) * ((kBlockQ + 2 * kBlockK) * (kD + 1) + kBlockQ * 65), p, stream);
}

Params make_params(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int64_t* dims, const int64_t* strides, int causal, int has_window,
                   int64_t window, int64_t q_offset, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.Hkv = static_cast<int>(dims[2]);
  p.S = static_cast<int>(dims[3]);
  p.T = static_cast<int>(dims[4]);
  p.D = static_cast<int>(dims[5]);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_st = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_st = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  return p;
}

int forward(const Params& p, int dtype, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p.D <= 32) return launch_dtype<32>(dtype, p, s);
  if (p.D <= 64) return launch_dtype<64>(dtype, p, s);
  if (p.D <= 128) return launch_dtype<128>(dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int forward_hopper(const Params& p, int dtype, cudaStream_t s) {
  if (dtype != 1 || fwd_hopper::work_items(p) > fwd_hopper::kMaxItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.D == 64) return fwd_hopper::launch_hopper<64>(p, s);
  if (p.D == 128) return fwd_hopper::launch_hopper<128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dims: B, H, Hkv, S, T, D.  strides (in
// elements; the last axis is contiguous): q b,h,s; k b,h,t; v b,h,t; o b,h,s.
// lse: (B*H, S) float32, contiguous, or null (serving: not written).
// flash_attention_fwd launches flash_fwd_f32 or flash_fwd_bf16;
// flash_attention_fwd_hopper launches flash_fwd_hopper, which takes bf16
// with D 64 or 128, q, k and v 16-byte aligned with strides of 16-byte
// multiples on every axis longer than 1, and at most 2**30 blocks of 128
// query rows (ceil(S / 128) x B x H).
// Each returns a cudaError_t: 0 when the launch was taken; 1
// (cudaErrorInvalidValue) for an input its kernels do not take or a tensor
// map the driver refuses; 801 (cudaErrorNotSupported) where the driver has
// no cuTensorMapEncodeTiled.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, const int64_t* dims,
                                   const int64_t* strides, int causal, int has_window,
                                   int64_t window, int64_t q_offset, float scale, void* stream) {
  return forward(make_params(q, k, v, o, lse, dims, strides, causal, has_window, window,
                             q_offset, scale),
                 dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_fwd_hopper(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int dtype, const int64_t* dims,
                                          const int64_t* strides, int causal, int has_window,
                                          int64_t window, int64_t q_offset, float scale,
                                          void* stream) {
  return forward_hopper(make_params(q, k, v, o, lse, dims, strides, causal, has_window, window,
                                    q_offset, scale),
                        dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
