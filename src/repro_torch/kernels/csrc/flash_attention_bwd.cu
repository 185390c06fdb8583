// Flash attention, backward, on Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replace the TPU kernels _dq_kernel and _dkv_kernel of
// src/repro/kernels/flash_attention_bwd.py (called from _vjp_bwd) and
// compute what they compute, from the forward's residuals q, k, v and the
// per-row logsumexp lse (written by the forward of flash_attention.cu):
//   p  = exp(q.k^T * scale - lse)       (0 where the mask hides the pair)
//   dv = p^T . dO
//   dp = dO . v^T
//   ds = p * (dp - delta),  delta = rowsum(dO * O)  (computed by the caller)
//   dq = ds . k * scale;    dk = ds^T . q * scale
// with GQA through the head index and the masks t < T, causal t <= s and
// window s - t < window (q_offset is 0 in training).  Sums in float32;
// outputs in the input type.
//
// Design.  On the TPU both kernels revisit an output tile along a
// sequential grid axis with a VMEM accumulator, and dk/dv are computed at
// query-head width on K and V repeated by _expand_bh and then summed over
// the GQA group outside the kernel.  Here blocks run in parallel, so the
// revisiting becomes a loop inside one block (or work item) with the
// accumulator in registers; tiles that the masks leave empty are not
// visited.  dq stays a kernel of its own: summing dq over key tiles in one
// fused kernel would need atomics, whose order changes from run to run.
// Every output is written by one thread in a fixed order of sums, so both
// kernels are deterministic (a resumed run repeats an uninterrupted one
// bitwise).  Three pairs of kernels, chosen by the wrapper
// (kernels/flash_attention_bwd.py, route):
//   - flash_bwd_dq_hopper and flash_bwd_dkv_hopper (bf16, head_dim 64 or
//     128, q, k, v and dout each addressable by TMA: the training path).
//     Persistent: one block of three warpgroups per SM walks work items,
//     those with the most tiles first.  Warpgroup 0 produces: its first
//     thread loads by TMA with the 128-byte swizzle, each load completing
//     on a "full" mbarrier of a ring of stages and each stage freed by an
//     "empty" one.  Warpgroups 1 and 2 consume 64 rows each.
//       dq: an item is 128 query rows of one (batch, head); Q and dO are
//     loaded once per item (two buffers, so the next item loads while the
//     last finishes), K and V tiles (128 keys at head_dim 64, 64 at 128)
//     through the ring.  Per tile: S = Q.K^T and dP = dO.V^T as wgmma from
//     shared memory (both K-major), P = exp2(S scale log2(e) - lse log2(e))
//     and dS = P (dP - delta) in float32 (the mask only on tiles that cross
//     T, the causal diagonal or the window's edge), dS rounded to bf16 in
//     registers (the accumulator layout is the A layout), and dQ += dS.K
//     with K read as a transposed (MN-major) B from the same tile.
//       dk/dv: an item is 128 keys of one (batch, kv head), K and V loaded
//     once (two buffers at head_dim 64, one at 128); the ring streams the
//     (Q, dO) tiles of 64 query rows of each query head of the group in
//     turn, over the query tiles that see the item's keys, with their lse
//     (in log2 units) and delta rows, which the producer warp's 32 lanes
//     store beside them before they arrive on the stage's barrier.  Per
//     tile: S^T = K.Q^T and dP^T = V.dO^T from shared memory, P^T and dS^T
//     in float32, then dV += P^T.dO and dK += dS^T.Q with dO and Q read as
//     MN-major B from the tiles that were K-major B a moment before.  dK and
//     dV stay in registers across the whole GQA group and are written once.
//     64 query rows a tile at both head dims: at 128, the four products'
//     registers (dK, dV, S^T, dP^T and the bf16 P^T and dS^T in flight)
//     would not fit 232 a thread.
//     In both, each tile's first two products are issued with the last
//     tile's accumulating ones, so the exponentials run while the tensor
//     cores finish those.  setmaxnreg moves registers from the producer to
//     the consumers.
//   - dq_bf16 and dkv_bf16 (other bf16 inputs: head_dim 16, 20 or 32 in the
//     sweeps and the smoke config, strides TMA refuses): one block per
//     64-row tile and (batch, head) or (batch, kv head), 4 warps of
//     mma.sync.m16n8k16 each owning 16 rows (the fragment helpers of
//     flash_common.cuh; P and dS rounded to bf16 as the A operand of the
//     second products), tiles loaded by plain loads between two barriers,
//     head_dim padded with zeros to 32, 64 or 128 in shared memory.
//   - dq_f32 and dkv_f32 (float32: tests and the card-against-CPU step):
//     the same tiling on CUDA cores in full float32, each thread owning 4
//     rows x 8 columns of the 64 x 64 score tile and 4 rows x D/8 columns of
//     the outputs.
//
// Bound at the training shape, q (4, 15, 2048, 64) and k/v (4, 5, 2048, 64)
// bf16, causal, 2,098,176 pairs per head, 60 query heads: the dq kernel
// does three products of 2 * 64 flops per pair (S, dP, dS.K), 48.3 GFLOP,
// 48.9 us at 989 TFLOP/s of bf16 tensor cores; the dk/dv kernel four (S,
// dP, P^T.dO, dS^T.Q), 64.4 GFLOP, 65.1 us.  Each also takes one
// exponential per visible pair, 126 M, 30.1 us at 16 a clock on each of
// 132 SMs at 1,980 MHz.  Their bytes (q, k, v, dO, lse, delta read once,
// the outputs written once) are 58.7 and 53.4 MB, 17.5 and 15.9 us at 3.35
// TB/s (H100 SXM data sheet, 700 W): operations bound both, the tensor
// cores first and the exponentials close behind.  So the Hopper kernels
// feed wgmma from a TMA ring instead of loading tiles through registers,
// keep two consumer warpgroups so that one's exponentials run under the
// other's products, and walk the causal work longest first so that the
// SMs finish together.
//
// Plain C entry points, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <math_constants.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, S)
  const float* delta;  // (B*H, S)
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, S, T, D;
  // strides in elements (b, h, row) of q, k, v, dout, dq, dk, dv
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st, do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st;
  int causal;
  int has_window;
  int64_t window;
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = qpos < p.S && kpos < p.T;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.has_window) ok = ok && int64_t(qpos) - kpos < p.window;
  return ok;
}

// Keys [lo, hi) that some row of query tile q0 may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* lo, int* hi) {
  int64_t a = 0, b = p.T;
  const int64_t q_hi = min(q0 + kBlockQ, p.S) - 1;
  if (p.causal && q_hi + 1 < b) b = q_hi + 1;
  if (p.has_window && q0 - p.window + 1 > a) a = q0 - p.window + 1;
  if (b <= a) a = b = 0;
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(b);
}

// Queries [lo, hi) that may see some key of key tile k0.
__device__ __forceinline__ void query_range(const Params& p, int k0, int* lo, int* hi) {
  int64_t a = 0, b = p.S;
  if (p.causal && k0 > a) a = k0;
  if (p.has_window && int64_t(k0) + kBlockK - 1 + p.window < b) b = int64_t(k0) + kBlockK - 1 + p.window;
  if (b <= a) a = b = 0;
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(b);
}

// ============================================================== bf16
template <int kD>
__global__ void __launch_bounds__(kThreads) dq_bf16(const Params p) {
  constexpr int kLd = kD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kBlockQ * kLd;
  __nv_bfloat16* Ks = dOs + kBlockQ * kLd;
  __nv_bfloat16* Vs = Ks + kBlockK * kLd;

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* dout = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto* dq = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  load_tile_bf16<kD>(Qs, q, p.q_ss, q0, p.S, p.D);
  load_tile_bf16<kD>(dOs, dout, p.do_ss, q0, p.S, p.D);
  __syncthreads();
  uint32_t qa[kD / 16][4], da[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a_frag(qa[kk], Qs, kLd, warp * 16, kk * 16, g, t);
    load_a_frag(da[kk], dOs, kLd, warp * 16, kk * 16, g, t);
  }
  float lse[2], delta[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = q0 + row0 + 8 * ri;
    lse[ri] = r < p.S ? p.lse[int64_t(bh) * p.S + r] : 0.f;
    delta[ri] = r < p.S ? p.delta[int64_t(bh) * p.S + r] : 0.f;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int k_lo, k_hi;
  key_range(p, q0, &k_lo, &k_hi);
  for (int k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<kD>(Ks, k, p.k_st, k0, p.T, p.D);
    load_tile_bf16<kD>(Vs, v, p.v_st, k0, p.T, p.D);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_rows<kD>(s, qa, Ks, g, t);   // S = Q K^T
    mma_rows<kD>(dp, da, Vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2;
        const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
        const float pr =
            visible(p, q0 + row0 + 8 * ri, kpos) ? expf(s[nb][e] * p.scale - lse[ri]) : 0.f;
        s[nb][e] = pr * (dp[nb][e] - delta[ri]);  // dS
      }
    }
    mma_cols<kD>(acc, s, Ks, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = q0 + row0 + 8 * ri;
    if (r >= p.S) continue;
    __nv_bfloat16* out = dq + r * p.dq_ss;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * t + e;
        if (d < p.D) out[d] = __float2bfloat16(acc[nd][2 * ri + e] * p.scale);
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) dkv_bf16(const Params p) {
  constexpr int kLd = kD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBlockK * kLd;
  __nv_bfloat16* Qs = Vs + kBlockK * kLd;
  __nv_bfloat16* dOs = Qs + kBlockQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlockQ * kLd);
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int group = p.H / p.Hkv;
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto* dk = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  auto* dv = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int krow0 = warp * 16 + g;  // this thread's keys: krow0 and krow0 + 8

  load_tile_bf16<kD>(Ks, k, p.k_st, k0, p.T, p.D);
  load_tile_bf16<kD>(Vs, v, p.v_st, k0, p.T, p.D);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  int q_lo, q_hi;
  query_range(p, k0, &q_lo, &q_hi);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const int64_t bh = int64_t(b) * p.H + h;
    const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const auto* dout = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = (q_lo / kBlockQ) * kBlockQ; q0 < q_hi; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile_bf16<kD>(Qs, q, p.q_ss, q0, p.S, p.D);
      load_tile_bf16<kD>(dOs, dout, p.do_ss, q0, p.S, p.D);
      if (threadIdx.x < kBlockQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < p.S ? p.lse[bh * p.S + r] : 0.f;
        delta_s[threadIdx.x] = r < p.S ? p.delta[bh * p.S + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T: rows are this warp's 16 keys, columns 64 queries
      float st[8][4];
      {
        uint32_t ka[kD / 16][4];
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) load_a_frag(ka[kk], Ks, kLd, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = 0.f;
        mma_rows<kD>(st, ka, Qs, g, t);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nb * 8 + 2 * t + (e & 1);
          st[nb][e] = visible(p, q0 + c, k0 + krow0 + 8 * (e / 2))
                          ? expf(st[nb][e] * p.scale - lse_s[c]) : 0.f;  // P^T
        }
      }
      mma_cols<kD>(dv_acc, st, dOs, g, t);  // dV += P^T dO

      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta)
      float dpt[8][4];
      {
        uint32_t va[kD / 16][4];
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) load_a_frag(va[kk], Vs, kLd, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) dpt[nb][0] = dpt[nb][1] = dpt[nb][2] = dpt[nb][3] = 0.f;
        mma_rows<kD>(dpt, va, dOs, g, t);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nb * 8 + 2 * t + (e & 1);
          st[nb][e] *= dpt[nb][e] - delta_s[c];
        }
      }
      mma_cols<kD>(dk_acc, st, Qs, g, t);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = k0 + krow0 + 8 * ri;
    if (r >= p.T) continue;
    __nv_bfloat16* dkr = dk + r * p.dk_st;
    __nv_bfloat16* dvr = dv + r * p.dv_st;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd * 8 + 2 * t + e;
        if (d < p.D) {
          dkr[d] = __float2bfloat16(dk_acc[nd][2 * ri + e] * p.scale);
          dvr[d] = __float2bfloat16(dv_acc[nd][2 * ri + e]);
        }
      }
    }
  }
}

// ============================================================== f32
template <int kD>
__global__ void __launch_bounds__(kThreads) dq_f32(const Params p) {
  constexpr int kLd = kD + 1;
  constexpr int kDj = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + kBlockQ * kLd;
  float* Ks = dOs + kBlockQ * kLd;
  float* Vs = Ks + kBlockK * kLd;
  float* dSs = Vs + kBlockK * kLd;  // (64, 65)

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;

  // thread (ty, tx): rows 4*ty + i, key columns tx + 8*j, output columns tx + 8*j
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  load_tile_f32<kD>(Qs, q, p.q_ss, q0, p.S, p.D);
  load_tile_f32<kD>(dOs, dout, p.do_ss, q0, p.S, p.D);
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lse[i] = r < p.S ? p.lse[int64_t(bh) * p.S + r] : 0.f;
    delta[i] = r < p.S ? p.delta[int64_t(bh) * p.S + r] : 0.f;
  }
  float acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;

  int k_lo, k_hi;
  key_range(p, q0, &k_lo, &k_hi);
  for (int k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();
    load_tile_f32<kD>(Ks, k, p.k_st, k0, p.T, p.D);
    load_tile_f32<kD>(Vs, v, p.v_st, k0, p.T, p.D);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      float qv[4], dov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(4 * ty + i) * kLd + d];
        dov[i] = dOs[(4 * ty + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tx + 8 * j) * kLd + d];
        vv[j] = Vs[(tx + 8 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pr = visible(p, q0 + 4 * ty + i, k0 + tx + 8 * j)
                             ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        dSs[(4 * ty + i) * 65 + tx + 8 * j] = pr * (dp[i][j] - delta[i]);
      }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float kc[kDj];
#pragma unroll
      for (int j = 0; j < kDj; ++j) kc[j] = Ks[c * kLd + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(4 * ty + i) * 65 + c];
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(ds, kc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.S) continue;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      const int d = tx + 8 * j;
      if (d < p.D) dq[r * p.dq_ss + d] = acc[i][j] * p.scale;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) dkv_f32(const Params p) {
  constexpr int kLd = kD + 1;
  constexpr int kDj = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kBlockK * kLd;
  float* Qs = Vs + kBlockK * kLd;
  float* dOs = Qs + kBlockQ * kLd;
  float* Ps = dOs + kBlockQ * kLd;  // (64 keys, 65)
  float* dSs = Ps + kBlockK * 65;   // (64 keys, 65)
  float* lse_s = dSs + kBlockK * 65;
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int group = p.H / p.Hkv;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* dk = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  float* dv = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;

  // thread (ty, tx): keys 4*ty + i, query columns tx + 8*j, output columns tx + 8*j
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  load_tile_f32<kD>(Ks, k, p.k_st, k0, p.T, p.D);
  load_tile_f32<kD>(Vs, v, p.v_st, k0, p.T, p.D);
  float dk_acc[4][kDj], dv_acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  int q_lo, q_hi;
  query_range(p, k0, &q_lo, &q_hi);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const int64_t bh = int64_t(b) * p.H + h;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = (q_lo / kBlockQ) * kBlockQ; q0 < q_hi; q0 += kBlockQ) {
      __syncthreads();
      load_tile_f32<kD>(Qs, q, p.q_ss, q0, p.S, p.D);
      load_tile_f32<kD>(dOs, dout, p.do_ss, q0, p.S, p.D);
      if (threadIdx.x < kBlockQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < p.S ? p.lse[bh * p.S + r] : 0.f;
        delta_s[threadIdx.x] = r < p.S ? p.delta[bh * p.S + r] : 0.f;
      }
      __syncthreads();

      float st[4][8], dpt[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < p.D; ++d) {
        float kv[4], vv[4], qv[8], dov[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(4 * ty + i) * kLd + d];
          vv[i] = Vs[(4 * ty + i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qv[j] = Qs[(tx + 8 * j) * kLd + d];
          dov[j] = dOs[(tx + 8 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j;
          const float pr = visible(p, q0 + c, k0 + 4 * ty + i)
                               ? expf(st[i][j] * p.scale - lse_s[c]) : 0.f;
          Ps[(4 * ty + i) * 65 + c] = pr;
          dSs[(4 * ty + i) * 65 + c] = pr * (dpt[i][j] - delta_s[c]);
        }
      __syncthreads();

      for (int c = 0; c < kBlockQ; ++c) {
        float qc[kDj], doc[kDj];
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          qc[j] = Qs[c * kLd + tx + 8 * j];
          doc[j] = dOs[c * kLd + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr = Ps[(4 * ty + i) * 65 + c];
          const float ds = dSs[(4 * ty + i) * 65 + c];
#pragma unroll
          for (int j = 0; j < kDj; ++j) {
            dv_acc[i][j] = fmaf(pr, doc[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qc[j], dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= p.T) continue;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      const int d = tx + 8 * j;
      if (d < p.D) {
        dk[r * p.dk_st + d] = dk_acc[i][j] * p.scale;
        dv[r * p.dv_st + d] = dv_acc[i][j];
      }
    }
  }
}

// --------------------------------------------------------------- Hopper
namespace bwd_hopper {

constexpr int kBlockM = 128;   // query rows of a dq item, keys of a dk/dv item
constexpr int kTileQ = 64;     // query rows of a dk/dv tile
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kRowBytes = 128; // one swizzled row: 64 bf16 values
// 128 x 24 + 256 x 240 = 64,512, what the launch gives 384 threads of 168:
// 240 leaves dq at head_dim 64 without spills (232 spilled 24 bytes)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int64_t kMaxItems = int64_t(1) << 30;  // item indices stay in int

// Shared memory of the dq kernel: two Q buffers | two dO buffers (each
// kD / 64 panels of 128 rows) | K stages | V stages | barriers; every piece
// on a 1,024-byte boundary.
template <int kD>
struct DqLayout {
  static constexpr int kN = kD == 64 ? 128 : 64;  // keys per tile
  static constexpr int kPanels = kD / 64;
  static constexpr int kStages = kD == 64 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * kD * 2;  // one Q or dO buffer
  static constexpr int kQPanel = kBlockM * kRowBytes;
  static constexpr int kTileBytes = kN * kD * 2;  // one K or V tile
  static constexpr int kKVPanel = kN * kRowBytes;
  static constexpr int kDO = 2 * kQBytes;
  static constexpr int kK = 4 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBars = 4 + 2 * kStages;  // Q and dO full, free; per stage full, free
  static constexpr int kSmem = kBar + 8 * kBars + 1024;  // + the base's alignment
  static_assert(kSmem > 116 * 1024 && kSmem <= 227 * 1024, "one block per SM");
};

// Shared memory of the dk/dv kernel: K buffers | V buffers (each kD / 64
// panels of 128 rows) | Q stages | dO stages (64 rows each) | per stage 64
// lse values (log2 units) and 64 delta values | barriers.
template <int kD>
struct DkvLayout {
  static constexpr int kPanels = kD / 64;
  static constexpr int kKVBufs = kD == 64 ? 2 : 1;
  static constexpr int kStages = 4;
  static constexpr int kKVBytes = kBlockM * kD * 2;  // one item's K or V
  static constexpr int kKVPanel = kBlockM * kRowBytes;
  static constexpr int kTileBytes = kTileQ * kD * 2;  // one Q or dO tile
  static constexpr int kTPanel = kTileQ * kRowBytes;
  static constexpr int kV = kKVBufs * kKVBytes;
  static constexpr int kQ = 2 * kV;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kRows = kDO + kStages * kTileBytes;
  static constexpr int kBar = kRows + kStages * 2 * kTileQ * 4;
  static constexpr int kBars = 2 * kKVBufs + 2 * kStages;  // per buffer and per stage: full, free
  static constexpr int kSmem = kBar + 8 * kBars + 1024;
  static_assert(kSmem > 116 * 1024 && kSmem <= 227 * 1024, "one block per SM");
};

// K-major descriptor of k-step kk (16 columns, 32 bytes) of a swizzled
// tile whose 64-column panels lie `panel` bytes apart, from row `row` on
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int panel, int row, int kk) {
  return hopper::desc_sw128(tile + (kk / 4) * panel + row * kRowBytes + (kk % 4) * 32, 16,
                            8 * kRowBytes);
}

// MN-major descriptor of rows [16 kk, 16 kk + 16) of a swizzled tile read
// as B's K axis (the tile's columns are B's N axis)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int panel, int kk) {
  return hopper::desc_sw128(tile + kk * 16 * kRowBytes, panel, 8 * kRowBytes);
}

// d (+)= A . B^T, both K-major in shared memory: a 64 x N score tile
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  hopper::wgmma_m64n64k16_ss(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  hopper::wgmma_m64n128k16_ss(d, da, db, scale_d);
}

// d += A . B, A (64 x 16) from registers, B (16 x N) MN-major: N = head_dim
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_m64n64k16_rs_tb(d, a, db);
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_m64n128k16_rs_tb(d, a, db);
}

// bf16 A fragments of a 64 x 16n float32 accumulator: its columns
// [16 kk, 16 kk + 16) are the A of k-step kk
template <int n>
__device__ __forceinline__ void pack_a(uint32_t (&a)[n][4], const float (&x)[8 * n]) {
#pragma unroll
  for (int kk = 0; kk < n; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

__host__ __device__ __forceinline__ int64_t dq_items(const Params& p) {
  return int64_t((p.S + kBlockM - 1) / kBlockM) * p.B * p.H;
}

__host__ __device__ __forceinline__ int64_t dkv_items(const Params& p) {
  return int64_t((p.T + kBlockM - 1) / kBlockM) * p.B * p.Hkv;
}

// A dq item: 128 query rows of one (batch, head) and the key tiles of kN
// keys they see.  Item w is query tile n_q - 1 - w / (B H), the longest
// key walks first, of batch x head w % (B H).
struct DqWork {
  int q0, b, h, hk, kt0, n_tiles;
};

template <int kN>
__device__ __forceinline__ DqWork dq_item(const Params& p, int w) {
  const int bh = w % (p.B * p.H), n_q = (p.S + kBlockM - 1) / kBlockM;
  DqWork wk;
  wk.q0 = (n_q - 1 - w / (p.B * p.H)) * kBlockM;
  wk.b = bh / p.H;
  wk.h = bh % p.H;
  wk.hk = wk.h / (p.H / p.Hkv);
  int64_t lo = 0, hi = p.T;
  const int64_t q_last = min(wk.q0 + kBlockM, p.S) - 1;
  if (p.causal && q_last + 1 < hi) hi = q_last + 1;
  if (p.has_window && wk.q0 - p.window + 1 > lo) lo = wk.q0 - p.window + 1;
  wk.kt0 = wk.n_tiles = 0;
  if (hi > lo) {
    wk.kt0 = static_cast<int>(lo / kN) * kN;
    wk.n_tiles = static_cast<int>((hi - wk.kt0 + kN - 1) / kN);
  }
  return wk;
}

// A dk/dv item: 128 keys of one (batch, kv head) and the query tiles of 64
// rows that see them, for each query head of the group.  Item w is key
// tile w / (B Hkv) (under the causal mask the first key tiles have the
// most query tiles) of batch x kv head w % (B Hkv).
struct DkvWork {
  int k0, b, hk, qt0, n_qt, n_tiles;
};

__device__ __forceinline__ DkvWork dkv_item(const Params& p, int w) {
  const int bhk = w % (p.B * p.Hkv);
  DkvWork wk;
  wk.k0 = (w / (p.B * p.Hkv)) * kBlockM;
  wk.b = bhk / p.Hkv;
  wk.hk = bhk % p.Hkv;
  int64_t lo = p.causal ? wk.k0 : 0, hi = p.S;
  if (p.has_window && int64_t(wk.k0) + kBlockM - 1 + p.window < hi) {
    hi = int64_t(wk.k0) + kBlockM - 1 + p.window;
  }
  wk.qt0 = wk.n_qt = 0;
  if (hi > lo) {
    wk.qt0 = static_cast<int>(lo / kTileQ) * kTileQ;
    wk.n_qt = static_cast<int>((hi - wk.qt0 + kTileQ - 1) / kTileQ);
  }
  wk.n_tiles = wk.n_qt * (p.H / p.Hkv);
  return wk;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = DqLayout<kD>;
  constexpr int kN = L::kN;
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t base = (smem_u32(hopper_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + L::kDO, sK = base + L::kK, sV = base + L::kV;
  // barriers: per Q buffer Q and dO full, free; per stage K and V full, free
  const uint32_t bar_q = base + L::kBar, bar_qe = bar_q + 16;
  const uint32_t bar_f = bar_qe + 16, bar_e = bar_f + 8 * L::kStages;
  const int n_items = static_cast<int>(dq_items(p));

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(bar_q + 8 * qb, 1);
      mbar_init(bar_qe + 8 * qb, 2 * 128);  // every consumer thread frees Q and the stages
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1);
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
      tma_prefetch(&tm_do);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      int it = 0, qn = 0;  // tiles and Q loads so far: the ring's and Q's phases
      for (int r = 0, w; (w = item_of_round(r)) < n_items; ++r) {
        const DqWork wk = dq_item<kN>(p, w);
        if (wk.n_tiles == 0) continue;
        const int qb = qn & 1;
        mbar_wait(bar_qe + 8 * qb, ((qn >> 1) & 1) ^ 1);  // each buffer's first round is free
        ++qn;
        mbar_expect_tx(bar_q + 8 * qb, 2 * L::kQBytes);
#pragma unroll
        for (int pn = 0; pn < L::kPanels; ++pn) {
          const uint32_t off = qb * L::kQBytes + pn * L::kQPanel;
          tma_load_4d(sQ + off, &tm_q, bar_q + 8 * qb, 64 * pn, wk.q0, wk.h, wk.b);
          tma_load_4d(sDO + off, &tm_do, bar_q + 8 * qb, 64 * pn, wk.q0, wk.h, wk.b);
        }
        for (int i = 0; i < wk.n_tiles; ++i, ++it) {
          const int s = it % L::kStages, k0 = wk.kt0 + i * kN;
          mbar_wait(bar_e + 8 * s, ((it / L::kStages) & 1) ^ 1);
          mbar_expect_tx(bar_f + 8 * s, 2 * L::kTileBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn) {
            const uint32_t off = s * L::kTileBytes + pn * L::kKVPanel;
            tma_load_4d(sK + off, &tm_k, bar_f + 8 * s, 64 * pn, k0, wk.hk, wk.b);
            tma_load_4d(sV + off, &tm_v, bar_f + 8 * s, 64 * pn, k0, wk.hk, wk.b);
          }
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

    float dq[kD / 2];              // dQ of this thread's two rows
    float sc[kN / 2], dp[kN / 2];  // S, then dS; dP
    uint32_t da[kN / 16][4];       // dS of the tile before, in bf16: the A of dS.K
    float lse2[2], dlt[2];         // this thread's rows' lse (log2 units) and delta
    int row_lo = 0, row_last = 0;  // the consumer's first row and last valid row
    uint32_t sQc = sQ, sDOc = sDO; // the item's Q and dO buffers

    // S = Q K^T and dP = dO V^T of stage s, kD / 16 steps of 16 columns each
    auto issue_sdp = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_ss<kN>(sc, desc_k(sQc, L::kQPanel, 64 * c, kk),
                   desc_k(sK + s * L::kTileBytes, L::kKVPanel, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_ss<kN>(dp, desc_k(sDOc, L::kQPanel, 64 * c, kk),
                   desc_k(sV + s * L::kTileBytes, L::kKVPanel, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K of stage s: K's rows are B's K axis (MN-major), 16 keys a step
    auto issue_dq = [&](int s) {
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        mma_rs<kD>(dq, da[kk], desc_mn(sK + s * L::kTileBytes, L::kKVPanel, kk));
      }
      wgmma_commit();
    };
    // P and dS of the tile at k0 into sc; the mask only where the tile
    // crosses T, the causal diagonal or the window's edge.  Key column
    // k0 + col is visible to a row at position k0 + d where col < T - k0,
    // col <= d (causal) and col > d - window: where lo < col <= hi, the
    // bounds clamped to [-1, kN] and taken less this lane's 2t.  A pair
    // the mask hides gets P = 0 by selection (a row without keys has lse
    // -inf, and its exponent is then +inf or NaN).
    auto grad = [&](int k0) {
      fence_regs(sc);
      fence_regs(dp);
      const bool inside = k0 + kN <= p.T && (!p.causal || k0 + kN - 1 <= row_lo) &&
                          (!p.has_window || row_last - k0 < p.window);
      auto body = [&](auto masked) {
        [[maybe_unused]] int hi[2], lo[2];
        if constexpr (decltype(masked)::value) {
          const int t_last = min(p.T - k0, kN) - 1;
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const int64_t d = int64_t(row_lo) + r_lo + 8 * ri - k0;
            hi[ri] = min(p.causal ? hopper::clamp_col<kN>(d) : kN, t_last) - 2 * t;
            lo[ri] = (p.has_window ? hopper::clamp_col<kN>(d - p.window) : -1) - 2 * t;
          }
        }
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 4 * j + x, ri = x / 2;
            float pr = ex2(fmaf(sc[i], sl2, -lse2[ri]));
            if constexpr (decltype(masked)::value) {
              const int col = 8 * j + x % 2;  // less 2t
              if (col > hi[ri] || col <= lo[ri]) pr = 0.f;
            }
            sc[i] = pr * (dp[i] - dlt[ri]);
          }
        }
      };
      if (inside) {
        body(std::false_type{});
      } else {
        body(std::true_type{});
      }
    };

    int it = 0, qn = 0;  // tiles and Q loads so far, as the producer counts them
    for (int r = 0, w; (w = item_of_round(r)) < n_items; ++r) {
      const DqWork wk = dq_item<kN>(p, w);
      row_lo = wk.q0 + 64 * c;
      row_last = min(row_lo + 64, p.S) - 1;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
      const int64_t bh = int64_t(wk.b) * p.H + wk.h;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int row = row_lo + r_lo + 8 * ri;
        lse2[ri] = row < p.S ? p.lse[bh * p.S + row] * kLog2e : 0.f;
        dlt[ri] = row < p.S ? p.delta[bh * p.S + row] : 0.f;
      }

      // Tile i's S and dP products run while tile i - 1's dS.K does: the
      // exponentials of tile i overlap dS_{i-1} K_{i-1} on the tensor cores.
      if (wk.n_tiles > 0) {
        const int qb = qn & 1;
        sQc = sQ + qb * L::kQBytes;
        sDOc = sDO + qb * L::kQBytes;
        mbar_wait(bar_q + 8 * qb, (qn >> 1) & 1);
        ++qn;
        int s = it % L::kStages;
        mbar_wait(bar_f + 8 * s, (it / L::kStages) & 1);
        issue_sdp(s);
        wgmma_wait<0>();
        grad(wk.kt0);
        pack_a(da, sc);
        for (int i = 1; i < wk.n_tiles; ++i) {
          const int s_prev = s;
          s = ++it % L::kStages;
          mbar_wait(bar_f + 8 * s, (it / L::kStages) & 1);
          issue_sdp(s);
          issue_dq(s_prev);
          wgmma_wait<1>();  // S_i and dP_i are done, dS_{i-1} K_{i-1} may still run
          grad(wk.kt0 + i * kN);
          wgmma_wait<0>();
          fence_regs(dq);
          mbar_arrive(bar_e + 8 * s_prev);
          pack_a(da, sc);
        }
        mbar_arrive(bar_qe + 8 * qb);  // every product that reads Q and dO is done
        issue_dq(s);
        wgmma_wait<0>();
        fence_regs(dq);
        mbar_arrive(bar_e + 8 * s);
        ++it;
      }

      // dq = scale dQ in bf16, in dq's layout; zeros for rows that see no key
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq) + wk.b * p.dq_sb + wk.h * p.dq_sh;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int row = row_lo + r_lo + 8 * ri;
        if (row >= p.S) continue;
        __nv_bfloat16* orow = out + row * p.dq_ss + 2 * t;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
              dq[4 * j + 2 * ri] * p.scale, dq[4 * j + 2 * ri + 1] * p.scale);
        }
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = DkvLayout<kD>;
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t base = (smem_u32(hopper_smem) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + L::kV, sQ = base + L::kQ, sDO = base + L::kDO;
  // per stage: kTileQ lse values in log2 units, then kTileQ delta values
  float* const rows = reinterpret_cast<float*>(hopper_smem + (base - smem_u32(hopper_smem)) +
                                               L::kRows);
  // barriers: per K/V buffer full, free; per stage full, free
  const uint32_t bar_kv = base + L::kBar, bar_kve = bar_kv + 8 * L::kKVBufs;
  const uint32_t bar_f = bar_kve + 8 * L::kKVBufs, bar_e = bar_f + 8 * L::kStages;
  const int n_items = static_cast<int>(dkv_items(p));
  const int group = p.H / p.Hkv;

  if (threadIdx.x == 0) {
    for (int kb = 0; kb < L::kKVBufs; ++kb) {
      mbar_init(bar_kv + 8 * kb, 1);
      mbar_init(bar_kve + 8 * kb, 2 * 128);
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1 + 32);  // the TMA loads, and each producer lane's rows
      mbar_init(bar_e + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_do);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
      }
      int it = 0, kn = 0;  // tiles and K/V loads so far: the ring's and K/V's phases
      for (int r = 0, w; (w = item_of_round(r)) < n_items; ++r) {
        const DkvWork wk = dkv_item(p, w);
        if (wk.n_tiles == 0) continue;
        if (lane == 0) {
          const int kb = kn % L::kKVBufs;
          mbar_wait(bar_kve + 8 * kb, ((kn / L::kKVBufs) & 1) ^ 1);
          mbar_expect_tx(bar_kv + 8 * kb, 2 * L::kKVBytes);
#pragma unroll
          for (int pn = 0; pn < L::kPanels; ++pn) {
            const uint32_t off = kb * L::kKVBytes + pn * L::kKVPanel;
            tma_load_4d(sK + off, &tm_k, bar_kv + 8 * kb, 64 * pn, wk.k0, wk.hk, wk.b);
            tma_load_4d(sV + off, &tm_v, bar_kv + 8 * kb, 64 * pn, wk.k0, wk.hk, wk.b);
          }
        }
        ++kn;
        for (int h = wk.hk * group; h < (wk.hk + 1) * group; ++h) {
          const int64_t bh = int64_t(wk.b) * p.H + h;
          for (int qi = 0; qi < wk.n_qt; ++qi, ++it) {
            const int s = it % L::kStages, q0 = wk.qt0 + qi * kTileQ;
            mbar_wait(bar_e + 8 * s, ((it / L::kStages) & 1) ^ 1);
            if (lane == 0) {
              mbar_expect_tx(bar_f + 8 * s, 2 * L::kTileBytes);
#pragma unroll
              for (int pn = 0; pn < L::kPanels; ++pn) {
                const uint32_t off = s * L::kTileBytes + pn * L::kTPanel;
                tma_load_4d(sQ + off, &tm_q, bar_f + 8 * s, 64 * pn, q0, h, wk.b);
                tma_load_4d(sDO + off, &tm_do, bar_f + 8 * s, 64 * pn, q0, h, wk.b);
              }
            }
            float* const ls = rows + s * 2 * kTileQ;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * lane + e, row = q0 + i;
              ls[i] = row < p.S ? p.lse[bh * p.S + row] * kLog2e : 0.f;
              ls[kTileQ + i] = row < p.S ? p.delta[bh * p.S + row] : 0.f;
            }
            mbar_arrive(bar_f + 8 * s);  // releases this lane's stores to the consumers
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;  // keys [64c, 64c + 64) of each item
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r_lo = 16 * warp + g;  // this thread's keys: r_lo and r_lo + 8
    const float sl2 = p.scale * kLog2e;

    float dk[kD / 2], dv[kD / 2];                     // dK and dV of this thread's two keys
    float sc[kTileQ / 2], dp[kTileQ / 2];             // S^T, then P^T; dP^T, then dS^T
    uint32_t pa[kTileQ / 16][4], da[kTileQ / 16][4];  // the tile before's P^T, dS^T in bf16
    int key_lo = 0;                                   // the consumer's first key
    uint32_t sKc = sK, sVc = sV;                      // the item's K and V buffers

    // S^T = K Q^T and dP^T = V dO^T of stage s
    auto issue_sdp = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_ss<kTileQ>(sc, desc_k(sKc, L::kKVPanel, 64 * c, kk),
                       desc_k(sQ + s * L::kTileBytes, L::kTPanel, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_ss<kTileQ>(dp, desc_k(sVc, L::kKVPanel, 64 * c, kk),
                       desc_k(sDO + s * L::kTileBytes, L::kTPanel, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of stage s: dO's and Q's rows are B's
    // K axis (MN-major), 16 queries a step
    auto issue_dkv = [&](int s) {
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileQ / 16; ++kk) {
        mma_rs<kD>(dv, pa[kk], desc_mn(sDO + s * L::kTileBytes, L::kTPanel, kk));
        mma_rs<kD>(dk, da[kk], desc_mn(sQ + s * L::kTileBytes, L::kTPanel, kk));
      }
      wgmma_commit();
    };
    // P^T into sc and dS^T into dp for the query tile at q0 of stage s; the
    // mask only where the tile crosses S or T, the causal diagonal or the
    // window's edge.  Query column q0 + col sees a key at q0 + d (d < T -
    // q0) where col < S - q0, col >= d (causal) and col < d + window: where
    // lo < col <= hi, the bounds clamped to [-1, kTileQ] and taken less
    // this lane's 2t.  Hidden pairs get P = 0 by selection.
    auto grad = [&](int s, int q0) {
      fence_regs(sc);
      fence_regs(dp);
      const float* ls = rows + s * 2 * kTileQ;
      const int key_last = key_lo + 63;
      const bool inside = q0 + kTileQ <= p.S && key_last < p.T &&
                          (!p.causal || q0 >= key_last) &&
                          (!p.has_window || q0 + kTileQ - 1 - key_lo < p.window);
      auto body = [&](auto masked) {
        [[maybe_unused]] int hi[2], lo[2];
        if constexpr (decltype(masked)::value) {
          const int col_last = min(p.S - q0, kTileQ) - 1;
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const int64_t key = int64_t(key_lo) + r_lo + 8 * ri, d = key - q0;
            const int h_win = p.has_window ? hopper::clamp_col<kTileQ>(d + p.window - 1) : kTileQ;
            hi[ri] = (key < p.T ? min(h_win, col_last) : -1) - 2 * t;
            lo[ri] = (p.causal ? hopper::clamp_col<kTileQ>(d - 1) : -1) - 2 * t;
          }
        }
#pragma unroll
        for (int j = 0; j < kTileQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
          const float2 dl = *reinterpret_cast<const float2*>(ls + kTileQ + 8 * j + 2 * t);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 4 * j + x;
            float pr = ex2(fmaf(sc[i], sl2, -(x % 2 ? l2.y : l2.x)));
            if constexpr (decltype(masked)::value) {
              const int col = 8 * j + x % 2;  // less 2t
              if (col > hi[x / 2] || col <= lo[x / 2]) pr = 0.f;
            }
            sc[i] = pr;
            dp[i] = pr * (dp[i] - (x % 2 ? dl.y : dl.x));
          }
        }
      };
      if (inside) {
        body(std::false_type{});
      } else {
        body(std::true_type{});
      }
    };

    int it = 0, kn = 0;  // tiles and K/V loads so far, as the producer counts them
    for (int r = 0, w; (w = item_of_round(r)) < n_items; ++r) {
      const DkvWork wk = dkv_item(p, w);
      key_lo = wk.k0 + 64 * c;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

      // Tile i's S^T and dP^T run while tile i - 1's dV and dK products do
      if (wk.n_tiles > 0) {
        const int kb = kn % L::kKVBufs;
        sKc = sK + kb * L::kKVBytes;
        sVc = sV + kb * L::kKVBytes;
        mbar_wait(bar_kv + 8 * kb, (kn / L::kKVBufs) & 1);
        ++kn;
        int s = it % L::kStages, qi = 0;  // qi: the query tile of the newest tile
        mbar_wait(bar_f + 8 * s, (it / L::kStages) & 1);
        issue_sdp(s);
        wgmma_wait<0>();
        grad(s, wk.qt0);
        pack_a(pa, sc);
        pack_a(da, dp);
        for (int i = 1; i < wk.n_tiles; ++i) {
          if (++qi == wk.n_qt) qi = 0;  // the next query head's first tile
          const int s_prev = s;
          s = ++it % L::kStages;
          mbar_wait(bar_f + 8 * s, (it / L::kStages) & 1);
          issue_sdp(s);
          issue_dkv(s_prev);
          wgmma_wait<1>();  // S^T_i and dP^T_i are done, tile i - 1's products may still run
          grad(s, wk.qt0 + qi * kTileQ);
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          mbar_arrive(bar_e + 8 * s_prev);
          pack_a(pa, sc);
          pack_a(da, dp);
        }
        mbar_arrive(bar_kve + 8 * kb);  // every product that reads K and V is done
        issue_dkv(s);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        mbar_arrive(bar_e + 8 * s);
        ++it;
      }

      // dk = scale dK and dv = dV in bf16, in their layouts; zeros for keys
      // that no query sees
      __nv_bfloat16* ok = static_cast<__nv_bfloat16*>(p.dk) + wk.b * p.dk_sb + wk.hk * p.dk_sh;
      __nv_bfloat16* ov = static_cast<__nv_bfloat16*>(p.dv) + wk.b * p.dv_sb + wk.hk * p.dv_sh;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int key = key_lo + r_lo + 8 * ri;
        if (key >= p.T) continue;
        __nv_bfloat16* krow = ok + key * p.dk_st + 2 * t;
        __nv_bfloat16* vrow = ov + key * p.dv_st + 2 * t;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
              dk[4 * j + 2 * ri] * p.scale, dk[4 * j + 2 * ri + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
              __floats2bfloat162_rn(dv[4 * j + 2 * ri], dv[4 * j + 2 * ri + 1]);
        }
      }
    }
  }
}

// The four tensor maps of one call: q and dout in boxes of q_rows rows,
// k and v in boxes of k_rows.  Returns a cudaError_t.
template <int kD>
int encode_maps(const Params& p, int q_rows, int k_rows, CUtensorMap (&tm)[4]) {
  using hopper::encode_bhsd;
  int err = encode_bhsd(&tm[0], p.q, p.B, p.H, p.S, kD, p.q_sb, p.q_sh, p.q_ss, q_rows);
  if (err == 0) {
    err = encode_bhsd(&tm[1], p.dout, p.B, p.H, p.S, kD, p.do_sb, p.do_sh, p.do_ss, q_rows);
  }
  if (err == 0) {
    err = encode_bhsd(&tm[2], p.k, p.B, p.Hkv, p.T, kD, p.k_sb, p.k_sh, p.k_st, k_rows);
  }
  if (err == 0) {
    err = encode_bhsd(&tm[3], p.v, p.B, p.Hkv, p.T, kD, p.v_sb, p.v_sh, p.v_st, k_rows);
  }
  return err;
}

template <int kD>
int launch_dq(const Params& p, cudaStream_t stream) {
  CUtensorMap tm[4];
  const int err = encode_maps<kD>(p, kBlockM, DqLayout<kD>::kN, tm);
  if (err != 0) return err;
  static int sms[hopper::kMaxDevices] = {};
  void* args[] = {&tm[0], &tm[1], &tm[2], &tm[3], const_cast<Params*>(&p)};
  return hopper::launch_persistent(flash_bwd_dq_hopper<kD>, sms, dq_items(p), kThreads,
                                   DqLayout<kD>::kSmem, args, stream);
}

template <int kD>
int launch_dkv(const Params& p, cudaStream_t stream) {
  CUtensorMap tm[4];
  const int err = encode_maps<kD>(p, kTileQ, kBlockM, tm);
  if (err != 0) return err;
  static int sms[hopper::kMaxDevices] = {};
  void* args[] = {&tm[0], &tm[1], &tm[2], &tm[3], const_cast<Params*>(&p)};
  return hopper::launch_persistent(flash_bwd_dkv_hopper<kD>, sms, dkv_items(p), kThreads,
                                   DkvLayout<kD>::kSmem, args, stream);
}

}  // namespace bwd_hopper

// ------------------------------------------------------------- launch
template <int kD>
int launch_dq(int dtype, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.B * p.H);
  if (dtype == 1) {
    return launch(dq_bf16<kD>, grid, sizeof(__nv_bfloat16) * 4 * 64 * (kD + 8), p, stream);
  }
  return launch(dq_f32<kD>, grid, sizeof(float) * (4 * 64 * (kD + 1) + 64 * 65), p, stream);
}

template <int kD>
int launch_dkv(int dtype, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.T + kBlockK - 1) / kBlockK, p.B * p.Hkv);
  if (dtype == 1) {
    return launch(dkv_bf16<kD>, grid,
                  sizeof(__nv_bfloat16) * 4 * 64 * (kD + 8) + sizeof(float) * 2 * 64, p, stream);
  }
  return launch(dkv_f32<kD>, grid,
                sizeof(float) * (4 * 64 * (kD + 1) + 2 * 64 * 65 + 2 * 64), p, stream);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int64_t* dims,
                   const int64_t* strides, int causal, int has_window, int64_t window,
                   float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.Hkv = static_cast<int>(dims[2]);
  p.S = static_cast<int>(dims[3]);
  p.T = static_cast<int>(dims[4]);
  p.D = static_cast<int>(dims[5]);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_st = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_st = strides[8];
  p.do_sb = strides[9], p.do_sh = strides[10], p.do_ss = strides[11];
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dims: B, H, Hkv, S, T, D.  strides (in
// elements; every last axis is contiguous): q b,h,s; k b,h,t; v b,h,t;
// dout b,h,s; then the outputs': dq b,h,s (the dq entry points) or dk
// b,h,t and dv b,h,t (the dk/dv ones).  lse and delta (B*H, S) float32,
// contiguous.  flash_attention_bwd_dq and _dkv launch the mma.sync (bf16)
// or float32 kernels; flash_attention_bwd_dq_hopper and _dkv_hopper the
// Hopper ones, which take bf16 with D 64 or 128, q, k, v and dout 16-byte
// aligned with strides of 16-byte multiples on every axis longer than 1,
// and at most 2**30 work items (ceil(S / 128) x B x H for dq, ceil(T /
// 128) x B x Hkv for dk/dv).  Each returns a cudaError_t: 0 when the
// launch was taken; 1 (cudaErrorInvalidValue) for an input its kernels do
// not take or a tensor map the driver refuses; 801 (cudaErrorNotSupported)
// where the driver has no cuTensorMapEncodeTiled.
namespace {

Params dq_params(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, const int64_t* dims,
                 const int64_t* strides, int causal, int has_window, int64_t window,
                 float scale) {
  Params p = make_params(q, k, v, dout, lse, delta, dims, strides, causal, has_window, window,
                         scale);
  p.dq = dq;
  p.dq_sb = strides[12], p.dq_sh = strides[13], p.dq_ss = strides[14];
  return p;
}

Params dkv_params(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, const int64_t* dims,
                  const int64_t* strides, int causal, int has_window, int64_t window,
                  float scale) {
  Params p = make_params(q, k, v, dout, lse, delta, dims, strides, causal, has_window, window,
                         scale);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = strides[12], p.dk_sh = strides[13], p.dk_st = strides[14];
  p.dv_sb = strides[15], p.dv_sh = strides[16], p.dv_st = strides[17];
  return p;
}

int run_dq(const Params& p, int dtype, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p.D <= 32) return launch_dq<32>(dtype, p, s);
  if (p.D <= 64) return launch_dq<64>(dtype, p, s);
  if (p.D <= 128) return launch_dq<128>(dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run_dkv(const Params& p, int dtype, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p.D <= 32) return launch_dkv<32>(dtype, p, s);
  if (p.D <= 64) return launch_dkv<64>(dtype, p, s);
  if (p.D <= 128) return launch_dkv<128>(dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run_dq_hopper(const Params& p, int dtype, cudaStream_t s) {
  if (dtype != 1 || bwd_hopper::dq_items(p) > bwd_hopper::kMaxItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.D == 64) return bwd_hopper::launch_dq<64>(p, s);
  if (p.D == 128) return bwd_hopper::launch_dq<128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run_dkv_hopper(const Params& p, int dtype, cudaStream_t s) {
  if (dtype != 1 || bwd_hopper::dkv_items(p) > bwd_hopper::kMaxItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.D == 64) return bwd_hopper::launch_dkv<64>(p, s);
  if (p.D == 128) return bwd_hopper::launch_dkv<128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq_out, int dtype, const int64_t* dims,
                                      const int64_t* strides, int causal, int has_window,
                                      int64_t window, float scale, void* stream) {
  return run_dq(dq_params(q, k, v, dout, lse, delta, dq_out, dims, strides, causal, has_window,
                      window, scale),
            dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq_hopper(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dq_out, int dtype,
                                             const int64_t* dims, const int64_t* strides,
                                             int causal, int has_window, int64_t window,
                                             float scale, void* stream) {
  return run_dq_hopper(dq_params(q, k, v, dout, lse, delta, dq_out, dims, strides, causal,
                             has_window, window, scale),
                   dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int dtype, const int64_t* dims,
                                       const int64_t* strides, int causal, int has_window,
                                       int64_t window, float scale, void* stream) {
  return run_dkv(dkv_params(q, k, v, dout, lse, delta, dk, dv, dims, strides, causal, has_window,
                        window, scale),
             dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv_hopper(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse,
                                              const float* delta, void* dk, void* dv, int dtype,
                                              const int64_t* dims, const int64_t* strides,
                                              int causal, int has_window, int64_t window,
                                              float scale, void* stream) {
  return run_dkv_hopper(dkv_params(q, k, v, dout, lse, delta, dk, dv, dims, strides, causal,
                               has_window, window, scale),
                    dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
