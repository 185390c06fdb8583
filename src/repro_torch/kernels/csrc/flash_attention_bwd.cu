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
// revisiting becomes a loop inside one block with the accumulator in
// registers:
//   - dq: one block per (64-row query tile, batch x query head); it walks
//     the key tiles its rows can see, recomputes S and P from lse, forms
//     dP = dO.V^T and dS, and accumulates dQ += dS.K.
//   - dk/dv: one block per (64-row key tile, batch x kv head); it walks the
//     g query heads of its group and, for each, the query tiles that can
//     see its keys (causal: the tiles at or after it), and accumulates
//     dV += P^T.dO and dK += dS^T.Q.  The group sum happens in registers:
//     no expanded K and V, no second pass, no atomics.  Every output is
//     written by one thread in a fixed order of sums, so the step is
//     deterministic (a resumed run repeats an uninterrupted one bitwise).
// bfloat16 runs on the tensor cores (mma.sync.m16n8k16, 4 warps of 16
// rows each, the fragment helpers of flash_common.cuh; P and dS are
// rounded to bf16 as the A operand of the second products).  float32 runs
// on CUDA cores in full float32: each thread owns 4 rows x 8 columns of the
// 64 x 64 score tile and 4 rows x D/8 columns of the outputs.  head_dim is
// padded with zeros to 32, 64 or 128 in shared memory.  No TMA, wgmma,
// cp.async or double buffering yet.
//
// Bound at the training shape, q (4, 15, 2048, 64) and k/v (4, 5, 2048, 64)
// bf16, causal, 2,098,176 pairs per head, 60 query heads: the dq kernel
// does three products of 2 * 64 flops per pair (S, dP, dS.K), 48.3 GFLOP,
// 48.9 us at 989 TFLOP/s of bf16 tensor cores; the dk/dv kernel four (S,
// dP, P^T.dO, dS^T.Q), 64.4 GFLOP, 65.1 us.  Their bytes (q, k, v, dO, lse,
// delta read once, the outputs written once) are 58.7 and 53.4 MB, 17.5 and
// 15.9 us at 3.35 TB/s (H100 SXM data sheet, 700 W): operations bound both.
//
// Plain C entry points, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <math_constants.h>

#include "flash_common.cuh"

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
// dout b,h,s; then the outputs': dq b,h,s (flash_attention_bwd_dq) or dk
// b,h,t and dv b,h,t (flash_attention_bwd_dkv).  lse and delta (B*H, S)
// float32, contiguous.  Returns a cudaError_t: 0 when the launch was taken;
// 1 (cudaErrorInvalidValue) for a D above 128 or an unknown dtype.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int dtype, const int64_t* dims,
                                      const int64_t* strides, int causal, int has_window,
                                      int64_t window, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, dims, strides, causal, has_window, window,
                         scale);
  p.dq = dq;
  p.dq_sb = strides[12], p.dq_sh = strides[13], p.dq_ss = strides[14];
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D <= 32) return launch_dq<32>(dtype, p, s);
  if (p.D <= 64) return launch_dq<64>(dtype, p, s);
  if (p.D <= 128) return launch_dq<128>(dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int dtype, const int64_t* dims,
                                       const int64_t* strides, int causal, int has_window,
                                       int64_t window, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, dims, strides, causal, has_window, window,
                         scale);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = strides[12], p.dk_sh = strides[13], p.dk_st = strides[14];
  p.dv_sb = strides[15], p.dv_sh = strides[16], p.dv_st = strides[17];
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D <= 32) return launch_dkv<32>(dtype, p, s);
  if (p.D <= 64) return launch_dkv<64>(dtype, p, s);
  if (p.D <= 128) return launch_dkv<128>(dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
