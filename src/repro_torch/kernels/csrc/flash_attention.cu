// Flash attention, forward, on Hopper (sm_90a): one thread block per
// (64-row query tile, batch x query head).
//
// Replaces two TPU kernels and computes what they compute:
//   - flash_attention / _kernel of src/repro/kernels/flash_attention.py
//     (serving), and
//   - flash_attention_fwd_lse / _fwd_kernel of
//     src/repro/kernels/flash_attention_bwd.py (training: it also writes
//     each row's logsumexp, the one residual the backward kernels of
//     flash_attention_bwd.cu keep).
// Both go through the one entry point flash_attention_fwd; lse is written
// where its pointer is not null.
//   o[b,h,s] = softmax_t(q[b,h,s] . k[b,h//g,t] / sqrt(D), masked) @ v[b,h//g]
// with GQA through the head index (K and V are never expanded), the masks
// t < T, causal t <= q_offset + s and window q_offset + s - t < window,
// float32 running max, denominator and accumulator, P cast to the input
// type before P.V, and the output in the input type.
//
// Design.  The TPU kernel walks the KV tiles as the sequential grid axis
// and keeps (m, l, acc) in VMEM scratch across it; here the block walks its
// KV tiles in a loop and keeps them in registers.  Tiles that the masks
// leave empty for every row of the block are not visited (the TPU kernel
// runs them masked; the result is the same).  Two kernels:
//   - bfloat16 (the serving and training paths): 4 warps, each owns 16
//     query rows and runs mma.sync.m16n8k16 on the tensor cores: S = Q.K^T
//     from Q held in registers and K in shared memory, the online softmax
//     on the accumulator fragments, then P (rounded to bf16, in registers:
//     the accumulator layout of S is the A layout of P.V) times V from
//     shared memory.  head_dim is padded with zeros to 32, 64 or 128 in
//     shared memory, so a ragged D (the smoke config's 20) costs only the
//     padding.
//   - float32 (tests and the card-against-CPU checks): the same tiling on
//     CUDA cores, each thread owning 4 rows x 8 key columns of S and
//     4 rows x D/8 columns of the output, in full float32 (no TF32).
// No TMA, wgmma, cp.async or double buffering yet: each tile is loaded
// with plain loads (16 bytes a thread on the model's paths) and one barrier.
//
// lse[b*H + h, s] = m + log(l), the row's max scaled score plus the log of
// its softmax denominator, in float32, written once per row after the KV
// loop; deterministic, so a recomputation under activation checkpointing
// gives the same bits.  A row with no valid key (never on the model's
// paths: causal rows see themselves) returns zeros and lse = -inf: its
// running denominator stays 0 and masked scores add nothing.  The backward
// kernels give such a row zero gradients (every pair it has is masked).
// The TPU kernels return the mean of V over the keys of the tiles they ran
// there, and their oracle the mean of V over all keys.
//
// Bound at the serving path's prefill shape, q (8, 15, 512, 64) and k/v
// (8, 5, 512, 64) bf16, causal: it must read q, k, v and write o once,
// 20.97 MB, which takes 6.26 us at 3.35 TB/s; the 131,328 causal pairs per
// head cost 4 * 8 * 15 * 64 * 131,328 = 4.03 GFLOP, 4.08 us at 989 TFLOP/s
// of bf16 tensor cores (H100 SXM data sheet, 700 W).  So bytes bound it.
// At the training shape, q (4, 15, 2048, 64) and k/v (4, 5, 2048, 64)
// bf16, causal, the 2,098,176 pairs per head cost 32.2 GFLOP (32.6 us)
// against 42.4 MB of bytes (12.7 us): operations bound it there.
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

// The range [k_begin, k_end) of keys that some row of query tile q0 may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* k_begin, int* k_end) {
  const int64_t qa_lo = p.q_offset + q0;
  const int64_t qa_hi = p.q_offset + min(q0 + kBlockQ, p.S) - 1;
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

int forward(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
            const int64_t* dims, const int64_t* strides, int causal, int has_window,
            int64_t window, int64_t q_offset, float scale, void* stream) {
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
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D <= 32) return launch_dtype<32>(dtype, p, s);
  if (p.D <= 64) return launch_dtype<64>(dtype, p, s);
  if (p.D <= 128) return launch_dtype<128>(dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dims: B, H, Hkv, S, T, D.  strides (in
// elements; the last axis is contiguous): q b,h,s; k b,h,t; v b,h,t; o b,h,s.
// lse: (B*H, S) float32, contiguous, or null (serving: not written).
// Returns a cudaError_t: 0 when the launch was taken; 1
// (cudaErrorInvalidValue) for a D above 128 or an unknown dtype.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, const int64_t* dims,
                                   const int64_t* strides, int causal, int has_window,
                                   int64_t window, int64_t q_offset, float scale, void* stream) {
  return forward(q, k, v, o, lse, dtype, dims, strides, causal, has_window, window, q_offset,
                 scale, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
