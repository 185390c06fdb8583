// The backward of the Mamba-1 selective scan on Hopper (sm_90a): the reverse
// loop over the sequence inside the threads, the states of each channel
// split over four lanes.
//
// The JAX package has no Pallas backward for its scan: it differentiates
// the pure-jnp selective_scan (src/repro/models/ssm.py) with jax.vjp, while
// its forward is the TPU kernel ssm_scan (src/repro/kernels/ssm_scan.py).
// The port's forward is a kernel (csrc/ssm_scan.cu), so its gradient is one
// too.  With a_t = exp(dt_t A), g_t = dL/dy_t and dh_final seeding the
// state's adjoint at the last step, it computes the VJP of
//   h_t = a_t * h_{t-1} + dt_t * B_t * x_t,   y_t = C_t . h_t + D * x_t
// as the reverse recurrence
//   dh_t  = g_t (x) C_t + a_{t+1} * dh_{t+1}
//   dC_t  = sum_d g_t h_t                dB_t = sum_d dh_t dt_t x_t
//   dx_t  = sum_n dh_t dt_t B_t + D g_t
//   ddt_t = sum_n dh_t (x_t B_t + A a_t h_{t-1})
//   dA    = sum_{b,t} dh_t dt_t a_t h_{t-1}
//   dD    = sum_{b,t} g_t x_t            dh0 = a_1 * dh_1
// (the plain version: kernels/ref.py, ssm_scan_bwd_ref), dx in x's type and
// the rest in float32.
//
// Both kernels below share what is hard about the function:
//
// - h_{t-1}.  The reverse loop needs each step's previous state, and
//   dividing by a_t would not give it back (A is learned and exp(dt A)
//   underflows).  So the states are recomputed forward from a float32
//   checkpoint of the state at the start of every kSeg-step segment: the
//   kernel walks the segments in reverse, recomputes each segment's kSeg
//   states from its checkpoint and then runs the segment's steps in
//   reverse from them.  The checkpoints are B ceil(S / kSeg) D N floats
//   (N / 2 B S D bytes: 537 MB at falcon-mamba-7b's training shape, x (4,
//   2048, 8192) with N 16).  The hopper kernel reads those that the
//   training forward wrote (ssm_scan_train_hopper in csrc/ssm_scan.cu);
//   the strided kernel writes its own in a first pass from h0.
// - dB_t and dC_t are sums over every channel at every step and state: each
//   block sums its channels' terms, in a fixed order, into a scratch of
//   (B, blocks, S, 2N) partials, which a second kernel (sum_over_middle)
//   sums over the blocks in order.  dA and dD sum over batch and time: each
//   thread keeps its channel's sums over time in registers, and the same
//   second kernel sums the (B, D, N) and (B, D) partials over the batch.
// - Determinism: no atomics; every sum runs in a fixed order, so two calls
//   on the same inputs give the same bits.
//
// Bound at the training shape, x and dy (4, 2048, 8192) bf16, dt float32,
// N 16: the function must read x, dt, dy, B and C and write dx, ddt, dB
// and dC (0.94 GB, 0.28 ms at 3.35 TB/s), take B*S*D*N = 1.07 G
// exponentials (0.257 ms at 16 a clock on 132 SMs at 1.98 GHz) and 18
// float32 flops per state and step (seven FMAs and four products: the
// exponent, a_t h_{t-1}, h_t, dh_t, the three sums' terms dB, dC, dx, the
// shared dh a_t h_{t-1} and its two sums, the carried adjoint; 0.29 ms at
// 67 TFLOP/s).
//
// ssm_scan_bwd_hopper (the model's layouts: those that the training
// forward's hopper kernel takes, whose checkpoints it reads, with dy too
// at a 16-byte-aligned base, a contiguous last axis and the other strides
// multiples of 16 bytes, an axis of length 1 exempt; D a multiple of 8).
// What held its predecessor (below) to 5.8% of the bound, and what this
// design does about each:
//
// 1. Too few warps: one thread a channel gave the training shape 32,768
//    threads, about two warps a scheduler at its 254 registers, too few to
//    hide a step's dependences (the exponential, the carried adjoint).
//    Here four lanes share a channel, each holding kS = N / 4 of its
//    states (4 at N 16, 1 at N 4): 131,072 threads at the training shape.
//    A block is 128 channels, 512 threads, capped at 128 registers
//    (__launch_bounds__(512, 1)), so each SM holds 16 warps, four a
//    scheduler.  dx's and ddt's sums over the states become a fixed
//    two-level xor shuffle across the channel's four lanes (a transposing
//    first level: one lane keeps dx's sum, its neighbour ddt's).
// 2. Three exponentials a state and step: the first pass, the
//    recomputation and the reverse step each took one.  Here the first
//    pass is gone: the forward (ssm_scan_train_hopper in csrc/ssm_scan.cu)
//    writes the checkpoints as it runs the recurrence, and the kernel
//    requires them.  The recomputation keeps a_t and a_t h_{t-1} of the
//    segment's kSeg steps in registers at constant indices (a fully
//    unrolled segment, 2 kSeg kS registers), and the reverse step reads
//    them: one exponential a state and step.
// 3. A 16 KB shared tile of states a warp, and a 31-shuffle butterfly a
//    step for dB_t and dC_t over 32 lanes.  Here no states go to shared
//    memory; each lane's 2 kS terms (its states' dB and dC terms) are
//    summed over the warp's eight channels by a transposing butterfly over
//    the lane bits that name the channel (7 shuffles at N 16), the warps'
//    sums go to shared memory, and after each segment's one block barrier
//    the block sums them over its 16 warps in order.  One partial a block
//    of 128 channels and step: 67 MB at the training shape, not 268 MB.
// 4. Inputs and outputs: each segment's x, dt and dy are loaded a segment
//    ahead, one 16-byte vector a lane for a warp's eight channels (at
//    bf16), and after the segment's steps go into shared memory as (x,
//    dt, g) per channel and step, read back with one 16-byte load a lane
//    and step; each segment's B and C a segment ahead into a double
//    buffer; the next checkpoint while the segment runs in reverse.  dx
//    and ddt go through shared memory too, and after the barrier out to
//    their rows 16 bytes a thread, not 2 or 4 bytes a lane and step.
//
// ssm_scan_bwd_strided (every other layout; the first design): one thread a
// (batch, channel), one warp of 32 channels a block; x, dt, dy, B and C
// read through their strides; the segment's states in a shared tile; three
// exponentials a state and step; each warp's dB and dC terms summed by a
// 31-shuffle transposing butterfly into (B, ceil(D / 32), S, 2N) partials.
//
// Plain C entry points, loaded with ctypes; each launches its scan kernel
// and the three sums on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_common.cuh"

namespace {

constexpr int kLanes = 32;  // channels per block of the strided kernel: one warp
constexpr int kSeg = 8;     // steps per segment: a checkpoint every kSeg steps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSumThreads = 256;

struct Params {
  const void* x;         // (B, S, D) float32 or bf16, strided
  const float* dt;       // (B, S, D), strided
  const float* A;        // (D, N) contiguous
  const float* Bc;       // (B, S, N), strided
  const float* Cc;       // (B, S, N), strided
  const float* Dv;       // (D,) contiguous
  const float* h0;       // (B, D, N) contiguous, or null
  const void* dy;        // (B, S, D) x's type, strided
  const float* dh_final; // (B, D, N) contiguous, or null
  void* dx;              // (B, S, D) contiguous, x's type
  float* ddt;            // (B, S, D) contiguous
  float* dh0;            // (B, D, N) contiguous
  float* ckpt;           // checkpoints: (B, segments, N, D) strided scratch, (B, segments, D, N)
                         // hopper, the training forward's
  float* bc_part;        // (B, blocks, S, 2N) scratch: each block's dB_t, dC_t
  float* a_part;         // (B, D, N) scratch: dA summed over time
  float* d_part;         // (B, D) scratch: dD summed over time
  int64_t S, Dm;
  int64_t x_sb, x_ss, x_sd;
  int64_t dt_sb, dt_ss, dt_sd;
  int64_t b_sb, b_ss, b_sn;
  int64_t c_sb, c_ss, c_sn;
  int64_t g_sb, g_ss, g_sd;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------ ssm_scan_bwd_hopper
namespace hop {

constexpr int kQ = 4;                     // lanes a channel, each with N / kQ states
constexpr int kChannels = 128;            // channels a block
constexpr int kThreads = kChannels * kQ;  // 512
constexpr int kWarps = kThreads / 32;     // 16
constexpr int kWarpChannels = 32 / kQ;    // 8
constexpr int kRow = 4 * kChannels + 4;   // floats a step of the (x, dt, g) tile, padded

template <int kN>
constexpr int kSmemFloats =
    kSeg * kRow + 2 * kSeg * 2 * kN + 2 * kSeg * kWarps * 2 * kN + 2 * kSeg * 2 * kChannels;

// One level of the transposing butterfly over the lanes that hold the same
// states of the warp's channels (lane bits 4, 3, 2): each lane keeps one
// half of its kHalf * 2 running sums (the upper half where its lane bit
// kMask is set), adds the partner lane's copy of that half to it, and
// sends the other half; then the next level over the kept half and the
// next lane bit.  Templates, so that every index into v is a constant.
template <int kHalf, int kMask, int kV>
__device__ __forceinline__ void channel_butterfly(float (&v)[kV], int lane) {
  if constexpr (kHalf > 0) {
    const bool upper = (lane & kMask) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
    }
    channel_butterfly<kHalf / 2, kMask / 2, kV>(v, lane);
  }
}

// The warp's sum over its eight channels of v[k], k = lane / (32 / kV):
// the transposing butterfly over the top log2(kV) channel bits, then plain
// xor levels over the channel bits left (none at kV 8).  Fixed order.
template <int kV>
__device__ __forceinline__ float channel_sum(float (&v)[kV], int lane) {
  channel_butterfly<kV / 2, 16, kV>(v, lane);
  float r = v[0];
#pragma unroll
  for (int m = 16 / kV; m >= kQ; m /= 2) r += __shfl_xor_sync(0xffffffffu, r, m);
  return r;
}

// 16-byte vectors of one segment's x, dt and dy for a warp's 8
// channels: per step kVx vectors of x, 2 of dt and kVx of dy, spread over
// the lanes, kVecs a lane.
template <typename T>
struct Vectors {
  static constexpr int kVx = 8 * static_cast<int>(sizeof(T)) / 16;  // 1 bf16, 2 float32
  static constexpr int kPerStep = 2 * kVx + 2;
  static constexpr int kVecs = (kSeg * kPerStep + 31) / 32;
  uint4 v[kVecs];
};

// Which tensor (0 x, 1 dt, 2 dy), step and first channel (of the warp's 8)
// vector i of a lane holds; false past the segment's vectors.
template <typename T>
__device__ __forceinline__ bool vector_slot(int lane, int i, int& which, int& j, int& ch) {
  constexpr int kVx = Vectors<T>::kVx;
  const int v = lane + 32 * i;
  if (v >= kSeg * Vectors<T>::kPerStep) return false;
  j = v / Vectors<T>::kPerStep;
  int u = v - j * Vectors<T>::kPerStep;
  if (u < kVx) {
    which = 0;
    ch = u * 16 / static_cast<int>(sizeof(T));
  } else if (u < kVx + 2) {
    which = 1;
    ch = (u - kVx) * 4;
  } else {
    which = 2;
    ch = (u - kVx - 2) * 16 / static_cast<int>(sizeof(T));
  }
  return true;
}

// Load segment s's vectors for the warp whose first channel is d0 (zeros
// past the sequence and on an inactive warp).
template <typename T>
__device__ __forceinline__ void fetch(const Params& p, int64_t b, int64_t d0, bool active,
                                      int64_t s, int lane, Vectors<T>& in) {
  const int64_t t0 = s * kSeg;
#pragma unroll
  for (int i = 0; i < Vectors<T>::kVecs; ++i) {
    int which = 0, j = 0, ch = 0;
    in.v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (!vector_slot<T>(lane, i, which, j, ch) || !active || t0 + j >= p.S) continue;
    const int64_t t = t0 + j;
    const void* src;
    if (which == 0) {
      src = static_cast<const T*>(p.x) + b * p.x_sb + t * p.x_ss + d0 + ch;
    } else if (which == 1) {
      src = p.dt + b * p.dt_sb + t * p.dt_ss + d0 + ch;
    } else {
      src = static_cast<const T*>(p.dy) + b * p.g_sb + t * p.g_ss + d0 + ch;
    }
    in.v[i] = __ldg(static_cast<const uint4*>(src));
  }
}

// A segment's vectors into the warp's columns of the (x, dt, g) tile:
// xs[j * kRow + 4 c + which] for channel c of the block.  The caller makes
// sure the warp's lanes are done with the tile's previous segment.
template <typename T>
__device__ __forceinline__ void commit(const Vectors<T>& in, int lane, int c0, float* xs) {
#pragma unroll
  for (int i = 0; i < Vectors<T>::kVecs; ++i) {
    int which = 0, j = 0, ch = 0;
    if (!vector_slot<T>(lane, i, which, j, ch)) continue;
    float* dst = xs + j * kRow + 4 * (c0 + ch) + which;
    if (which == 1 || sizeof(T) == 4) {
      const float* f = reinterpret_cast<const float*>(&in.v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[4 * e] = f[e];
    } else {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&in.v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[4 * e] = __bfloat162float(h[e]);
    }
  }
}

// One value of segment s's B and C for thread tid < kSeg * 2N: element
// (j, k) of the (kSeg, 2N) block [B_t | C_t], 0 past the sequence.
template <int kN>
__device__ __forceinline__ float fetch_bc(const Params& p, int64_t b, int64_t s, int tid) {
  if (tid >= kSeg * 2 * kN) return 0.f;
  const int j = tid / (2 * kN);
  const int k = tid - j * 2 * kN;
  const int64_t t = s * kSeg + j;
  if (t >= p.S) return 0.f;
  return k < kN ? p.Bc[b * p.b_sb + t * p.b_ss + k * p.b_sn]
                : p.Cc[b * p.c_sb + t * p.c_ss + (k - kN) * p.c_sn];
}

// kS consecutive floats from 16-byte-aligned memory
template <int kS>
__device__ __forceinline__ void load_states(const float* src, float (&v)[kS]) {
  if constexpr (kS == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < kS; ++i) v[i] = src[i];
  }
}

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads, 1) ssm_scan_bwd_hopper(const Params p) {
  constexpr int kS = kN / kQ;  // states a lane
  constexpr int kV = 2 * kS;   // this lane's dB_t (0..kS-1) and dC_t (kS..2kS-1) terms
  constexpr int kBC = 2 * kN;  // a step's [B_t | C_t]
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [kSeg][kRow]: (x, dt, g, -) per channel
  float* bcs = xs + kSeg * kRow;        // [2][kSeg][2N]: the segment's B and C
  float* red = bcs + 2 * kSeg * kBC;    // [2][kSeg][kWarps][2N]: the warps' dB, dC sums
  float* ost = red + 2 * kSeg * kWarps * kBC;  // [2][kSeg][2][kChannels]: dx and ddt

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q = lane & (kQ - 1);  // this lane's states: q kS .. q kS + kS - 1
  const int cw = warp * kWarpChannels;  // the warp's first channel within the block
  const int c = cw + lane / kQ;         // this lane's channel within the block
  const int64_t b = blockIdx.y;
  const int64_t blk = blockIdx.x;
  const int64_t blocks = gridDim.x;
  const int64_t d0 = blk * kChannels + cw;  // the warp's first channel
  const int64_t d = blk * kChannels + c;
  const bool active = d0 < p.Dm;  // D is a multiple of 8: a warp's channels all or none
  const int64_t segs = (p.S + kSeg - 1) / kSeg;
  const float4* x4 = reinterpret_cast<const float4*>(xs) + c;  // step j at x4[j * kRow / 4]

  float a2[kS];  // A * log2(e): exp(dt * A) = 2**(dt * a2)
  float h[kS];   // the state, recomputed from each segment's checkpoint
  float dd = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    a2[i] = 0.f;
    h[i] = 0.f;
  }
  if (active) {
    dd = p.Dv[d];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      a2[i] = p.A[d * kN + q * kS + i] * kLog2e;
    }
  }
  // this lane's checkpoint of segment s: ck + s * D * N (h0's at segment 0)
  const float* ck = p.ckpt + (b * segs * p.Dm + d) * kN + q * kS;

  // the segments in reverse
  float carry[kS];  // a_{t+1} * dh_{t+1}: the adjoint that reaches h_t from later steps
  float da[kS];     // dA of this channel's states, summed over time
  float dsum = 0.f; // dD of this channel, summed over time
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    carry[i] = active && p.dh_final != nullptr ? p.dh_final[(b * p.Dm + d) * kN + q * kS + i]
                                               : 0.f;
    da[i] = 0.f;
  }
  // after the channel butterfly this lane holds the warp's sum of its term
  // k; one lane of each group that holds the same term writes it
  const int k = lane / (32 / kV);
  const bool writer = ((lane / kQ) & (32 / kV / kQ - 1)) == 0;
  const int term = k < kS ? q * kS + k : kN + q * kS + (k - kS);
  Vectors<T> next;
  float bc_next = 0.f;
  if (segs > 0) {
    fetch<T>(p, b, d0, active, segs - 1, lane, next);
    bc_next = fetch_bc<kN>(p, b, segs - 1, tid);
    commit<T>(next, lane, cw, xs);
    if (tid < kSeg * kBC) bcs[((segs - 1) & 1) * kSeg * kBC + tid] = bc_next;
    if (active) load_states<kS>(ck + (segs - 1) * p.Dm * kN, h);
    __syncthreads();
  }
  for (int64_t s = segs - 1; s >= 0; --s) {
    const int64_t t0 = s * kSeg;
    const int steps = p.S - t0 < kSeg ? static_cast<int>(p.S - t0) : kSeg;
    const int buf = static_cast<int>(s & 1);
    const float* bc = bcs + buf * kSeg * kBC;
    float* rw = red + buf * kSeg * kWarps * kBC;
    float* ow = ost + buf * kSeg * 2 * kChannels;
    if (s > 0) {
      fetch<T>(p, b, d0, active, s - 1, lane, next);
      bc_next = fetch_bc<kN>(p, b, s - 1, tid);
    }
    float sa[kSeg][kS];   // a_t of the segment's steps
    float sah[kSeg][kS];  // a_t h_{t-1}
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {  // the segment's states, forward from its checkpoint
#pragma unroll
      for (int i = 0; i < kS; ++i) sa[j][i] = sah[j][i] = 0.f;
      if (j < steps) {
        const float4 in = x4[j * (kRow / 4)];
        const float dtx = in.y * in.x;
        float bv[kS];
        load_states<kS>(bc + j * kBC + q * kS, bv);
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          sa[j][i] = hopper::ex2(in.y * a2[i]);
          sah[j][i] = sa[j][i] * h[i];
          h[i] = fmaf(dtx, bv[i], sah[j][i]);
        }
      }
    }
    if (s > 0 && active) load_states<kS>(ck + (s - 1) * p.Dm * kN, h);  // the next checkpoint
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {  // the segment's steps, in reverse
      if (j < steps) {
        const float4 in = x4[j * (kRow / 4)];
        const float xv = in.x, dtv = in.y, g = in.z;
        const float dtx = dtv * xv;
        float bv[kS], cv[kS];
        load_states<kS>(bc + j * kBC + q * kS, bv);
        load_states<kS>(bc + j * kBC + kN + q * kS, cv);
        float v[kV];
        float dxs = 0.f;  // sum over this lane's states of dh B
        float dda = 0.f;  // sum over this lane's states of dh a2 a h_{t-1}
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const float ah = sah[j][i];                  // a_t h_{t-1}
          const float dh = fmaf(g, cv[i], carry[i]);   // dh_t
          v[i] = dh * dtx;                             // dB_t's term
          v[kS + i] = g * fmaf(dtx, bv[i], ah);        // dC_t's term: g h_t
          dxs = fmaf(dh, bv[i], dxs);
          const float w = dh * ah;
          dda = fmaf(w, a2[i], dda);
          da[i] = fmaf(w, dtv, da[i]);
          carry[i] = sa[j][i] * dh;
        }
        dsum = fmaf(g, xv, dsum);
        // dx's and ddt's sums over the channel's four lanes: lanes 0 and 2
        // of the four end with dx's, 1 and 3 with ddt's
        const float vx = dxs;
        const float vt = fmaf(xv, dxs, kLn2 * dda);
        const bool odd = (q & 1) != 0;
        float r = (odd ? vt : vx) + __shfl_xor_sync(0xffffffffu, odd ? vx : vt, 1);
        r += __shfl_xor_sync(0xffffffffu, r, 2);
        if (q < 2) ow[(2 * j + q) * kChannels + c] = q == 0 ? fmaf(r, dtv, dd * g) : r;
        const float sum = channel_sum<kV>(v, lane);
        if (writer) rw[(j * kWarps + warp) * kBC + term] = sum;
      }
    }
    if (s > 0) {
      __syncwarp();  // the warp's lanes are done with the tile
      commit<T>(next, lane, cw, xs);
      if (tid < kSeg * kBC) bcs[(buf ^ 1) * kSeg * kBC + tid] = bc_next;
    }
    __syncthreads();
    // the block's dB_t and dC_t: the warps' sums, in order of warp
    float* part = p.bc_part + (b * blocks + blk) * p.S * kBC;
    for (int i = tid; i < kSeg * kBC; i += kThreads) {
      const int j = i / kBC;
      if (j < steps) {
        const int kk = i - j * kBC;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += rw[(j * kWarps + w) * kBC + kk];
        part[(t0 + j) * kBC + kk] = acc;
      }
    }
    // the block's dx and ddt rows of the segment, 16 bytes a thread
    constexpr int kE = 16 / static_cast<int>(sizeof(T));  // dx values a vector
    constexpr int kDxVecs = kChannels / kE;
    constexpr int kStepVecs = kDxVecs + kChannels / 4;
    // the block's first channel of dx and ddt, at step t: + t * D
    T* dx = static_cast<T*>(p.dx) + b * p.S * p.Dm + blk * kChannels;
    float* ddt = p.ddt + b * p.S * p.Dm + blk * kChannels;
    for (int i = tid; i < kSeg * kStepVecs; i += kThreads) {
      const int j = i / kStepVecs;
      const int u = i - j * kStepVecs;
      const bool is_dx = u < kDxVecs;
      const int ch = is_dx ? u * kE : (u - kDxVecs) * 4;
      if (j < steps && blk * kChannels + ch < p.Dm) {
        const int64_t row = (t0 + j) * p.Dm + ch;
        const float* src = ow + (2 * j + (is_dx ? 0 : 1)) * kChannels + ch;
        if (!is_dx || sizeof(T) == 4) {
          float* dst = is_dx ? reinterpret_cast<float*>(dx) + row : ddt + row;
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
          const float4 lo = *reinterpret_cast<const float4*>(src);
          const float4 hi = *reinterpret_cast<const float4*>(src + 4);
          const __nv_bfloat162 v[4] = {
              __floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
              __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
          *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(dx) + row) =
              *reinterpret_cast<const uint4*>(v);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      p.dh0[(b * p.Dm + d) * kN + q * kS + i] = carry[i];
      p.a_part[(b * p.Dm + d) * kN + q * kS + i] = da[i];
    }
    if (q == 0) p.d_part[b * p.Dm + d] = dsum;
  }
}

template <typename T, int kN>
int launch(dim3 grid, cudaStream_t s, const Params& p) {
  constexpr int smem = kSmemFloats<kN> * static_cast<int>(sizeof(float));
  static int ready[hopper::kMaxDevices];  // the shared-memory limit is raised once per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= hopper::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    e = cudaFuncSetAttribute(ssm_scan_bwd_hopper<T, kN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device] = 1;
  }
  ssm_scan_bwd_hopper<T, kN><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int N, dim3 grid, cudaStream_t s, const Params& p) {
  if (N == 16) return launch<T, 16>(grid, s, p);
  if (N == 4) return launch<T, 4>(grid, s, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hop

// ----------------------------------------------------- ssm_scan_bwd_strided
// One level of a transposing butterfly over the lanes: each lane keeps one
// half of its kHalf * 2 running sums (the upper half where its lane bit
// kHalf is set), adds the partner lane's copy of that half to it, and sends
// the other half; then the next level over the kept half.  Templates, so
// that every index into v is a constant and v stays in registers.
template <int kHalf, int kV>
__device__ __forceinline__ void butterfly(float (&v)[kV], int lane) {
  if constexpr (kHalf > 0) {
    const bool upper = (lane & kHalf) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
    }
    butterfly<kHalf / 2, kV>(v, lane);
  }
}

// The warp's sum of v[lane % kV] over its 32 lanes: the transposing
// butterfly (kV - 1 shuffles), then plain xor levels over the lanes that
// hold the same term (none at kV 32).  The order of every sum is fixed.
template <int kV>
__device__ __forceinline__ float warp_term_sum(float (&v)[kV], int lane) {
  butterfly<kV / 2, kV>(v, lane);
  float r = v[0];
#pragma unroll
  for (int m = kV; m < kLanes; m *= 2) r += __shfl_xor_sync(0xffffffffu, r, m);
  return r;
}

// One segment's inputs in a lane's registers: its x, dt and dy at the
// segment's steps (0 past the segment and on an inactive lane), and its
// share of the batch row's B and C (element lane + 32 k of the flattened
// [B or C][step][state] block).  Each segment's are fetched while the one
// before it runs, so the loads' latency hides behind a segment's work.
template <int kN>
struct Segment {
  static constexpr int kShare = 2 * kSeg * kN / kLanes;
  float x[kSeg], dt[kSeg], g[kSeg];
  float bc[kShare];
};

template <typename T, int kN>
__device__ __forceinline__ void fetch(const Params& p, int64_t b, int64_t d, bool active,
                                      int64_t s, int lane, bool with_dy, Segment<kN>& seg) {
  const int64_t t0 = s * kSeg;
  const int steps = p.S - t0 < kSeg ? static_cast<int>(p.S - t0) : kSeg;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + d * p.x_sd;
  const float* dt = p.dt + b * p.dt_sb + d * p.dt_sd;
  const T* dy = static_cast<const T*>(p.dy) + b * p.g_sb + d * p.g_sd;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const bool here = active && j < steps;
    const int64_t t = t0 + j;
    seg.x[j] = here ? to_float(x[t * p.x_ss]) : 0.f;
    seg.dt[j] = here ? dt[t * p.dt_ss] : 0.f;
    seg.g[j] = here && with_dy ? to_float(dy[t * p.g_ss]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < Segment<kN>::kShare; ++k) {
    const int i = lane + kLanes * k;
    const bool is_c = i >= kSeg * kN;
    const int r = is_c ? i - kSeg * kN : i;
    const int j = r / kN;
    const int n = r - j * kN;
    const int64_t t = t0 + j;
    seg.bc[k] = j >= steps ? 0.f
                : is_c     ? p.Cc[b * p.c_sb + t * p.c_ss + n * p.c_sn]
                           : p.Bc[b * p.b_sb + t * p.b_ss + n * p.b_sn];
  }
}

// A segment's B and C from the lanes' registers into shared memory.
template <int kN>
__device__ __forceinline__ void commit(const Segment<kN>& seg, int lane, float* bc) {
  __syncwarp();  // every lane is done with the previous segment's B and C
#pragma unroll
  for (int k = 0; k < Segment<kN>::kShare; ++k) bc[lane + kLanes * k] = seg.bc[k];
  __syncwarp();
}

template <typename T, int kN>
__global__ void __launch_bounds__(kLanes) ssm_scan_bwd_strided(const Params p) {
  constexpr int kV = 2 * kN;  // this lane's dB_t (0..N-1) and dC_t (N..2N-1) terms
  __shared__ float hs[kSeg][kN][kLanes];  // h_{t-1} of each step of the segment
  __shared__ float bcs[2][kSeg][kN];      // the segment's B and C

  const int lane = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t blk = blockIdx.x;
  const int64_t blocks = gridDim.x;
  const int64_t d = blk * kLanes + lane;
  const bool active = d < p.Dm;
  const int64_t segs = (p.S + kSeg - 1) / kSeg;
  const float(&bs)[kSeg][kN] = bcs[0];
  const float(&cs)[kSeg][kN] = bcs[1];

  float a2[kN];  // A * log2(e): exp(dt * A) = 2**(dt * a2)
  float h[kN];
  float dd = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = 0.f;
    h[n] = 0.f;
  }
  if (active) {
    dd = p.Dv[d];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      a2[n] = p.A[d * kN + n] * kLog2e;
      if (p.h0 != nullptr) h[n] = p.h0[(b * p.Dm + d) * kN + n];
    }
  }
  float* ck = p.ckpt + b * segs * kN * p.Dm + d;  // [segment][n], stride D
  Segment<kN> cur, next;

  // pass 1: the state at the start of every segment
  if (segs > 0) fetch<T, kN>(p, b, d, active, 0, lane, false, cur);
  for (int64_t s = 0; s < segs; ++s) {
    const int steps = p.S - s * kSeg < kSeg ? static_cast<int>(p.S - s * kSeg) : kSeg;
    if (active) {
#pragma unroll
      for (int n = 0; n < kN; ++n) ck[(s * kN + n) * p.Dm] = h[n];
    }
    commit(cur, lane, &bcs[0][0][0]);
    if (s + 1 < segs) fetch<T, kN>(p, b, d, active, s + 1, lane, false, next);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      if (j < steps) {
        const float dtx = cur.dt[j] * cur.x[j];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          h[n] = fmaf(hopper::ex2(cur.dt[j] * a2[n]), h[n], dtx * bs[j][n]);
        }
      }
    }
    cur = next;
  }

  // pass 2: the segments in reverse
  float carry[kN];  // a_{t+1} * dh_{t+1}: the adjoint that reaches h_t from later steps
  float da[kN];     // dA of this channel, summed over time
  float dsum = 0.f; // dD of this channel, summed over time
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    carry[n] = active && p.dh_final != nullptr ? p.dh_final[(b * p.Dm + d) * kN + n] : 0.f;
    da[n] = 0.f;
  }
  T* dx = static_cast<T*>(p.dx) + b * p.S * p.Dm + d;
  float* ddt = p.ddt + b * p.S * p.Dm + d;
  float* part = p.bc_part + (b * blocks + blk) * p.S * kV + lane;
  if (segs > 0) {
    fetch<T, kN>(p, b, d, active, segs - 1, lane, true, cur);
#pragma unroll
    for (int n = 0; n < kN; ++n) h[n] = active ? ck[((segs - 1) * kN + n) * p.Dm] : 0.f;
  }
  for (int64_t s = segs - 1; s >= 0; --s) {
    const int64_t t0 = s * kSeg;
    const int steps = p.S - t0 < kSeg ? static_cast<int>(p.S - t0) : kSeg;
    commit(cur, lane, &bcs[0][0][0]);
    if (s > 0) fetch<T, kN>(p, b, d, active, s - 1, lane, true, next);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {  // the segment's states, forward from its checkpoint
      if (j < steps) {
        const float dtx = cur.dt[j] * cur.x[j];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          hs[j][n][lane] = h[n];
          h[n] = fmaf(hopper::ex2(cur.dt[j] * a2[n]), h[n], dtx * bs[j][n]);
        }
      }
    }
    if (s > 0) {  // the checkpoint of the segment before, while this one runs in reverse
#pragma unroll
      for (int n = 0; n < kN; ++n) h[n] = active ? ck[((s - 1) * kN + n) * p.Dm] : 0.f;
    }
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {  // the segment's steps, in reverse
      if (j < steps) {
        const float xv = cur.x[j], dtv = cur.dt[j], g = cur.g[j];
        const float dtx = dtv * xv;
        float v[kV];
        float dxs = 0.f;  // sum_n dh B
        float dda = 0.f;  // sum_n dh a2 a h_{t-1}
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float a = hopper::ex2(dtv * a2[n]);
          const float ah = a * hs[j][n][lane];              // a_t h_{t-1}
          const float dh = fmaf(g, cs[j][n], carry[n]);      // dh_t
          v[n] = dh * dtx;                                   // dB_t's term
          v[kN + n] = g * fmaf(dtx, bs[j][n], ah);           // dC_t's term: g h_t
          dxs = fmaf(dh, bs[j][n], dxs);
          const float w = dh * ah;
          dda = fmaf(w, a2[n], dda);
          da[n] = fmaf(w, dtv, da[n]);
          carry[n] = a * dh;
        }
        const int64_t t = t0 + j;
        if (active) {
          store(dx + t * p.Dm, fmaf(dxs, dtv, dd * g));
          ddt[t * p.Dm] = fmaf(xv, dxs, kLn2 * dda);
        }
        dsum = fmaf(g, xv, dsum);
        const float r = warp_term_sum<kV>(v, lane);
        if (lane < kV) part[t * kV] = r;
      }
    }
    cur = next;
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      p.dh0[(b * p.Dm + d) * kN + n] = carry[n];
      p.a_part[(b * p.Dm + d) * kN + n] = da[n];
    }
    p.d_part[b * p.Dm + d] = dsum;
  }
}

// out[i][k] = sum over j < J of in[i][j][k], in order, for in (I, J, K);
// element k of row i goes, as (r, v) = (k / row, k % row), to out0[i][r][v]
// (width `half`) where v < half, else to out1[i][r][v - half] (width row -
// half).
__global__ void __launch_bounds__(kSumThreads)
    sum_over_middle(const float* in, int64_t I, int64_t J, int64_t K, int64_t row,
                    int64_t half, float* out0, float* out1) {
  const int64_t total = I * K;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(kSumThreads) + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * kSumThreads) {
    const int64_t i = idx / K;
    const int64_t k = idx - i * K;
    const float* src = in + i * J * K + k;
    float acc = 0.f;
    for (int64_t j = 0; j < J; ++j) acc += src[j * K];
    const int64_t rows = K / row;
    const int64_t r = k / row;
    const int64_t v = k - r * row;
    if (v < half) {
      out0[(i * rows + r) * half + v] = acc;
    } else {
      out1[(i * rows + r) * (row - half) + (v - half)] = acc;
    }
  }
}

cudaError_t sum_launch(cudaStream_t s, const float* in, int64_t I, int64_t J, int64_t K,
                       int64_t row, int64_t half, float* out0, float* out1) {
  const int64_t total = I * K;
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kSumThreads - 1) / kSumThreads;
  if (blocks > 65536) blocks = 65536;
  sum_over_middle<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(in, I, J, K, row, half,
                                                                       out0, out1);
  return cudaGetLastError();
}

template <typename T>
int launch_strided(int N, dim3 grid, cudaStream_t s, const Params& p) {
  if (N == 16) {
    ssm_scan_bwd_strided<T, 16><<<grid, kLanes, 0, s>>>(p);
  } else if (N == 4) {
    ssm_scan_bwd_strided<T, 4><<<grid, kLanes, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Both entry points: fill Params, launch the scan kernel (hopper or
// strided) and then the three sums over blocks and over the batch.
int run(bool hopper_route, const void* x, const void* dt, const void* A,
        const void* Bc, const void* Cc, const void* Dv, const void* h0, const void* dy,
        const void* dh_final, void* dx, void* ddt, void* dB, void* dC, void* dA, void* dD,
        void* dh0, void* ckpt, void* bc_part, void* a_part, void* d_part, int dtype,
        const int64_t* dims, const int64_t* strides, void* stream) {
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bc = static_cast<const float*>(Bc);
  p.Cc = static_cast<const float*>(Cc);
  p.Dv = static_cast<const float*>(Dv);
  p.h0 = static_cast<const float*>(h0);
  p.dy = dy;
  p.dh_final = static_cast<const float*>(dh_final);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dh0 = static_cast<float*>(dh0);
  p.ckpt = static_cast<float*>(ckpt);
  p.bc_part = static_cast<float*>(bc_part);
  p.a_part = static_cast<float*>(a_part);
  p.d_part = static_cast<float*>(d_part);
  const int64_t B = dims[0];
  p.S = dims[1];
  p.Dm = dims[2];
  const int64_t N = dims[3];
  int64_t* st[15] = {&p.x_sb, &p.x_ss, &p.x_sd, &p.dt_sb, &p.dt_ss, &p.dt_sd, &p.b_sb, &p.b_ss,
                     &p.b_sn, &p.c_sb, &p.c_ss, &p.c_sn, &p.g_sb, &p.g_ss, &p.g_sd};
  for (int i = 0; i < 15; ++i) *st[i] = strides[i];
  if (B == 0 || p.Dm == 0) return static_cast<int>(cudaSuccess);
  const int64_t width = hopper_route ? hop::kChannels : kLanes;
  const int64_t blocks = (p.Dm + width - 1) / width;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (hopper_route) {
    if (dtype == 0) err = hop::launch_n<float>(n, grid, s, p);
    if (dtype == 1) err = hop::launch_n<__nv_bfloat16>(n, grid, s, p);
  } else {
    if (dtype == 0) err = launch_strided<float>(n, grid, s, p);
    if (dtype == 1) err = launch_strided<__nv_bfloat16>(n, grid, s, p);
  }
  cudaError_t e = static_cast<cudaError_t>(err);
  // dB and dC: the blocks' partials summed over the blocks, split into two outputs
  if (e == cudaSuccess) {
    e = sum_launch(s, p.bc_part, B, blocks, p.S * 2 * N, 2 * N, N, static_cast<float*>(dB),
                   static_cast<float*>(dC));
  }
  // dA and dD: the channels' sums over time, summed over the batch
  if (e == cudaSuccess) {
    e = sum_launch(s, p.a_part, 1, B, p.Dm * N, p.Dm * N, p.Dm * N, static_cast<float*>(dA),
                   nullptr);
  }
  if (e == cudaSuccess) {
    e = sum_launch(s, p.d_part, 1, B, p.Dm, p.Dm, p.Dm, static_cast<float*>(dD), nullptr);
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" int64_t ssm_scan_bwd_segment_steps() { return kSeg; }
// channels a block: the second axis of the dB/dC partials is ceil(D / this)
extern "C" int64_t ssm_scan_bwd_block_channels() { return kLanes; }
extern "C" int64_t ssm_scan_bwd_hopper_block_channels() { return hop::kChannels; }

// dims: B, S, D, N.  strides (in elements): x, dt, B, C, dy, each as (batch,
// step, last axis).  dtype: 0 float32, 1 bfloat16 (x, dy and dx).
// outputs: dx (B, S, D), ddt (B, S, D), dB and dC (B, S, N), dA (D, N), dD
// (D,), dh0 (B, D, N), all contiguous.  scratch, all float32: the
// checkpoints (B, ceil(S / 8), N, D) for ssm_scan_bwd and (B, ceil(S / 8),
// D, N) for ssm_scan_bwd_hopper, the blocks' dB and dC partials (B,
// ceil(D / block channels), S, 2N), dA's (B, D, N) and dD's (B, D) partial
// sums.  ssm_scan_bwd_hopper takes only what the wrapper's route gives it:
// x, dt and dy with unit last-axis strides, 16-byte-aligned bases and
// other strides, and D a multiple of 8; dx and ddt at 16-byte-aligned
// addresses; its ckpt holds the training forward's checkpoints
// (ssm_scan_fwd_hopper_ckpt in csrc/ssm_scan.cu), which it only reads.
extern "C" int ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* Bc,
                            const void* Cc, const void* Dv, const void* h0, const void* dy,
                            const void* dh_final, void* dx, void* ddt, void* dB, void* dC,
                            void* dA, void* dD, void* dh0, void* ckpt, void* bc_part,
                            void* a_part, void* d_part, int dtype, const int64_t* dims,
                            const int64_t* strides, void* stream) {
  return run(false, x, dt, A, Bc, Cc, Dv, h0, dy, dh_final, dx, ddt, dB, dC, dA, dD,
             dh0, ckpt, bc_part, a_part, d_part, dtype, dims, strides, stream);
}

extern "C" int ssm_scan_bwd_hopper(const void* x, const void* dt, const void* A, const void* Bc,
                                   const void* Cc, const void* Dv, const void* h0,
                                   const void* dy, const void* dh_final, void* dx, void* ddt,
                                   void* dB, void* dC, void* dA, void* dD, void* dh0, void* ckpt,
                                   void* bc_part, void* a_part, void* d_part, int dtype,
                                   const int64_t* dims, const int64_t* strides, void* stream) {
  return run(true, x, dt, A, Bc, Cc, Dv, h0, dy, dh_final, dx, ddt, dB, dC, dA,
             dD, dh0, ckpt, bc_part, a_part, d_part, dtype, dims, strides, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
