// The backward of the Mamba-1 selective scan on Hopper (sm_90a): one thread
// per (batch, channel), the reverse loop over the sequence inside the thread.
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
// Where the trouble lies, and what this design does about it:
//
// - h_{t-1}.  The reverse loop needs each step's previous state, and
//   dividing by a_t would not give it back (A is learned and exp(dt A)
//   underflows).  So the states are recomputed forward: pass 1 walks the
//   sequence from h0 and writes the state at the start of every kSeg-step
//   segment into a float32 scratch, (B, ceil(S / kSeg), N, D); pass 2
//   walks the segments in reverse, recomputes each segment's kSeg states
//   from its checkpoint into shared memory, and then runs the segment's
//   steps in reverse from them.  At falcon-mamba-7b's training shape, x
//   (4, 2048, 8192) with N 16, the checkpoints are 537 MB.  Each state
//   and step takes three exponentials (pass 1, the recomputation, the
//   reverse step) where the function needs one.  Each segment's x, dt,
//   dy, B and C are loaded into registers while the segment before it
//   runs, and the next checkpoint while its steps run in reverse.
// - dB_t and dC_t are sums over every channel at every step and state.
//   Each warp (a block is one warp of 32 channels) sums its lanes' 2N
//   terms with a transposing butterfly: at each of log2(2N) levels a lane
//   keeps half of its values and trades the other half with the lane that
//   keeps that half, so after 31 shuffles (N 16; 7 and two plain levels
//   at N 4) lane l holds the warp's sum of term l.  Its levels are
//   templates: with a run-time level the running sums are indexed at run
//   time and leave the registers for local memory.  The warps' sums meet
//   in a scratch of (B, ceil(D / 32), S, 2N) partials (268 MB at the
//   training shape), summed over the warps in order by a second kernel.
//   dA and dD sum over batch and time: each thread keeps its channel's
//   sums over time in registers, and the same kernel sums the (B, D, N)
//   and (B, D) partials over the batch.
// - Determinism: no atomics; every sum runs in a fixed order, so two calls
//   on the same inputs give the same bits.
// - Layouts: x, dt, dy, B and C are read through their strides (B and C
//   arrive as column views of one float32 projection, dy may be any
//   view); A, D, h0 and dh_final are contiguous; every output is written
//   contiguous.
//
// Bound at the training shape, x and dy (4, 2048, 8192) bf16, dt float32,
// N 16: the function must read x, dt, dy, B and C and write dx, ddt, dB
// and dC (0.94 GB, 0.28 ms at 3.35 TB/s), take B*S*D*N = 1.07 G
// exponentials (0.257 ms at 16 a clock on 132 SMs at 1.98 GHz) and 18
// float32 flops per state and step (seven FMAs and four products: the
// exponent, a_t h_{t-1}, h_t, dh_t, the three sums' terms dB, dC, dx, the
// shared dh a_t h_{t-1} and its two sums, the carried adjoint; 0.29 ms at
// 67 TFLOP/s).  This first kernel is simple rather than fast: one warp per
// block and one thread per channel give each scheduler about two warps at
// that shape (the work has B*D = 32,768 threads), it takes three
// exponentials where one would do, and its scratch traffic (1.6 GB)
// exceeds the function's own.
//
// Plain C entry point, loaded with ctypes; it launches the scan kernel and
// the three sums on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_common.cuh"

namespace {

constexpr int kLanes = 32;  // channels per block: one warp
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
  float* ckpt;           // (B, segments, N, D) scratch
  float* bc_part;        // (B, blocks, S, 2N) scratch: each warp's dB_t, dC_t
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
__global__ void __launch_bounds__(kLanes) ssm_scan_bwd_kernel(const Params p) {
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
bool launch(int N, dim3 grid, cudaStream_t s, const Params& p) {
  if (N == 16) {
    ssm_scan_bwd_kernel<T, 16><<<grid, kLanes, 0, s>>>(p);
  } else if (N == 4) {
    ssm_scan_bwd_kernel<T, 4><<<grid, kLanes, 0, s>>>(p);
  } else {
    return false;
  }
  return true;
}

}  // namespace

extern "C" int64_t ssm_scan_bwd_segment_steps() { return kSeg; }
extern "C" int64_t ssm_scan_bwd_block_channels() { return kLanes; }

// dims: B, S, D, N.  strides (in elements): x, dt, B, C, dy, each as (batch,
// step, last axis).  dtype: 0 float32, 1 bfloat16 (x, dy and dx).
// outputs: dx (B, S, D), ddt (B, S, D), dB and dC (B, S, N), dA (D, N), dD
// (D,), dh0 (B, D, N), all contiguous.  scratch: the checkpoints (B,
// ceil(S / 8), N, D), the warps' dB and dC terms (B, ceil(D / 32), S, 2N),
// dA's (B, D, N) and dD's (B, D) partial sums, all float32.
extern "C" int ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* Bc,
                            const void* Cc, const void* Dv, const void* h0, const void* dy,
                            const void* dh_final, void* dx, void* ddt, void* dB, void* dC,
                            void* dA, void* dD, void* dh0, void* ckpt, void* bc_part,
                            void* a_part, void* d_part, int dtype, const int64_t* dims,
                            const int64_t* strides, void* stream) {
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
  const int64_t blocks = (p.Dm + kLanes - 1) / kLanes;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool taken = dtype == 0   ? launch<float>(static_cast<int>(N), grid, s, p)
                     : dtype == 1 ? launch<__nv_bfloat16>(static_cast<int>(N), grid, s, p)
                                  : false;
  if (!taken) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaGetLastError();
  // dB and dC: the warps' terms summed over the warps, split into two outputs
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

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
