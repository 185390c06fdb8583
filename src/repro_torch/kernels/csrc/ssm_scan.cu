// Mamba-1 selective scan on Hopper (sm_90a): one thread per (batch,
// channel), the loop over the sequence inside the thread.
//
// Replaces the TPU kernel ssm_scan / _kernel of
// src/repro/kernels/ssm_scan.py and computes what it computes:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t     (B, D, N) float32
//   y_t = C_t . h_t + D * x_t                           rounded to x's type once
// with D * x added in float32 before the rounding, h0 optional (zeros in its
// place) and h_final written in float32.
//
// Design.  The TPU kernel keeps a (block_d, N) state in VMEM scratch and
// carries it across a sequential ("arbitrary") chunk axis of its grid.
// Hopper's blocks run in no order, so here the time loop is inside the
// thread: each thread owns one (batch, channel) pair and keeps its N
// states and its row of A (pre-scaled by log2 e) in registers for the whole
// sequence; nothing is carried between blocks.  A block covers kThreads
// consecutive channels of one batch row (8 x 8,192 / 128 = 512 blocks at
// the serving path's shape, all resident at once).  The sequence is walked
// in chunks of kChunk steps:
//   - B_t and C_t are the same for every channel of a batch row, so the
//     block stages the chunk's (kChunk, N) slices of both in shared memory
//     once, and every thread reads them as broadcasts;
//   - each thread loads its own chunk of x and dt into registers first
//     (kChunk independent loads in flight; neighbouring threads read
//     neighbouring channels, so the loads coalesce), then runs the chunk's
//     steps: per state one exp2 on the special-function unit and two FMAs,
//     per step one store of y.
// N is a template parameter, compiled for the state sizes of the ported
// configs only (16 for falcon-mamba-7b, 4 for its smoke config): with N
// known at compile time the loops over the states unroll into straight code
// with no predicate on any state.  Any other N is refused.
// Inputs are read through their strides: x may be a split of a wider
// tensor, and B, C are column slices of the model's x_proj output.  A, D,
// h0, y and h_final are contiguous.  Any S works, 0 and 1 included; a chunk
// past the end runs only the steps that exist (the TPU kernel pads with
// dt = 0, the identity step, which gives the same result).
//
// Bound at the serving path's prefill shape, x (8, 1024, 8192) bf16 with
// N = 16 and h0 present: it must read x (134 MB), dt (268 MB), B and C
// (1 MB), h0 (4.2 MB) and write y (134 MB) and h_final (4.2 MB), 546 MB, or
// 0.163 ms at 3.35 TB/s; and it must take B*S*D*N = 1.07 G exponentials,
// 0.257 ms at the special-function units' 16 per clock per SM (CUDA C++
// Programming Guide, compute capability 9.0) on 132 SMs at 1.98 GHz.  So
// the exponentials bound it, and the FMA pipe (about 4 instructions per
// state and step, 0.13 ms) does not.  This first version keeps every
// exponential (no reuse of powers of exp(dt)) and has no chunk-parallel
// scan, no cp.async staging and no double buffering: that is later work.
//
// Plain C entry point, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 16;     // time steps per staged chunk
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* x;       // (B, S, D) float32 or bf16, strided
  const float* dt;     // (B, S, D), strided
  const float* A;      // (D, N) contiguous
  const float* Bc;     // (B, S, N), strided
  const float* Cc;     // (B, S, N), strided
  const float* Dv;     // (D,) contiguous
  const float* h0;     // (B, D, N) contiguous, or null
  void* y;             // (B, S, D) contiguous, x's type
  float* h_final;      // (B, D, N) contiguous
  int64_t S, Dm;
  int N;
  int64_t x_sb, x_ss, x_sd;
  int64_t dt_sb, dt_ss, dt_sd;
  int64_t b_sb, b_ss, b_sn;
  int64_t c_sb, c_ss, c_sn;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 2**v on the special-function unit
__device__ __forceinline__ float exp2_sfu(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(const Params p) {
  __shared__ float b_s[kChunk][kN];
  __shared__ float c_s[kChunk][kN];

  const int64_t b = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = d < p.Dm;

  float a2[kN];  // A * log2(e): exp(dt * A) = 2**(dt * a2)
  float h[kN];
  float Dd = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = 0.f;
    h[n] = 0.f;
  }
  if (active) {
    Dd = p.Dv[d];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      a2[n] = p.A[d * kN + n] * kLog2e;
      if (p.h0 != nullptr) h[n] = p.h0[(b * p.Dm + d) * kN + n];
    }
  }
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + d * p.x_sd;
  const float* dt = p.dt + b * p.dt_sb + d * p.dt_sd;
  const float* Bc = p.Bc + b * p.b_sb;
  const float* Cc = p.Cc + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + b * p.S * p.Dm + d;

  for (int64_t t0 = 0; t0 < p.S; t0 += kChunk) {
    const int64_t left = p.S - t0;
    const int steps = left < kChunk ? static_cast<int>(left) : kChunk;
    __syncthreads();  // every thread is done with the previous chunk's B and C
    for (int i = threadIdx.x; i < steps * kN; i += kThreads) {
      const int t = i / kN;
      const int n = i - t * kN;
      b_s[t][n] = Bc[(t0 + t) * p.b_ss + n * p.b_sn];
      c_s[t][n] = Cc[(t0 + t) * p.c_ss + n * p.c_sn];
    }
    float xs[kChunk];
    float dts[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const bool here = active && t < steps;
      xs[t] = here ? to_float(x[(t0 + t) * p.x_ss]) : 0.f;
      dts[t] = here ? dt[(t0 + t) * p.dt_ss] : 0.f;
    }
    __syncthreads();  // the chunk's B and C are staged
    if (!active) continue;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < steps) {
        const float dtx = dts[t] * xs[t];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          h[n] = fmaf(exp2_sfu(dts[t] * a2[n]), h[n], dtx * b_s[t][n]);
          acc = fmaf(c_s[t][n], h[n], acc);
        }
        const float yv = acc + Dd * xs[t];
        store(y + (t0 + t) * p.Dm, yv);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kN; ++n) p.h_final[(b * p.Dm + d) * kN + n] = h[n];
  }
}

// false for a state size no kernel is compiled for
template <typename T>
bool launch(dim3 grid, cudaStream_t s, const Params& p) {
  if (p.N == 16) {
    ssm_scan_kernel<T, 16><<<grid, kThreads, 0, s>>>(p);
  } else if (p.N == 4) {
    ssm_scan_kernel<T, 4><<<grid, kThreads, 0, s>>>(p);
  } else {
    return false;
  }
  return true;
}

}  // namespace

// dims: B, S, D, N.  strides (in elements): x, dt, B, C, each as
// (batch, step, last axis).  dtype: 0 float32, 1 bfloat16 (x and y).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A, const void* Bc,
                            const void* Cc, const void* Dv, const void* h0, void* y,
                            void* h_final, int dtype, const int64_t* dims,
                            const int64_t* strides, void* stream) {
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bc = static_cast<const float*>(Bc);
  p.Cc = static_cast<const float*>(Cc);
  p.Dv = static_cast<const float*>(Dv);
  p.h0 = static_cast<const float*>(h0);
  p.y = y;
  p.h_final = static_cast<float*>(h_final);
  const int64_t B = dims[0];
  p.S = dims[1];
  p.Dm = dims[2];
  p.N = static_cast<int>(dims[3]);
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.x_sd = strides[2];
  p.dt_sb = strides[3];
  p.dt_ss = strides[4];
  p.dt_sd = strides[5];
  p.b_sb = strides[6];
  p.b_ss = strides[7];
  p.b_sn = strides[8];
  p.c_sb = strides[9];
  p.c_ss = strides[10];
  p.c_sn = strides[11];
  const dim3 grid(static_cast<unsigned>((p.Dm + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool taken = dtype == 0   ? launch<float>(grid, s, p)
                     : dtype == 1 ? launch<__nv_bfloat16>(grid, s, p)
                                  : false;
  if (!taken) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
