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
// The TPU kernel keeps a (block_d, N) state in VMEM scratch and carries it
// across a sequential ("arbitrary") chunk axis of its grid.  Hopper's
// blocks run in no order, so here the time loop is inside the thread: each
// thread owns one (batch, channel) pair and keeps its N states and its row
// of A (pre-scaled by log2 e) in registers for the whole sequence; nothing
// is carried between blocks.  Per state and step: one exp2 on the
// special-function unit (ex2.approx, one per state: A is a learned weight,
// so no power of one exponential stands in for another), two products and
// two FMAs.  N is a template parameter, compiled for the state sizes of the
// ported configs only (16 for falcon-mamba-7b, 4 for its smoke config), so
// the loops over the states unroll with no predicate; any other N is
// refused.  Any S works, 0 and 1 included; a chunk past the end runs only
// the steps that exist (the TPU kernel pads with dt = 0, the identity step,
// which gives the same result).
//
// Bound at the serving path's prefill shape, x (8, 1024, 8192) bf16 with
// N = 16 and h0 present: it must read x (134 MB), dt (268 MB), B and C
// (1 MB), h0 (4.2 MB) and write y (134 MB) and h_final (4.2 MB), 546.9 MB,
// or 0.163 ms at 3.35 TB/s; and it must take B*S*D*N = 1.07 G
// exponentials, 0.257 ms at the special-function units' 16 per clock per SM
// (CUDA C++ Programming Guide, compute capability 9.0) on 132 SMs at 1.98
// GHz.  So the exponentials bound it; the FMA pipe (four instructions per
// state and step, about 0.13 ms) and the issue of about six instructions
// per exponential (about 0.2 ms) stay under it.  The design's job is to
// keep the special-function units busy: no thread may wait for memory,
// and no instruction that the recurrence does not need may take an issue
// slot.
//
// Three kernels, chosen by the wrapper (kernels/ssm_scan.py: route, and
// ssm_scan_train in training):
//
// ssm_scan_hopper (the model's layouts: every tensor TMA can address, i.e.
// a 16-byte-aligned base, a contiguous last axis and the other strides
// multiples of 16 bytes).  A block of kChannels threads covers kChannels
// consecutive channels of one batch row (512 blocks of 128 at the path's
// shape, all resident at once: up to kMinBlocks per SM by registers and
// shared memory, 16 warps, the most one thread per channel can give).  The
// sequence is walked in chunks of kSteps steps through a ring of kStages
// shared-memory stages, each holding a chunk's x and dt (kSteps x
// kChannels) and its B and C (kSteps x N, shared by every channel of the
// batch row).  Thread 0 fills the ring by TMA (cp.async.bulk.tensor, one
// box per tensor; boxes past the end of S or D arrive as zeros), each
// stage completing on a "full" mbarrier by its byte count; each warp
// releases a stage on its "empty" mbarrier once its 32 channels have run
// the chunk.  Thread 0 refills the stage of chunk c - 2 with chunk c + 1 at
// the start of chunk c, so one chunk (16 steps, some microseconds) is in
// flight while one runs, and it waits only on warps two chunks behind it.
// No block-wide barrier stands in the loop: a warp waits only for its own
// chunk to land.  TMA and not cp.async: one thread issues a chunk's four
// copies, where cp.async would take 16-byte copies, with their addresses
// and registers, from every thread, out of the issue budget that the
// exponentials need.  A full chunk's 16 steps are unrolled with no
// predicate, so every shared-memory address is a constant offset: per
// state and step the loop issues its exp2, two products and two FMAs, and
// per step 8 broadcast loads of B and C (N = 16), the thread's x and dt and
// one store of y into its warp's (16 x 32) tile in shared memory; the tile
// goes to y by one TMA store per warp and chunk (two tiles a warp, so that
// a store reads one while the next chunk writes the other; the rows and
// channels past S and D are not stored).  About six instructions per
// exponential, so issue stays under the special-function units; the
// rest of the time goes to the steps' dependences (four warps per
// scheduler to hide them).  A wait that lasts about two seconds traps: a
// fault in the ring ends the launch with an error instead of hanging the
// card.  It runs the same float32 operations in the same order as
// ssm_scan_kernel, so the two give the same bits.
//
// ssm_scan_train_hopper (training, the same layouts): ssm_scan_hopper's
// body, a separate instantiation, that also stores the state at the start
// of every 8-step segment for the backward (csrc/ssm_scan_bwd.cu), whose
// hopper kernel requires them; serving's kernel stays as it is.
//
// ssm_scan_kernel (every other layout; any strides, the last axis
// included): the same recurrence with 128 channels a block, each chunk's B
// and C staged in shared memory between two __syncthreads() and each
// thread's x and dt loaded into registers before the chunk's steps.
//
// Plain C entry points, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper_common.cuh"

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

// ------------------------------------------------------------ ssm_scan_hopper
namespace staged {

constexpr int kChannels = 128;       // channels (threads) per block
constexpr int kSteps = 16;           // time steps per chunk
constexpr int kStages = 3;           // chunks in the shared-memory ring
constexpr int kAhead = kStages - 2;  // chunks loaded ahead of the one that runs
constexpr int kMinBlocks = 4;        // blocks per SM the registers must allow
constexpr int kWarps = kChannels / 32;
constexpr long long kTrapCycles = 4LL << 30;  // about 2 s at 1.98 GHz

template <typename T, int kN>
struct alignas(128) Stage {
  T x[kSteps][kChannels];
  float dt[kSteps][kChannels];
  float b[kSteps][kN];
  float c[kSteps][kN];
};

// what TMA writes into a stage: its boxes of x, dt, B and C
template <typename T, int kN>
constexpr uint32_t kStageBytes = kSteps * kChannels * (sizeof(T) + 4) + 2 * kSteps * kN * 4;

// A warp's y of one chunk, (kSteps, 32 channels), for its TMA store; two per
// warp, so that a chunk's store reads one while the next chunk writes the
// other.
template <typename T>
struct alignas(128) YTile {
  T v[kSteps][32];
};

template <typename T, int kN>
constexpr int kSmemBytes =
    kStages * sizeof(Stage<T, kN>) + 2 * kWarps * sizeof(YTile<T>) + 2 * kStages * 8;

struct Maps {
  CUtensorMap x, dt, b, c, y;  // (B, S, D) x, dt and y, (B, S, N) B and C
};

struct Params {
  const float* A;   // (D, N) contiguous
  const float* Dv;  // (D,) contiguous
  const float* h0;  // (B, D, N) contiguous, or null
  float* h_final;   // (B, D, N) contiguous
  float* ckpt;      // ssm_scan_train_hopper: (B, ceil(S / kSegSteps), D, N), else null
  int64_t S, Dm;
};

// ssm_scan_train_hopper writes the state at the start of every kSegSteps-step
// segment for the backward (csrc/ssm_scan_bwd.cu, whose segment this is).
constexpr int kSegSteps = 8;
static_assert(kSteps % kSegSteps == 0,
              "a chunk holds whole segments: scan_body checkpoints where t % kSegSteps is 0");

// The calling thread's N states into segment seg's checkpoint of its channel.
template <int kN>
__device__ __forceinline__ void checkpoint(const Params& p, int b, int64_t d, int64_t seg,
                                           const float (&h)[kN]) {
  const int64_t segs = (p.S + kSegSteps - 1) / kSegSteps;
  float4* dst = reinterpret_cast<float4*>(p.ckpt + ((b * segs + seg) * p.Dm + d) * kN);
#pragma unroll
  for (int n = 0; n < kN / 4; ++n) {
    dst[n] = make_float4(h[4 * n], h[4 * n + 1], h[4 * n + 2], h[4 * n + 3]);
  }
}

__device__ __forceinline__ bool try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `parity` of the barrier at `bar` has completed;
// trap after kTrapCycles.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  if (try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!try_wait(bar, parity)) {
    if (clock64() - start > kTrapCycles) __trap();
  }
}

// Step t of a chunk for the calling thread's channel `ch` of the block:
// the N states forward, y_t into its column of the warp's tile.
template <typename T, int kN>
__device__ __forceinline__ void step(const Stage<T, kN>& st, int t, int ch, const float (&a2)[kN],
                                     float dd, float (&h)[kN], T* ycol) {
  const float xv = to_float(st.x[t][ch]);
  const float dtv = st.dt[t][ch];
  const float dbx = dtv * xv;
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    h[n] = fmaf(hopper::ex2(dtv * a2[n]), h[n], dbx * st.b[t][n]);
    acc = fmaf(st.c[t][n], h[n], acc);
  }
  const float yv = acc + dd * xv;
  store(ycol + t * 32, yv);
}

// The kernel's body; with kCkpt it also writes the backward's checkpoints.
template <typename T, int kN, bool kCkpt>
__device__ __forceinline__ void scan_body(const Maps& maps, const Params& p) {
  using St = Stage<T, kN>;
  static_assert(sizeof(St) == kStageBytes<T, kN>, "a stage is exactly its four boxes");
  extern __shared__ __align__(128) unsigned char smem[];
  St* ring = reinterpret_cast<St*>(smem);
  YTile<T>* ytiles = reinterpret_cast<YTile<T>*>(smem + kStages * sizeof(St));
  const uint32_t full0 = hopper::smem_u32(ytiles + 2 * kWarps);
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int64_t d = d0 + tid;
  const bool active = d < p.Dm;
  const int chunks = static_cast<int>((p.S + kSteps - 1) / kSteps);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kWarps);
    }
    hopper::fence_barrier_init();
    if (chunks > 0) {
      hopper::tma_prefetch(&maps.x);
      hopper::tma_prefetch(&maps.dt);
      hopper::tma_prefetch(&maps.b);
      hopper::tma_prefetch(&maps.c);
      hopper::tma_prefetch(&maps.y);
    }
  }
  __syncthreads();  // the ring's barriers are initialised (the only block-wide barrier)

  // chunk c of x, dt, B and C into its stage (thread 0 only)
  const auto fill = [&](int c) {
    const int s = c % kStages;
    const uint32_t full = full0 + 8 * s;
    const int t0 = c * kSteps;
    hopper::mbar_expect_tx(full, kStageBytes<T, kN>);
    hopper::tma_load_3d(hopper::smem_u32(ring[s].x), &maps.x, full, d0, t0, b);
    hopper::tma_load_3d(hopper::smem_u32(ring[s].dt), &maps.dt, full, d0, t0, b);
    hopper::tma_load_3d(hopper::smem_u32(ring[s].b), &maps.b, full, 0, t0, b);
    hopper::tma_load_3d(hopper::smem_u32(ring[s].c), &maps.c, full, 0, t0, b);
  };
  if (tid == 0) {
    for (int c = 0; c < kAhead && c < chunks; ++c) fill(c);
  }

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

  for (int c = 0; c < chunks; ++c) {
    const int next = c + kAhead;
    if (tid == 0 && next < chunks) {
      // the stage of chunk next - kStages (= c - 2), once every warp has run it
      if (next >= kStages) wait(empty0 + 8 * (next % kStages), (next / kStages - 1) & 1);
      fill(next);
    }
    // this warp's y tile of chunk c - 2, free once its store has read it
    YTile<T>& yt = ytiles[2 * warp + (c & 1)];
    if (lane == 0) hopper::bulk_wait_read<1>();
    __syncwarp();
    const int stage = c % kStages;
    wait(full0 + 8 * stage, (c / kStages) & 1);
    const St& st = ring[stage];
    const int64_t t0 = static_cast<int64_t>(c) * kSteps;
    const int64_t rest = p.S - t0;
    const int steps = rest < kSteps ? static_cast<int>(rest) : kSteps;
    T* ycol = &yt.v[0][lane];
    if (steps == kSteps) {
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        if constexpr (kCkpt) {
          if (t % kSegSteps == 0 && active) checkpoint<kN>(p, b, d, (t0 + t) / kSegSteps, h);
        }
        step(st, t, tid, a2, dd, h, ycol);
      }
    } else {  // the last chunk: its steps that exist (TMA leaves the tile's other rows unstored)
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        if constexpr (kCkpt) {
          if (t % kSegSteps == 0 && active) checkpoint<kN>(p, b, d, (t0 + t) / kSegSteps, h);
        }
        step(st, t, tid, a2, dd, h, ycol);
      }
    }
    hopper::fence_proxy_async_shared();  // the tile's writes, before TMA reads them
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      hopper::tma_store_3d(&maps.y, hopper::smem_u32(yt.v), d0 + 32 * warp,
                           static_cast<int>(t0), b);
    }
  }
  if (lane == 0) hopper::bulk_wait<0>();  // the stores are done before the block's memory goes
  if (active) {
#pragma unroll
    for (int n = 0; n < kN; ++n) p.h_final[(b * p.Dm + d) * kN + n] = h[n];
  }
}

template <typename T, int kN>
__global__ void __launch_bounds__(kChannels, kMinBlocks)
    ssm_scan_hopper(const __grid_constant__ Maps maps, const Params p) {
  scan_body<T, kN, false>(maps, p);
}

// The same scan for training: also the state at the start of every
// kSegSteps-step segment into p.ckpt, from which the backward's hopper
// kernel recomputes each segment's states (N floats a channel and segment:
// at N 16, four 16-byte stores of each thread at steps 0 and 8 of a chunk).
template <typename T, int kN>
__global__ void __launch_bounds__(kChannels, kMinBlocks)
    ssm_scan_train_hopper(const __grid_constant__ Maps maps, const Params p) {
  scan_body<T, kN, true>(maps, p);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, int smem, int (&ready)[hopper::kMaxDevices], dim3 grid,
                  cudaStream_t s, const Maps& maps, const Params& p) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= hopper::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {  // the shared-memory limit is raised once per device
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device] = 1;
  }
  kernel<<<grid, kChannels, smem, s>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kN>
int launch(dim3 grid, cudaStream_t s, const Maps& maps, const Params& p) {
  static int ready[hopper::kMaxDevices], ready_train[hopper::kMaxDevices];
  if (p.ckpt != nullptr) {
    return launch_kernel(ssm_scan_train_hopper<T, kN>, kSmemBytes<T, kN>, ready_train, grid, s,
                         maps, p);
  }
  return launch_kernel(ssm_scan_hopper<T, kN>, kSmemBytes<T, kN>, ready, grid, s, maps, p);
}

template <typename T>
int launch_n(int N, dim3 grid, cudaStream_t s, const Maps& maps, const Params& p) {
  if (N == 16) return launch<T, 16>(grid, s, maps, p);
  if (N == 4) return launch<T, 4>(grid, s, maps, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace staged

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

// The same arguments, for inputs the wrapper's route gives to
// ssm_scan_hopper: x, dt, B and C with a contiguous last axis (the strides
// at 2, 5, 8 and 11 are not read) and every other stride TMA can take.
namespace {

int fwd_hopper(const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
               const void* Dv, const void* h0, void* y, void* h_final, void* ckpt, int dtype,
               const int64_t* dims, const int64_t* strides, void* stream) {
  using namespace staged;
  const int64_t B = dims[0], S = dims[1], Dm = dims[2], N = dims[3];
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  std::memset(&maps, 0, sizeof(maps));
  if (S > 0) {  // an empty sequence reads nothing: no map, which TMA could not encode
    int e = hopper::encode_3d(&maps.x, dtype == 0, x, Dm, S, B, strides[1], strides[0],
                              kChannels, kSteps);
    if (e == 0) {
      e = hopper::encode_3d(&maps.dt, true, dt, Dm, S, B, strides[4], strides[3], kChannels,
                            kSteps);
    }
    if (e == 0) {
      e = hopper::encode_3d(&maps.b, true, Bc, N, S, B, strides[7], strides[6],
                            static_cast<uint32_t>(N), kSteps);
    }
    if (e == 0) {
      e = hopper::encode_3d(&maps.c, true, Cc, N, S, B, strides[10], strides[9],
                            static_cast<uint32_t>(N), kSteps);
    }
    if (e == 0) {  // y: contiguous, stored a warp's 32 channels at a time
      e = hopper::encode_3d(&maps.y, dtype == 0, y, Dm, S, B, Dm, S * Dm, 32, kSteps);
    }
    if (e != 0) return e;
  }
  staged::Params p;
  p.A = static_cast<const float*>(A);
  p.Dv = static_cast<const float*>(Dv);
  p.h0 = static_cast<const float*>(h0);
  p.h_final = static_cast<float*>(h_final);
  p.ckpt = static_cast<float*>(ckpt);
  p.S = S;
  p.Dm = Dm;
  const dim3 grid(static_cast<unsigned>((Dm + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_n<float>(static_cast<int>(N), grid, s, maps, p)
                    : launch_n<__nv_bfloat16>(static_cast<int>(N), grid, s, maps, p);
}

}  // namespace

extern "C" int ssm_scan_fwd_hopper(const void* x, const void* dt, const void* A, const void* Bc,
                                   const void* Cc, const void* Dv, const void* h0, void* y,
                                   void* h_final, int dtype, const int64_t* dims,
                                   const int64_t* strides, void* stream) {
  return fwd_hopper(x, dt, A, Bc, Cc, Dv, h0, y, h_final, nullptr, dtype, dims, strides, stream);
}

// ssm_scan_fwd_hopper for training (ssm_scan_train_hopper): ckpt, (B,
// ceil(S / 8), D, N) float32 contiguous at a 16-byte-aligned address, also
// receives the state at the start of every 8-step segment, h0's at
// segment 0, which the backward's hopper route reads instead of
// recomputing them.
extern "C" int ssm_scan_fwd_hopper_ckpt(const void* x, const void* dt, const void* A,
                                        const void* Bc, const void* Cc, const void* Dv,
                                        const void* h0, void* y, void* h_final, void* ckpt,
                                        int dtype, const int64_t* dims, const int64_t* strides,
                                        void* stream) {
  if (ckpt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_hopper(x, dt, A, Bc, Cc, Dv, h0, y, h_final, ckpt, dtype, dims, strides, stream);
}

// steps a segment of ssm_scan_fwd_hopper_ckpt's checkpoints, which the
// wrapper holds against the backward's
extern "C" int64_t ssm_scan_fwd_segment_steps() { return staged::kSegSteps; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
