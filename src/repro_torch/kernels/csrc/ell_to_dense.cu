// ELL -> dense on Hopper (sm_90a): one thread block per row.
//
// Replaces the TPU kernel ell_to_dense / _kernel of
// src/repro/kernels/csr_to_dense.py, which evaluates
//     dense[r, c] = sum_k vals[r, k] * [cols[r, k] == c]
// as compare-and-accumulate sweeps over column tiles: O(R * K * n_cols)
// work (about 7.2 G compares per batch at the cell path's shapes), chosen
// only because a TPU has no scatter.  A GPU scatters, so here the work is
// O(R * (n_cols + K)):
//   1. each block zero-fills its row with 16-byte stores; a row whose start
//      is not 16-byte aligned (n_cols % 4 != 0) takes 4-byte stores for its
//      ragged head and tail;
//   2. __syncthreads();
//   3. the block scatters the row's K entries, skipping -1 padding (and any
//      column outside [0, n_cols), which the TPU kernel never matches), with
//      f32 atomicAdd so that duplicate columns add up as the oracle's do.
//
// Bound: writing the dense output.  At the cell path's shapes (R = 64,
// K ~ 1,800, n_cols = 62,710) the kernel writes 16.1 MB and reads 0.9 MB of
// ELL, so an H100 SXM needs at least (16.1 + 0.9) MB / 3.35 TB/s ~ 5 us.
// The atomics touch 0.1 M addresses, all distinct in canonical CSR.
// On an H100 SXM at 700 W it writes about 1.8 TB/s at R = 64 and no
// faster per byte at R = 132 or 264 (chip_smoke.py), so more blocks per
// row would not help.  Finding what holds it near half the HBM rate,
// fusing log1p and reading CSR without ELL padding are left to later work.
//
// Plain C entry points, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
ell_to_dense_f32_kernel(const float* __restrict__ vals,
                        const int* __restrict__ cols,
                        float* __restrict__ out,
                        int64_t K, int64_t n_cols) {
  const int64_t r = blockIdx.x;
  float* row = out + r * n_cols;
  const int64_t t = threadIdx.x;

  // 1. zero-fill: scalar head up to a 16-byte boundary, float4 body, scalar tail
  const int64_t past = (reinterpret_cast<uintptr_t>(row) >> 2) & 3;
  int64_t head = (4 - past) & 3;
  if (head > n_cols) head = n_cols;
  const int64_t n_vec = (n_cols - head) >> 2;
  float4* body = reinterpret_cast<float4*>(row + head);
  for (int64_t i = t; i < n_vec; i += kThreads) {
    body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int64_t tail = head + (n_vec << 2);  // first column after the body
  if (t < head) {
    row[t] = 0.f;
  } else if (t - head < n_cols - tail) {
    row[tail + (t - head)] = 0.f;
  }
  __syncthreads();

  // 3. scatter the row's entries
  const float* v = vals + r * K;
  const int* c = cols + r * K;
  for (int64_t k = t; k < K; k += kThreads) {
    const int col = c[k];
    if (col >= 0 && col < n_cols) {
      atomicAdd(row + col, v[k]);
    }
  }
}

}  // namespace

extern "C" int ell_to_dense_f32(const void* vals, const void* cols, void* out,
                                int64_t R, int64_t K, int64_t n_cols,
                                void* stream) {
  ell_to_dense_f32_kernel<<<dim3(static_cast<unsigned>(R)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<float*>(out), K, n_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
