// ELL -> dense on Hopper (sm_90a): column tiles scattered in shared memory
// and written to the card's memory once.
//
// Replaces the TPU kernel ell_to_dense / _kernel of
// src/repro/kernels/csr_to_dense.py, which evaluates
//     dense[r, c] = sum_k vals[r, k] * [cols[r, k] == c]
// as compare-and-accumulate sweeps over column tiles: O(R * K * n_cols)
// work (about 7.2 G compares per batch at the cell path's shapes), chosen
// only because a TPU has no scatter.  A GPU scatters, so here the work is
// O(R * (n_cols + tiles * K)).  Each block owns work items (row r, column
// tile [c0, c0 + kTile)), walked as one flat int64 index so that any
// R < 2**31 and any n_cols fit one launch:
//   1. each thread loads kUnroll of the row's (column, value) pairs
//      (coalesced; after the row's first tile they come from L2) while the
//      block zero-fills its tile in shared memory;
//   2. it adds those inside the tile with a shared-memory f32 atomicAdd:
//      duplicate columns add up, -1 padding and any column outside
//      [0, n_cols) (which the TPU kernel never matches) add nothing;
//   3. after one barrier the block writes the tile once, through the
//      epilogue (identity, or log1pf: the cell path's features), with
//      16-byte stores.  The tile sits in shared memory at its global
//      address's offset mod 16, so that a row whose start is not 16-byte
//      aligned (n_cols % 4 != 0; 62,710 columns are 250,840 bytes, 8 mod
//      16) takes 16-byte loads and stores for its whole body and 4-byte
//      ones for its ragged head and tail only.
// No global atomics and no zero-fill pass over the output: each output
// byte is written once.  log1pf is the CUDA math library's, as in
// PyTorch's log1p_ (built without --use_fast_math, it gives the same bits);
// a zero, 97% of the cell path's outputs, skips it (log1pf(+0) is +0).
//
// Bound: writing the dense output.  At the cell path's shapes (R = 64,
// K ~ 1,800, n_cols = 62,710) the kernel writes 16.05 MB and reads 0.92 MB
// of ELL, so an H100 SXM needs at least 16.97 MB / 3.35 TB/s ~ 5.1 us.
// Eight tiles a row make 512 blocks of 32 KB, all resident at once on 132
// SMs; the tiles re-read the row's pairs from L2 (8 * 8 * K bytes a row,
// 115 KB against its 250.8 KB of output).  The shape was set by edited
// copies timed in turns on an H100 (PERF.md): at R = 64, 2,048- and
// 4,096-column tiles, 1,024 threads, persistent grids of 132-396 blocks
// walking the items, a bulk async copy of the body, marks that zero only
// the touched 16-byte chunks, and values loaded only for the columns
// inside the tile were each slower with the epilogue; 256 threads were
// faster without it and slower with it, which the cell path runs.
//
// ell_to_dense_rowblock_f32 is the earlier design (one block per row,
// global zero-fill then global atomics), kept so that the new kernel can be
// timed beside it in one call.
//
// Plain C entry points, loaded with ctypes: each launch returns
// cudaGetLastError() so that a refused launch surfaces in the caller.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 8192;  // columns a block owns: 32 KB of shared memory
constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // (column, value) loads in flight per thread
constexpr int kRowThreads = 512;  // the earlier design's block

template <bool kLog1p>
__device__ __forceinline__ float epilogue(float x) {
  if constexpr (kLog1p) {
    return x == 0.f ? x : log1pf(x);
  } else {
    return x;
  }
}

template <bool kLog1p>
__global__ void __launch_bounds__(kThreads)
ell_to_dense_tiled_kernel(const float* __restrict__ vals,
                          const int* __restrict__ cols,
                          float* __restrict__ out,
                          int64_t R, int64_t K, int64_t n_cols, int64_t tiles) {
  __shared__ __align__(16) float tile[kTile + 4];
  float4* tile4 = reinterpret_cast<float4*>(tile);
  const int t = threadIdx.x;
  for (int64_t item = blockIdx.x; item < R * tiles; item += gridDim.x) {
    const int64_t r = item / tiles;
    const int64_t c0 = (item - r * tiles) * kTile;
    const int width = static_cast<int>(n_cols - c0 < kTile ? n_cols - c0 : kTile);
    float* dst = out + r * n_cols + c0;
    // column c0 + j sits at tile[lead + j], at dst + j's offset mod 16
    const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);

    // 1. load the row's first kUnroll * kThreads columns and values, then
    //    zero the tile while they arrive
    const float* v = vals + r * K;
    const int* c = cols + r * K;
    int64_t j[kUnroll];  // column - c0
    float val[kUnroll];
    auto load = [&](int64_t k0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = k0 + u * kThreads;
        j[u] = k < K ? c[k] - c0 : -1;
        val[u] = k < K ? v[k] : 0.f;
      }
    };
    load(t);
    for (int i = t; i < kTile / 4 + 1; i += kThreads) {
      tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // 2. add the entries that fall in the tile
    for (int64_t k0 = t; k0 < K; k0 += kUnroll * kThreads) {
      if (k0 != t) load(k0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j[u] >= 0 && j[u] < width) {
          atomicAdd(tile + lead + j[u], val[u]);
        }
      }
    }
    __syncthreads();

    // 3. one write: 4-byte head up to a 16-byte boundary, 16-byte body, 4-byte tail
    int head = (4 - lead) & 3;
    if (head > width) head = width;
    const int n_vec = (width - head) >> 2;
    const float4* src4 = tile4 + ((lead + head) >> 2);
    float4* dst4 = reinterpret_cast<float4*>(dst + head);
    for (int i = t; i < n_vec; i += kThreads) {
      float4 x = src4[i];
      x.x = epilogue<kLog1p>(x.x);
      x.y = epilogue<kLog1p>(x.y);
      x.z = epilogue<kLog1p>(x.z);
      x.w = epilogue<kLog1p>(x.w);
      dst4[i] = x;
    }
    const int tail = head + (n_vec << 2);  // first column after the body
    if (t < head) {
      dst[t] = epilogue<kLog1p>(tile[lead + t]);
    } else if (t - head < width - tail) {
      dst[tail + t - head] = epilogue<kLog1p>(tile[lead + tail + t - head]);
    }
    __syncthreads();  // the next item zero-fills the tile
  }
}

// The earlier design: one block per row zero-fills the row in global memory,
// then scatters with global atomics.
__global__ void __launch_bounds__(kRowThreads)
ell_to_dense_rowblock_kernel(const float* __restrict__ vals,
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
  for (int64_t i = t; i < n_vec; i += kRowThreads) {
    body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int64_t tail = head + (n_vec << 2);  // first column after the body
  if (t < head) {
    row[t] = 0.f;
  } else if (t - head < n_cols - tail) {
    row[tail + (t - head)] = 0.f;
  }
  __syncthreads();

  // 2. scatter the row's entries
  const float* v = vals + r * K;
  const int* c = cols + r * K;
  for (int64_t k = t; k < K; k += kRowThreads) {
    const int col = c[k];
    if (col >= 0 && col < n_cols) {
      atomicAdd(row + col, v[k]);
    }
  }
}

}  // namespace

extern "C" int ell_to_dense_f32(const void* vals, const void* cols, void* out,
                                int64_t R, int64_t K, int64_t n_cols, int log1p,
                                void* stream) {
  const int64_t tiles = (n_cols + kTile - 1) / kTile;
  const int64_t items = R * tiles;
  const dim3 grid(static_cast<unsigned>(items < INT_MAX ? items : INT_MAX));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* c = static_cast<const int*>(cols);
  auto* o = static_cast<float*>(out);
  if (log1p) {
    ell_to_dense_tiled_kernel<true><<<grid, kThreads, 0, s>>>(v, c, o, R, K, n_cols, tiles);
  } else {
    ell_to_dense_tiled_kernel<false><<<grid, kThreads, 0, s>>>(v, c, o, R, K, n_cols, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ell_to_dense_rowblock_f32(const void* vals, const void* cols, void* out,
                                         int64_t R, int64_t K, int64_t n_cols,
                                         void* stream) {
  ell_to_dense_rowblock_kernel<<<dim3(static_cast<unsigned>(R)), kRowThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<float*>(out), K, n_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
