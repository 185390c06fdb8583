// Pieces shared by the flash-attention kernels (flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the backward): tile sizes, the
// bf16 tensor-core product mma.sync.m16n8k16 and its fragment packing,
// zero-padded tile loads into shared memory, and the launch with a
// dynamic shared-memory size.
//
// Fragment layout of mma.sync.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, by column):  b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, float32):    c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// So the C fragments of two neighbouring 8-column blocks are, packed to
// bf16, the A fragment of a 16-wide slice: a product's result feeds the
// next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

constexpr int kBlockQ = 64;   // query rows per tile
constexpr int kBlockK = 64;   // key rows per tile
constexpr int kThreads = 128; // 4 warps; on the tensor-core path each owns 16 rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [r, r + 16), columns [c, c + 16) of a bf16 tile
// in shared memory with row stride ld.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                            int r, int c, int g, int t) {
  const __nv_bfloat16* lo = tile + (r + g) * ld + c + 2 * t;
  const __nv_bfloat16* hi = lo + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(lo);
  a[1] = *reinterpret_cast<const uint32_t*>(hi);
  a[2] = *reinterpret_cast<const uint32_t*>(lo + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(hi + 8);
}

// acc (+)= A . X^T for 8 blocks of 8 rows of X: A given as kD/16 fragments
// (16 rows x kD), X a (64, kD) bf16 tile whose rows are B's columns.
template <int kD>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[kD / 16][4],
                                         const __nv_bfloat16* X, int g, int t) {
  constexpr int kLd = kD + 8;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const __nv_bfloat16* xr = X + (nb * 8 + g) * kLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      mma_bf16(acc[nb], a[kk], *reinterpret_cast<const uint32_t*>(xr + kk * 16),
               *reinterpret_cast<const uint32_t*>(xr + kk * 16 + 8));
    }
  }
}

// acc (+)= P . X: P a 16 x 64 float32 C-fragment tile (8 blocks of 8
// columns), rounded to bf16 on the way in; X a (64, kD) bf16 tile read by
// column, its first kCols columns from X on (all of them by default).
template <int kD, int kCols = kD>
__device__ __forceinline__ void mma_cols(float (&acc)[kCols / 8][4], const float (&p)[8][4],
                                         const __nv_bfloat16* X, int g, int t) {
  constexpr int kLd = kD + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* xr = X + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
    for (int nd = 0; nd < kCols / 8; ++nd) {
      const __nv_bfloat16* c = xr + nd * 8;
      mma_bf16(acc[nd], pa, pack_raw(c[0], c[kLd]), pack_raw(c[8 * kLd], c[9 * kLd]));
    }
  }
}

// Copy rows [r0, r0 + 64) of one (rows, D) head into a zero-padded
// (64, kD + 8) bf16 tile of shared memory: with 16-byte loads (8 values a
// thread, neighbouring threads on neighbouring bytes) where D fills the
// tile and every row starts 16-byte aligned, as on the model's paths; else
// one value a thread.
template <int kD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                               int64_t row_stride, int r0, int rows, int D) {
  constexpr int kLd = kD + 8;
  if (D == kD && row_stride % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kChunks = kD / 8;
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(tile + r * kLd + c) = val;
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < 64 * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    tile[r * kLd + d] = (r0 + r < rows && d < D) ? src[(r0 + r) * row_stride + d] : zero;
  }
}

// The float32 counterpart: a zero-padded (kRows, kD + 1) tile of rows
// [r0, r0 + kRows), one value a thread (the odd stride puts a column walk
// on distinct banks).
template <int kD, int kRows = 64>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* src, int64_t row_stride,
                                              int r0, int rows, int D) {
  constexpr int kLd = kD + 1;
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    tile[r * kLd + d] = (r0 + r < rows && d < D) ? src[(r0 + r) * row_stride + d] : 0.f;
  }
}

// Launch `kernel` on `grid` x kThreads with `smem` bytes of dynamic shared
// memory (raising the kernel's limit first where it is above 48 KB).
// Returns a cudaError_t: 0 when the launch was taken.
template <typename Kernel, typename Params>
int launch(Kernel kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  void* args[] = {const_cast<Params*>(&p)};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                                           dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
