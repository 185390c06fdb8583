// Hopper (sm_90a) building blocks in PTX for the port's kernels: mbarriers,
// TMA tile loads from a tensor map and stores to one (bulk groups), wgmma
// shared-memory descriptors for the 128-byte swizzle, the warpgroup
// products the flash-attention kernels use (n32, n64, n128 and n256), the
// persistent blocks' order of work items, setmaxnreg, ex2.approx, and the
// host-side tensor-map encoding of swizzled rank-4 bf16 tiles and plain
// rank-3 boxes (the driver's cuTensorMapEncodeTiled, reached through the
// runtime's cudaGetDriverEntryPointByVersion so that nothing links libcuda).
//
// Shared-memory tiles are rows of 128 bytes (64 bf16 values) written by
// TMA with CU_TENSOR_MAP_SWIZZLE_128B: within each 1,024-byte atom of 8
// rows, 16-byte chunk j of row r lands at chunk j ^ (r % 8).  A wider row
// (head_dim 128 or 256) is kept as two or four such panels.  Every atom
// starts on a 1,024-byte boundary, so the descriptors' base offset is 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// --------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a rank-4 tensor map into shared memory at `dst`; completion
// is reported to `bar` in bytes.  Coordinates are innermost first; a box
// past the tensor's end is filled with zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same for a rank-3 tensor map.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A box of shared memory at `src` into a rank-3 tensor map's tensor at
// the given coordinates, innermost first, as one bulk group of the calling
// thread; the parts of the box past the tensor's end are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Wait until at most N of the calling thread's bulk groups still read
// shared memory (their sources may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of the calling thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's writes to shared memory visible to TMA (the async
// proxy) before a TMA store reads them.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled operand at shared address `addr`:
// `lbo` and `sbo` in bytes (K-major: sbo = the 8-row stride, lbo unused;
// MN-major: sbo = the 8-row stride along K, lbo = the stride between
// 64-wide panels along M or N).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_D8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D16 HOPPER_D8(0), HOPPER_D8(8)
#define HOPPER_D32 HOPPER_D16, HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D64 HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_D128                                                                   \
  HOPPER_D64, HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88), HOPPER_D8(96), \
      HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)
#define HOPPER_R16                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define HOPPER_R128                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (+)= A . B for a 64 x 128 float32 tile, k = 16: A (64 x 16) and B
// (128 x 16) both K-major in shared memory.  scale_d 0 overwrites d.
// Thread (warp w, lane 4g + t) of the warpgroup holds d[4j + x] = D[16w +
// g + 8 (x / 2)][8j + 2t + x % 2], the mma.sync C layout per 8 columns.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same for a 64 x 64 tile (the backward's 64-query score tiles).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same for a 64 x 32 tile (the backward's dq at head_dim 256: 32-key
// score tiles).
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D16
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B with A (64 x 16 bf16) from registers in the mma.sync A layout
// per warp (a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 =
// A[g+8][2t+8..]) and B (16 x N) MN-major in shared memory (transposed:
// the rows of the tile are B's K axis).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for a 64 x 256 tile (head_dim 256's O, and the backward's dQ,
// dK and dV there): B is 16 rows of V, K, dO or Q across four 64-column
// panels, `lbo` bytes apart in the descriptor.
__device__ __forceinline__ void wgmma_m64n256k16_rs_tb(float (&d)[128], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HOPPER_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_D8
#undef HOPPER_D16
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_D128
#undef HOPPER_R16
#undef HOPPER_R32
#undef HOPPER_R64
#undef HOPPER_R128

// ------------------------------------------------------------- the rest
// The work items of a persistent block: round r of gridDim.x items goes
// forward on even rounds and backward on odd ones, which evens out work
// items ordered longest first.
__device__ __forceinline__ int item_of_round(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// x clamped to [-1, n]: a column's bound in a mask, with every comparison
// against a column in [0, n) unchanged
template <int n>
__device__ __forceinline__ int clamp_col(int64_t x) {
  return static_cast<int>(x < -1 ? -1 : (x > n ? n : x));
}

// x, as a value the compiler must take to be written here: descriptors
// computed from it inside a loop are computed there at each use, not held
// in registers across the loop (a kernel at its register limit spills them).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Hand registers from a warpgroup that needs few to one that needs many.
template <int kRegs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// 2**x on the special-function unit (about 2 ulp; 2**-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled (CUDA 12.0's signature), or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A rank-4 bf16 tensor map of a (B, heads, rows, D) view with element
// strides sb, sh, sr and a contiguous last axis, read in boxes of
// 64 columns x box_rows rows with the 128-byte swizzle.  An axis of length
// 1 is given a stride of its own (its stride is never used, and TMA wants
// every stride a multiple of 16 bytes).  Returns a cudaError_t.
inline int encode_bhsd(CUtensorMap* map, const void* base, int64_t B, int64_t heads,
                       int64_t rows, int64_t D, int64_t sb, int64_t sh, int64_t sr,
                       uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  int64_t packed = 2 * D;
  const cuuint64_t stride_r = rows > 1 ? 2 * sr : packed;
  packed *= rows;
  const cuuint64_t stride_h = heads > 1 ? 2 * sh : packed;
  packed *= heads;
  const cuuint64_t stride_b = B > 1 ? 2 * sb : packed;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {stride_r, stride_h, stride_b};
  const cuuint32_t box[4] = {64, box_rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A rank-3 tensor map, without swizzle, of a (d2, d1, d0) view of 32-bit
// (`fp32`) or bf16 values with element strides s1, s2 and a contiguous
// innermost axis, read in boxes of box0 x box1 x 1.  An axis of length 1 is
// never stepped along, so it is given a stride of its own: the packed one,
// rounded up to the 16 bytes TMA asks of every stride (a row of d0 values
// need not be a multiple of 16 bytes there).  Returns a cudaError_t.
inline int encode_3d(CUtensorMap* map, bool fp32, const void* base, int64_t d0, int64_t d1,
                     int64_t d2, int64_t s1, int64_t s2, uint32_t box0, uint32_t box1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int64_t size = fp32 ? 4 : 2;
  const auto up16 = [](int64_t bytes) { return cuuint64_t((bytes + 15) / 16 * 16); };
  const cuuint64_t stride1 = d1 > 1 ? size * s1 : up16(size * d0);
  const cuuint64_t stride2 = d2 > 1 ? size * s2 : up16(stride1 * d1);
  const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2)};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      encode(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kMaxDevices = 64;

// Launch the persistent `kernel` on min(items, SMs) blocks of `threads`
// with `smem` bytes of dynamic shared memory, its limit raised once per
// device (`sms`, one array per kernel, caches each device's SM count).
// Returns a cudaError_t.
template <typename Kernel>
int launch_persistent(Kernel kernel, int (&sms)[kMaxDevices], int64_t items, int threads,
                      int smem, void** args, cudaStream_t stream) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    int n = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms[device] = n;
  }
  const dim3 grid(static_cast<unsigned>(items < sms[device] ? items : sms[device]));
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(threads), args, smem,
                       stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
