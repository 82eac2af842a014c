// Hopper asynchronous copies for the port's kernels (sm_90a): mbarriers,
// TMA tile loads through a tensor map (rank 2 and 4), bulk copies of contiguous bytes,
// and the host-side tensor-map encoder reached through the runtime's
// driver entry point (so a library links only the CUDA runtime).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Blocks until the phase of `bar` with parity `parity` has completed. A
// wait of more than ~10 s of SM clock traps (a launch error) instead of
// hanging the card on a fault.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A 2-D tile of a tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 4-D box of a tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once; null if missing.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major (rows, cols) bf16 matrix with row stride `ld`
// elements, read in (box_cols, box_rows) tiles with the 128-byte swizzle
// (box_cols * 2 == 128); out-of-range elements read as zero. Returns 0 or
// an error code (1000 + the driver's CUresult).
inline int encode_bf16_sw128(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                             uint64_t ld, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// Tensor map of a contiguous (B, T, H, D) bf16 array as the rank-4 (D, H,
// T, B), read in boxes of (64, 1, box_rows, 1): 64 columns (128 bytes) of
// box_rows consecutive positions of one head of one batch entry, in the
// 128-byte swizzle. Positions past T read as zero, never as the next
// batch entry's. Returns 0 or an error code (1000 + the driver's CUresult).
inline int encode_bthd_sw128(CUtensorMap* map, const void* base, uint64_t B, uint64_t T,
                             uint64_t H, uint64_t D, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {D, H, T, B};
  const cuuint64_t strides[3] = {D * 2, H * D * 2, T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// Tensor map of a contiguous (F, H, W, C) bf16 activation as the rank-4
// (C, W, H, F), read in the boxes of an implicit-GEMM conv's tap: 64
// channels (128 bytes, 128-byte swizzle) of `cols` pixels of `rows` rows
// of `frames` frames, every `stride`-th column and row (the box spans
// stride * cols columns and stride * rows rows of the input); pixels
// outside x (the padding, negative coordinates included) read as zero.
// The box lands as frames x rows x cols rows of 128 bytes. Returns 0 or an
// error code (1000 + cuTensorMapEncodeTiled's CUresult).
inline int encode_conv_taps_sw128(CUtensorMap* map, const void* base, uint64_t F, uint64_t H,
                                  uint64_t W, uint64_t C, uint32_t stride, uint32_t cols,
                                  uint32_t rows, uint32_t frames) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {C, W, H, F};
  const cuuint64_t strides[3] = {C * 2, W * C * 2, H * W * C * 2};
  const cuuint32_t box[4] = {64, stride * cols, stride * rows, frames};
  const cuuint32_t elem[4] = {1, stride, stride, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace port
