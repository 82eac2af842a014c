// Weight-only int8 and packed-int4 matmul for Hopper (sm_90a): y = (x @ w)
// * s[col] with x bf16 (M, K), w int8 or int4 codes, s f32 (N,), an f32
// accumulator and a bf16 or f32 result. One design, templated on the code
// width BITS (8 or 4).
//
// Replaces B2 `_qmm_kernel` (`quantized_matmul`) and B6 `_qmm4_kernel`
// (`quantized_matmul4`) of `omni_avsr_tpu/ops/quant.py`. The codes are the
// JAX package's, read in the card layouts of
// `omni_avsr_tpu_torch/ops/quant.py::arrange_int8_for_card` and
// `::arrange_int4_for_card`: (Np/64, Kp/64, 64 * BITS * 8) bytes, N padded to
// a multiple of 128 and K to one of 64 with zero codes. Each chunk holds 64
// weight columns x 64 k as four 16-column tiles of 16 * BITS * 8 bytes, and
// in a tile each lane's 16-byte words are its bf16 A fragments of
// mma.sync m16n8k16 (and of wgmma, whose warps hold the same fragments), in
// register order:
//   - int8: the 512 bytes of each 32-deep half are one 16-byte word per
//     lane, the fragments of two 16-deep steps, one byte per code,
//     converted exactly as byte ^ 0x80 under the exponent of 2^23, minus
//     2^23 + 128;
//   - int4: one 16-byte word per lane holds the fragments of all four
//     16-deep steps, one 32-bit word per step, the offset code (code + 8)
//     of register j's lower k in bits 4j..4j+3 and of its upper k in bits
//     16+4j..16+4j+3. One lop3 ((w >> 4j) & 0x000F000F | 0x43004300) makes
//     the bf16 pair 128 + code + 8, and one bf16x2 subtraction of 136 the
//     code: exact, three instructions per two codes.
// So a warp's weights for one 64-deep step are two (int8) or one (int4)
// conflict-free 16-byte shared-memory loads per lane, converted in
// registers straight into A fragments. Each weight byte crosses shared
// memory once; nothing is converted back into shared memory.
//
// The product is taken swapped, y^T = w^T x^T: the weight columns are the
// tensor cores' row operand (A), the tokens (rows of x) their N. Both
// kernels stream with one producer warp whose lane 0 keeps a ring of
// shared-memory stages full: TMA loads of x tiles (tokens x 64 k, 128-byte
// swizzle; rows past M and k past K read as zero) and bulk copies of the
// contiguous code chunks, each stage completing on its mbarrier; consumers
// release a stage through a second mbarrier.
//
//   - decode, M <= 64 (M 45 = 3 requests x 15 beams; bound by bytes: one
//     step reads 1.24 GB of int8 codes, 0.37 ms at 3.35 TB/s, or 0.62 GB of
//     int4 codes, 0.19 ms). The token tile is M rounded up to 16 (48 at M
//     45). A block owns a group of CW 16-column tiles and splits K KS ways
//     among its warps: warp (k group kg, column warp cw) takes 16 columns
//     and the kg-th 64-deep step of each KS*64-deep stage, with bf16
//     mma.sync (16 columns x 8 tokens, x fragments by ldmatrix from the
//     swizzled x tile). The KS partial sums are added through shared memory
//     in a fixed order: no workspace, no second launch, the same result on
//     every run. What bounds these small products on the card is less the
//     bytes than the issue rate of one SM (the conversion and the mma
//     instructions of its warps) and each launch's fixed latency, so the
//     plan spreads every matrix over all SMs: the narrow q|k|v, o and down
//     in groups of 16 or 32 columns with K split 8 or 4 ways, the wide
//     gate|up and lm_head in groups of 128 (fewer x reads) with K split 2
//     ways, one block per SM walking its share of the groups while the ring
//     streams on. (Splitting K across a cluster's blocks instead, with the
//     sums added through distributed shared memory, measured slower on the
//     card: each block pays the fixed latency again.)
//     The same kernel takes 64-token tiles (a grid of them) for the towers'
//     and prefill's products whose wgmma tiles would fill less than a
//     quarter of the SMs (the 1024-wide ones at the bucketed window).
//   - towers and prefill, M > 64 (bound by operations: fc1 at M 4500 is
//     37.7 GFLOP, 38 us at 989 TFLOP/s). Token tiles of 128 or 256, two
//     consumer warpgroups of 64 columns each, wgmma m64nNk16 with A from
//     registers and the x tile as the shared-memory B operand, one 64-deep
//     step per stage. Each warpgroup converts its step's fragments while the
//     other's wgmma run; it waits for its own wgmma before converting the
//     next step (converting while they run makes ptxas serialise them).
// The epilogue multiplies by s[col] and stores bf16 or f32 (the tower kernel
// through shared memory, 16 bytes a store).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BK = 64;            // k per step
constexpr int MAX_SMEM = 232448;  // the H100's dynamic shared memory per block

// Code bytes of a 16-column tile and of a 64-column chunk, per 64-deep step.
template <int BITS>
constexpr int TILE16 = 16 * BK * BITS / 8;
template <int BITS>
constexpr int W_TILE = 4 * TILE16<BITS>;

// Four int8 codes -> two bf16 pairs (bytes 0,1 and 2,3), exactly.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;  // offset binary, b + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = port::pack_bf16x2(f0, f1);
  hi = port::pack_bf16x2(f2, f3);
}

// The four A registers of one 16-deep step from an int4 word: register j
// is nibbles j (lower k) and j + 4 (upper k), each code + 8, exactly.
__device__ __forceinline__ void int4x8_to_bf16(uint32_t w, uint32_t* a) {
  const uint32_t k136 = 0x43084308u;  // the bf16 pair (136, 136)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;  // one lop3
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     *reinterpret_cast<const __nv_bfloat162*>(&k136));
    a[j] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// A warp's 16 columns x 64 k of one step (at `wt`, lane-offset): the A
// fragments of four 16-deep steps, a[4 kk .. 4 kk + 3].
template <int BITS>
__device__ __forceinline__ void load_a(const unsigned char* wt, uint32_t (&a)[16]) {
  const uint4 v0 = *reinterpret_cast<const uint4*>(wt);
  if constexpr (BITS == 4) {
    int4x8_to_bf16(v0.x, a);
    int4x8_to_bf16(v0.y, a + 4);
    int4x8_to_bf16(v0.z, a + 8);
    int4x8_to_bf16(v0.w, a + 12);
  } else {
    const uint4 v1 = *reinterpret_cast<const uint4*>(wt + 512);
    int8x4_to_bf16(v0.x, a[0], a[1]);
    int8x4_to_bf16(v0.y, a[2], a[3]);
    int8x4_to_bf16(v0.z, a[4], a[5]);
    int8x4_to_bf16(v0.w, a[6], a[7]);
    int8x4_to_bf16(v1.x, a[8], a[9]);
    int8x4_to_bf16(v1.y, a[10], a[11]);
    int8x4_to_bf16(v1.z, a[12], a[13]);
    int8x4_to_bf16(v1.w, a[14], a[15]);
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The ring: `stages` stages of KS x (an x tile of NT x 64 and the codes of
// CW 16-column tiles x 64 k), x tiles first (1024-byte aligned, as the
// 128-byte swizzle needs), then the codes, then the full and empty barriers.
template <int BITS, int NT, int KS, int CW>
struct Ring {
  static constexpr int X_TILE = NT * BK * 2;        // a multiple of 1024
  static constexpr int X_STAGE = KS * X_TILE;
  static constexpr int W_STAGE = KS * CW * TILE16<BITS>;
  static size_t smem(int stages) {
    return 1024 + (size_t)stages * (X_STAGE + W_STAGE) + 2 * (size_t)stages * sizeof(uint64_t);
  }
  unsigned char* x;
  unsigned char* w;
  uint64_t* full;
  uint64_t* empty;
  __device__ Ring(unsigned char* raw, int stages) {
    x = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                         ~(uintptr_t)1023);
    w = x + (size_t)stages * X_STAGE;
    full = reinterpret_cast<uint64_t*>(w + (size_t)stages * W_STAGE);
    empty = full + stages;
  }
};

// The offset in a stage of the codes of 16-column tile cw, step kg: with
// whole 64-column chunks, (chunk, step, tile in the chunk), as the card
// layout keeps a chunk's steps contiguous; else (step, tile).
template <int BITS, int KS, int CW>
__device__ __forceinline__ int w_offset(int cw, int kg) {
  return CW >= 4 ? ((cw >> 2) * KS + kg) * W_TILE<BITS> + (cw & 3) * TILE16<BITS>
                 : (kg * CW + cw) * TILE16<BITS>;
}

// The producer's loop (lane 0 of the producer warp) over one group of CW
// 16-column tiles from tile t0: its stage i, the ring's stage it0 + i, holds
// steps i*KS .. + KS - 1 of the x rows m0.. and of the group's codes. The
// codes go first: they need no tensor map.
template <int BITS, int NT, int KS, int CW>
__device__ __forceinline__ void produce(const Ring<BITS, NT, KS, CW>& r,
                                        const CUtensorMap* x_map, const int8_t* wc, int t0,
                                        int m0, int ksteps, int nstages, int stages, int it0) {
  using R = Ring<BITS, NT, KS, CW>;
  constexpr int WT = W_TILE<BITS>, T16 = TILE16<BITS>;
  for (int i = 0; i < nstages; ++i) {
    const int it = it0 + i, st = it % stages;
    if (it >= stages) port::mbar_wait(&r.empty[st], ((it / stages) - 1) & 1);
    port::mbar_arrive_expect_tx(&r.full[st], R::X_STAGE + R::W_STAGE);
    unsigned char* w = r.w + (size_t)st * R::W_STAGE;
    if (CW >= 4) {  // whole chunks: all KS steps of a chunk in one copy
#pragma unroll
      for (int g = 0; g < CW / 4; ++g)
        port::bulk_load(w + w_offset<BITS, KS, CW>(4 * g, 0),
                        wc + ((size_t)(t0 / 4 + g) * ksteps + (size_t)i * KS) * WT, KS * WT,
                        &r.full[st]);
    } else {  // CW tiles of one chunk, one copy per step
#pragma unroll
      for (int kg = 0; kg < KS; ++kg)
        port::bulk_load(w + w_offset<BITS, KS, CW>(0, kg),
                        wc + ((size_t)(t0 / 4) * ksteps + (size_t)i * KS + kg) * WT +
                            (t0 % 4) * T16,
                        CW * T16, &r.full[st]);
    }
#pragma unroll
    for (int kg = 0; kg < KS; ++kg)
      port::tma_load_2d(r.x + (size_t)st * R::X_STAGE + kg * R::X_TILE, x_map, &r.full[st],
                        (i * KS + kg) * BK, m0);
  }
}

__device__ __forceinline__ void store_out(void* out, size_t off, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[off] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(v);
  }
}

// ----------------------------------------------------------------- decode

template <int BITS, int NT, int CW, int KS>
__global__ void __launch_bounds__(32 * CW * KS + 32, 1)
    qmm_decode_kernel(const __grid_constant__ CUtensorMap x_map,  // x (M, K) bf16
                      const int8_t* __restrict__ wc,  // (Np/64, ksteps, W_TILE)
                      const float* __restrict__ s,    // (N,)
                      void* __restrict__ out,         // (M, N) bf16 or f32
                      int M, int N, int ksteps, int stages, int groups, int out_f32) {
  constexpr int NF = NT / 8;  // 8-token fragments
  constexpr int CONSUMERS = 32 * CW * KS;
  constexpr int PART = CW * NF * 4 * 32;  // floats of one k group's partial sums
  using R = Ring<BITS, NT, KS, CW>;
  extern __shared__ unsigned char smem_raw[];
  const R r(smem_raw, stages);
  float* red = reinterpret_cast<float*>(r.empty + stages);  // KS - 1 partial sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nstages = ksteps / KS;  // per column group
  const int m0 = blockIdx.y * NT;   // the block's token tile
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      port::mbar_init(&r.full[i], 1);
      port::mbar_init(&r.empty[i], CW * KS);  // one arrival per consumer warp
    }
    port::fence_mbar_init();
  }
  __syncthreads();

  // the block walks column groups blockIdx.x, + gridDim.x, ..., one ring
  // pass of nstages stages each; the ring's stage count runs on across them
  if (warp == CW * KS) {  // the producer warp
    if (lane == 0) {
      port::prefetch_tensor_map(&x_map);
      for (int grp = blockIdx.x, it = 0; grp < groups; grp += gridDim.x, it += nstages)
        produce(r, &x_map, wc, grp * CW, m0, ksteps, nstages, stages, it);
    }
    return;
  }

  const int kg = warp / CW, cw = warp % CW;  // k group, column warp
  // this lane's ldmatrix row (token) within a 16-token pair and its 16-byte k chunk
  const int xrow = (lane & 7) + ((lane >> 4) << 3), xchunk = (lane >> 3) & 1;
  for (int grp = blockIdx.x, it = 0; grp < groups; grp += gridDim.x, it += nstages) {
    const int n_base = (grp * CW + cw) * 16 + (lane >> 2);
    float sc[2];  // the scales, loaded while the loop runs
#pragma unroll
    for (int h = 0; h < 2; ++h) sc[h] = kg == 0 && n_base + 8 * h < N ? s[n_base + 8 * h] : 0.f;
    float acc[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int i = it; i < it + nstages; ++i) {
      const int st = i % stages;
      port::mbar_wait(&r.full[st], (i / stages) & 1);
      uint32_t a[16];
      load_a<BITS>(r.w + (size_t)st * R::W_STAGE + w_offset<BITS, KS, CW>(cw, kg) + lane * 16,
                   a);
      const unsigned char* xt = r.x + (size_t)st * R::X_STAGE + kg * R::X_TILE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
#pragma unroll
        for (int np = 0; np < NF / 2; ++np) {
          const int row = np * 16 + xrow;
          const int chunk = (kk * 2 + xchunk) ^ (row & 7);  // the TMA's 128-byte swizzle
          uint32_t b[4];
          port::ldmatrix_x4(b, xt + row * 128 + chunk * 16);
          port::mma_bf16(acc[2 * np], ak, b[0], b[1]);
          port::mma_bf16(acc[2 * np + 1], ak, b[2], b[3]);
        }
      }
      __syncwarp();
      if (lane == 0) port::mbar_arrive(&r.empty[st]);
    }
    // the k groups' partial sums, added in a fixed order
    if (KS > 1) {
      named_barrier(1, CONSUMERS);  // the last group's sums are read
      if (kg > 0) {
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(kg - 1) * PART + ((cw * NF + j) * 4 + e) * 32 + lane] = acc[j][e];
      }
      named_barrier(1, CONSUMERS);
      if (kg > 0) continue;
#pragma unroll
      for (int g = 1; g < KS; ++g)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] += red[(g - 1) * PART + ((cw * NF + j) * 4 + e) * 32 + lane];
    }
    // D row = weight column n, D column = token m: y[m, n] = acc * s[n]
    const int m_base = m0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_base + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m_base + 8 * j + e;
          if (m < M) store_out(out, (size_t)m * N + n, acc[j][2 * h + e] * sc[h], out_f32);
        }
    }
  }
}

// ---------------------------------------------------------- towers, prefill

template <int BITS, int NT>
__global__ void __launch_bounds__(288, 1)
    qmm_tower_kernel(const __grid_constant__ CUtensorMap x_map,  // x (M, K) bf16
                     const int8_t* __restrict__ wc,               // (Np/64, ksteps, W_TILE)
                     const float* __restrict__ s,                 // (N,)
                     void* __restrict__ out,                      // (M, N) bf16 or f32
                     int M, int N, int ksteps, int stages, int out_f32) {
  using R = Ring<BITS, NT, 1, 8>;
  constexpr int ACC = NT / 2;  // f32 accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  const R r(smem_raw, stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile0 = blockIdx.x * 2;  // the block's first 64-column tile
  const int m0 = blockIdx.y * NT;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      port::mbar_init(&r.full[i], 1);
      port::mbar_init(&r.empty[i], 8);  // one arrival per consumer warp
    }
    port::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp
    if (lane == 0) {
      port::prefetch_tensor_map(&x_map);
      produce(r, &x_map, wc, 4 * tile0, m0, ksteps, ksteps, stages, 0);
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int n0 = tile0 * 64, nl = wg * 64 + wq * 16 + (lane >> 2);  // this thread's column
  float sc[2];  // the scales, loaded while the loop runs
#pragma unroll
  for (int h = 0; h < 2; ++h) sc[h] = n0 + nl + 8 * h < N ? s[n0 + nl + 8 * h] : 0.f;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int i = 0; i < ksteps; ++i) {
    const int st = i % stages;
    port::mbar_wait(&r.full[st], (i / stages) & 1);
    uint32_t a[16];
    load_a<BITS>(r.w + (size_t)st * R::W_STAGE + w_offset<BITS, 1, 8>(warp, 0) + lane * 16, a);
    port::wgmma_fence();
    const uint32_t xb = port::smem_u32(r.x + (size_t)st * R::X_STAGE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
      port::WgmmaRS<NT>::mma(acc, ak, port::wgmma_desc_sw128(xb + kk * 32));
    }
    port::wgmma_commit();
    port::wgmma_wait<0>();
    if (lane == 0) port::mbar_arrive(&r.empty[st]);
  }

  // D row = weight column n, D column = token m: y[m, n] = acc * s[n], laid
  // out (m, n) in the idle ring (rows of 132 floats: no bank conflicts) and
  // stored 16 bytes at a time along n
  constexpr int LDO = 132;
  float* tile = reinterpret_cast<float*>(r.x);
  named_barrier(1, 256);  // both warpgroups are done with the ring
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile[(8 * j + 2 * (lane & 3) + e) * LDO + nl + 8 * h] = acc[4 * j + 2 * h + e] * sc[h];
  named_barrier(1, 256);
  const int rows = min(NT, M - m0), cols = min(128, N - n0);
  const int vec = out_f32 ? 4 : 8;  // values per 16-byte store
  if (cols == 128 && N % vec == 0) {
    for (int c = tid; c < rows * (128 / vec); c += 256) {
      const int m = c / (128 / vec), n = (c % (128 / vec)) * vec;
      const float4* src = reinterpret_cast<const float4*>(tile + m * LDO + n);
      const size_t off = (size_t)(m0 + m) * N + n0 + n;
      if (out_f32) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = src[0];
      } else {
        const float4 u = src[0], v = src[1];
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) =
            make_uint4(port::pack_bf16x2(u.x, u.y), port::pack_bf16x2(u.z, u.w),
                       port::pack_bf16x2(v.x, v.y), port::pack_bf16x2(v.z, v.w));
      }
    }
  } else {
    for (int c = tid; c < rows * 128; c += 256) {
      const int m = c / 128, n = c % 128;
      if (n < cols) store_out(out, (size_t)(m0 + m) * N + n0 + n, tile[m * LDO + n], out_f32);
    }
  }
}

// ------------------------------------------------------------------ launch

constexpr int kMaxDevices = 64;

// raise the kernel's shared-memory limit on the current device (the attribute
// holds for one device only), once per device and size
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, size_t (&done)[kMaxDevices]) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > done[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    done[dev] = smem;
  }
  return 0;
}

template <int BITS, int NT, int CW, int KS>
int launch_decode(const void* x, const void* wc, const void* s, void* out, int M, int N, int K,
                  int Kp, int stages, int blocks, int out_f32, cudaStream_t stream) {
  static size_t smem_set[kMaxDevices] = {};  // per device
  const size_t smem = Ring<BITS, NT, KS, CW>::smem(stages) + (size_t)(KS - 1) * CW * NT * 64;
  int rc = set_smem(qmm_decode_kernel<BITS, NT, CW, KS>, smem, smem_set);
  if (rc != 0) return rc;
  CUtensorMap map;
  rc = port::encode_bf16_sw128(&map, x, M, K, K, BK, NT);
  if (rc != 0) return rc;
  const int groups = (N + 16 * CW - 1) / (16 * CW);
  const dim3 grid(min(blocks, groups), (M + NT - 1) / NT);
  qmm_decode_kernel<BITS, NT, CW, KS><<<grid, 32 * CW * KS + 32, smem, stream>>>(
      map, static_cast<const int8_t*>(wc), static_cast<const float*>(s), out, M, N, Kp / BK,
      stages, groups, out_f32);
  return (int)cudaGetLastError();
}

template <int BITS, int NT>
int launch_tower(const void* x, const void* wc, const void* s, void* out, int M, int N, int K,
                 int Kp, int stages, int out_f32, cudaStream_t stream) {
  static size_t smem_set[kMaxDevices] = {};  // per device
  const size_t smem = Ring<BITS, NT, 1, 8>::smem(stages);
  int rc = set_smem(qmm_tower_kernel<BITS, NT>, smem, smem_set);
  if (rc != 0) return rc;
  CUtensorMap map;
  rc = port::encode_bf16_sw128(&map, x, M, K, K, BK, NT);
  if (rc != 0) return rc;
  const dim3 grid((N + 127) / 128, (M + NT - 1) / NT);
  qmm_tower_kernel<BITS, NT><<<grid, 288, smem, stream>>>(
      map, static_cast<const int8_t*>(wc), static_cast<const float*>(s), out, M, N, Kp / BK,
      stages, out_f32);
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch(const void* x, const void* wc, const void* s, void* out, int M, int N, int K, int Kp,
             int nt, int cw, int ks, int stages, int blocks, int out_f32, cudaStream_t st) {
  if (nt == 128) return launch_tower<BITS, 128>(x, wc, s, out, M, N, K, Kp, stages, out_f32, st);
  if (nt == 256) return launch_tower<BITS, 256>(x, wc, s, out, M, N, K, Kp, stages, out_f32, st);
#define QMM_DECODE(NT_, CW_, KS_)                                                              \
  if (nt == NT_ && cw == CW_ && ks == KS_)                                                     \
    return launch_decode<BITS, NT_, CW_, KS_>(x, wc, s, out, M, N, K, Kp, stages, blocks,      \
                                              out_f32, st);
#define QMM_DECODE_NT(NT_) \
  QMM_DECODE(NT_, 1, 4)    \
  QMM_DECODE(NT_, 1, 8)    \
  QMM_DECODE(NT_, 2, 4)    \
  QMM_DECODE(NT_, 2, 8)    \
  QMM_DECODE(NT_, 4, 1)    \
  QMM_DECODE(NT_, 4, 2)    \
  QMM_DECODE(NT_, 4, 4)    \
  QMM_DECODE(NT_, 8, 1)    \
  QMM_DECODE(NT_, 8, 2)
  QMM_DECODE_NT(16)
  QMM_DECODE_NT(32)
  QMM_DECODE_NT(48)
  QMM_DECODE_NT(64)
#undef QMM_DECODE_NT
#undef QMM_DECODE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) bf16, wc the card layout (Np/64, Kp/64, 64 * bits * 8) of int8
// (bits 8) or int4 (bits 4) codes, s (N,) f32 -> out (M, N) bf16 or f32, by
// the plan (nt, cw, ks, stages, blocks) of `ops/quant.py::qmm_plan`: nt <= 64
// takes the decode kernel, with token tiles of nt = M rounded up to 16 (M <=
// 64) or of 64, cw column warps and a k split ks among a block's warps (an
// instantiated pair below, ks dividing Kp / 64) and at most `blocks` blocks
// per token tile walking the column groups; nt 128 or 256 (M > 64) the
// tower kernel (cw 8, ks 1), one block a tile. Anything else, or a layout
// that does not fit M, N, K, is refused.
extern "C" int qmm_launch(const void* x, const void* wc, const void* s, void* out, int M, int N,
                          int K, int Kp, int Np, int nt, int cw, int ks, int stages, int blocks,
                          int out_f32, int bits, void* stream) {
  const int w_tile = bits == 4 ? W_TILE<4> : W_TILE<8>;
  const bool layout_ok = (bits == 4 || bits == 8) && K > 0 && K % 16 == 0 && Kp % BK == 0 &&
                         Kp >= K && Kp - K < BK && N > 0 && Np % 128 == 0 && Np >= N &&
                         Np - N < 128;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wc) % 16 == 0;
  const bool plan_ok =
      M > 0 && stages >= 2 && stages <= 8 && blocks >= 1 &&
      (nt <= 64 ? (nt == (M <= 64 ? (M + 15) / 16 * 16 : 64) &&
                   (cw == 1 || cw == 2 || cw == 4 || cw == 8) &&
                   (ks == 1 || ks == 2 || ks == 4 || ks == 8) && cw * ks <= 16 &&
                   (Kp / BK) % ks == 0)
                : (M > 64 && (nt == 128 || nt == 256) && cw == 8 && ks == 1 &&
                   stages * (nt * BK * 2 + 2 * w_tile) >= nt * 132 * 4));  // the epilogue's tile
  if (!layout_ok || !aligned || !plan_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bits == 4)
    return dispatch<4>(x, wc, s, out, M, N, K, Kp, nt, cw, ks, stages, blocks, out_f32, st);
  return dispatch<8>(x, wc, s, out, M, N, K, Kp, nt, cw, ks, stages, blocks, out_f32, st);
}
