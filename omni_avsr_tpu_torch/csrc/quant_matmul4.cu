// Packed-int4 weight-only matmul for Hopper (sm_90a): y = (x @ w) * s[col]
// with x bf16 (M, K), w two int4 codes per byte, s f32 (N,), an f32
// accumulator and a bf16 or f32 result.
//
// Replaces B6 `_qmm4_kernel` (`quantized_matmul4`) of
// `omni_avsr_tpu/ops/quant.py`: two int4 codes per byte, in `pack_int4`'s
// layout. Within each block_n-wide column chunk the low nibble of byte j
// holds column j as offset binary (code + 8) and the high nibble holds
// column j + block_n/2, signed. The TPU kernel keeps the offset in the
// product and subtracts 8 * rowsum(x) at the end (Mosaic has no 8-bit
// shift); here each nibble is decoded straight to its signed code, which is
// the same function.
//
// This is the first design of the weight-only matmul, kept for int4 (the
// int8 weights have their own kernel in quant_matmul.cu); the template
// still takes either code width.
//
// Design: one block per (BM x BN) output tile and, when the tiles are too
// few to fill the card, per slice of K (split-K; the slices' f32 partial
// sums go to a workspace that `qmm_reduce` sums, scales and casts). The
// block walks its K range in BK-deep steps through a ring of STAGES
// shared-memory stages filled with cp.async: the x tile as bf16 and the
// weight tile as raw bytes (BN/2 bytes of nibble pairs that decode to BN
// columns). Each step converts the raw weights to bf16 in shared memory
// once, and the warps run bf16 mma.sync (m16n8k16, f32 accumulate) with
// ldmatrix fragment loads. The epilogue multiplies by s[col] and stores
// bf16 or f32.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): decode, M = B x
// beams = 45, is memory-bound (one decode step reads ~0.62 GB of packed
// codes, 0.19 ms). What holds it back is the 64-row tile (30% idle at
// M = 45), the workspace round trip of the split (through L2), the
// convert pass through shared memory and the per-launch cost at these
// small sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

using port::cp_async16;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_, bool INT4_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr bool INT4 = INT4_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_LD = BK + 8;                   // bf16 per x row in smem (padded)
  static constexpr int W_LD = BN + 8;                   // bf16 per weight row in smem
  static constexpr int RAW_LD = INT4 ? BN / 2 : BN;     // raw weight bytes per k row
  static constexpr int A_STAGE = BM * A_LD;             // bf16 elements
  static constexpr int RAW_STAGE = BK * RAW_LD;         // bytes
  static constexpr size_t SMEM =
      (size_t)STAGES * A_STAGE * 2 + (size_t)BK * W_LD * 2 + (size_t)STAGES * RAW_STAGE;
};

// M <= 64 (decode): 64 x 64 tiles, 4 warps of 32 x 32, 4 stages.
// Larger M: 128 x 128 tiles, 8 warps of 64 x 32, 3 stages.
// `omni_avsr_tpu_torch/ops/quant.py::_split_plan` mirrors these tiles.
template <bool INT4>
using SmallTile = Tile<64, 64, 64, 32, 32, 4, INT4>;
template <bool INT4>
using LargeTile = Tile<128, 128, 32, 64, 32, 3, INT4>;

__device__ __forceinline__ void int8x16_to_bf16(const uint4 raw, uint4 (&out)[2]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = port::pack_bf16x2((float)b[2 * i], (float)b[2 * i + 1]);
}

// 16 nibble-pair bytes -> 16 low codes (offset binary) and 16 high codes.
__device__ __forceinline__ void int4x32_to_bf16(const uint4 raw, uint4 (&lo)[2], uint4 (&hi)[2]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint32_t* ol = reinterpret_cast<uint32_t*>(lo);
  uint32_t* oh = reinterpret_cast<uint32_t*>(hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p0 = b[2 * i], p1 = b[2 * i + 1];
    ol[i] = port::pack_bf16x2((float)((p0 & 0xF) - 8), (float)((p1 & 0xF) - 8));
    oh[i] = port::pack_bf16x2((float)(p0 >> 4), (float)(p1 >> 4));  // arithmetic shift
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS) qmm_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, K)
    const int8_t* __restrict__ w,         // int8: (K, w_ld); int4: (K, chunks * bn2)
    const float* __restrict__ s,          // (N,)
    void* __restrict__ out,               // (M, N) bf16 or f32
    float* __restrict__ ws,               // (splits, M, N) f32 partials when split
    int M, int N, int K, int wp, int kt_per, int out_f32) {
  // wp: int8, the codes' row stride w_ld >= N (a multiple of 16; the columns
  // past N are zero); int4, bn2 = block_n / 2 of the packing.
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW = sA + C::STAGES * C::A_STAGE;
  int8_t* sRaw = reinterpret_cast<int8_t*>(sW + C::BK * C::W_LD);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM;
  const int splits = gridDim.z;
  const int ktiles = (K + C::BK - 1) / C::BK;
  const int kt0 = blockIdx.z * kt_per;
  const int nk = min(ktiles, kt0 + kt_per) - kt0;

  // The block's weight columns: int8 reads BN bytes of each k row from
  // column n0; int4 reads BN/2 bytes of chunk c from byte j0, whose low
  // nibbles are columns c*2*bn2 + j0 + [0, BN/2) and high nibbles columns
  // c*2*bn2 + bn2 + j0 + [0, BN/2).
  int n0, w_ld, raw_col, hi_col;
  if constexpr (C::INT4) {
    const int bn2 = wp;
    const int per_chunk = bn2 / (C::BN / 2);
    const int chunk = blockIdx.x / per_chunk;
    const int j0 = (blockIdx.x % per_chunk) * (C::BN / 2);
    const int chunks = (N + 2 * bn2 - 1) / (2 * bn2);
    w_ld = chunks * bn2;
    raw_col = chunk * bn2 + j0;
    n0 = chunk * 2 * bn2 + j0;
    hi_col = n0 + bn2;
  } else {
    w_ld = wp;
    n0 = blockIdx.x * C::BN;
    raw_col = n0;
    hi_col = 0;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * C::BK;
    __nv_bfloat16* a = sA + stage * C::A_STAGE;
    constexpr int A_CHUNKS = C::BM * C::BK / 8;
    for (int i = tid; i < A_CHUNKS; i += C::THREADS) {
      const int r = i / (C::BK / 8), c = (i % (C::BK / 8)) * 8;
      const bool ok = (m0 + r < M) && (k0 + c < K);
      const __nv_bfloat16* src = ok ? x + (size_t)(m0 + r) * K + k0 + c : x;
      cp_async16(a + r * C::A_LD + c, src, ok);
    }
    int8_t* raw = sRaw + stage * C::RAW_STAGE;
    constexpr int W_CHUNKS = C::BK * C::RAW_LD / 16;
    for (int i = tid; i < W_CHUNKS; i += C::THREADS) {
      const int r = i / (C::RAW_LD / 16), c = (i % (C::RAW_LD / 16)) * 16;
      // int8: a 16-column chunk lies wholly inside or outside the row
      // (w_ld % 16 == 0); int4: the packed row holds every chunk's bytes
      const bool ok = (k0 + r < K) && (C::INT4 || raw_col + c < w_ld);
      const int8_t* src = ok ? w + (size_t)(k0 + r) * w_ld + raw_col + c : w;
      cp_async16(raw + r * C::RAW_LD + c, src, ok);
    }
  };

  auto convert_stage = [&](int stage) {
    const int8_t* raw = sRaw + stage * C::RAW_STAGE;
    constexpr int W_CHUNKS = C::BK * C::RAW_LD / 16;
    for (int i = tid; i < W_CHUNKS; i += C::THREADS) {
      const int r = i / (C::RAW_LD / 16), c = (i % (C::RAW_LD / 16)) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + r * C::RAW_LD + c);
      uint4* dst = reinterpret_cast<uint4*>(sW + r * C::W_LD + c);
      if constexpr (C::INT4) {
        uint4 lo[2], hi[2];
        int4x32_to_bf16(v, lo, hi);
        uint4* dst_hi = reinterpret_cast<uint4*>(sW + r * C::W_LD + C::BN / 2 + c);
        dst[0] = lo[0];
        dst[1] = lo[1];
        dst_hi[0] = hi[0];
        dst_hi[1] = hi[1];
      } else {
        uint4 o[2];
        int8x16_to_bf16(v, o);
        dst[0] = o[0];
        dst[1] = o[1];
      }
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nk) load_stage(st, kt0 + st);
    port::cp_async_commit();
  }

  const int row_base = m0 + wm * C::WM;
  const bool pairs = (N & 1) == 0;  // an even N keeps (col, col+1) pairs 8-byte aligned
  for (int it = 0; it < nk; ++it) {
    port::cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with step it-1
    const int nxt = it + C::STAGES - 1;
    if (nxt < nk) load_stage(nxt % C::STAGES, kt0 + nxt);
    port::cp_async_commit();
    convert_stage(it % C::STAGES);
    __syncthreads();

    const __nv_bfloat16* a = sA + (it % C::STAGES) * C::A_STAGE;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t bfr[C::NT][2];
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t r[4];
        const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ncol = wn * C::WN + np * 16 + (lane >> 4) * 8;
        port::ldmatrix_x4_trans(r, sW + krow * C::W_LD + ncol);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        if (row_base + mt * 16 >= M) continue;  // warp-uniform: rows past M
        uint32_t afr[4];
        const int arow = wm * C::WM + mt * 16 + (lane & 15);
        port::ldmatrix_x4(afr, a + arow * C::A_LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) port::mma_bf16(acc[mt][nt], afr, bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  port::cp_async_wait<0>();

  // Epilogue: local column lc -> global column (int4: the high half of the
  // tile maps to the chunk's second half). Pairs (lc, lc+1) never straddle
  // the halves; with an odd N they are stored one value at a time.
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int lc = wn * C::WN + nt * 8 + 2 * (lane & 3);
      int col;
      if constexpr (C::INT4) {
        col = lc < C::BN / 2 ? n0 + lc : hi_col + lc - C::BN / 2;
      } else {
        col = n0 + lc;
      }
      if (col >= N) continue;
      const bool has1 = col + 1 < N;
      const float s0 = splits > 1 ? 1.f : s[col];
      const float s1 = splits > 1 || !has1 ? 1.f : s[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row_base + mt * 16 + (lane >> 2) + half * 8;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * half] * s0, v1 = acc[mt][nt][2 * half + 1] * s1;
        const size_t off = (size_t)row * N + col;
        if (splits > 1 || out_f32) {
          float* o = splits > 1 ? ws + (size_t)blockIdx.z * M * N + off
                                : static_cast<float*>(out) + off;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (has1) o[1] = v1;
          }
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + off;
          if (pairs) {
            *reinterpret_cast<uint32_t*>(o) = port::pack_bf16x2(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (has1) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

// Split-K: out[m, n] = (sum over slices of ws[z, m, n]) * s[n].
__global__ void qmm_reduce(const float* __restrict__ ws, const float* __restrict__ s,
                           void* __restrict__ out, int M, int N, int splits, int out_f32) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z) a += ws[(size_t)z * total + i];
    a *= s[i % N];
    if (out_f32) {
      static_cast<float*>(out)[i] = a;
    } else {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(a);
    }
  }
}

template <class C>
int launch(const void* x, const void* w, const void* s, void* out, void* ws, int M, int N,
           int K, int wp, int splits, int out_f32, cudaStream_t stream) {
  static bool smem_set = false;  // the attribute is per kernel, per device context
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  int ntiles;
  if constexpr (C::INT4) {
    const int bn2 = wp;
    if (bn2 % (C::BN / 2)) return (int)cudaErrorInvalidValue;
    const int chunks = (N + 2 * bn2 - 1) / (2 * bn2);
    ntiles = chunks * (2 * bn2 / C::BN);
  } else {
    ntiles = (N + C::BN - 1) / C::BN;
  }
  const int ktiles = (K + C::BK - 1) / C::BK;
  const int kt_per = (ktiles + splits - 1) / splits;
  if ((ktiles + kt_per - 1) / kt_per != splits) return (int)cudaErrorInvalidValue;
  const dim3 grid(ntiles, (M + C::BM - 1) / C::BM, splits);
  qmm_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), out, static_cast<float*>(ws), M, N, K, wp, kt_per, out_f32);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  qmm_reduce<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                         static_cast<const float*>(s), out, M, N, splits,
                                         out_f32);
  return (int)cudaGetLastError();
}

template <bool INT4>
int dispatch(const void* x, const void* w, const void* s, void* out, void* ws, int M, int N,
             int K, int wp, int splits, int out_f32, void* stream) {
  // int8 rows load in 16-byte chunks from a row stride w_ld = wp >= N
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || splits < 1 ||
      (!INT4 && (wp < N || wp % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 64) {
    return launch<SmallTile<INT4>>(x, w, s, out, ws, M, N, K, wp, splits, out_f32, st);
  }
  return launch<LargeTile<INT4>>(x, w, s, out, ws, M, N, K, wp, splits, out_f32, st);
}

}  // namespace

// x (M, K) bf16, w packed two codes per byte, (K, chunks, bn2) int8 with
// chunks = ceil(N / (2 * bn2)), s (N,) f32 -> out (M, N) bf16 or f32.
// `ws` holds splits * M * N floats when splits > 1.
extern "C" int qmm4_launch(const void* x, const void* w, const void* s, void* out, void* ws,
                           int M, int N, int K, int bn2, int splits, int out_f32,
                           void* stream) {
  if (bn2 <= 0 || bn2 % 64) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, w, s, out, ws, M, N, K, bn2, splits, out_f32, stream);
}
