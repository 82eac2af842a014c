// Fused 2D conv + BN affine + residual + PReLU for the ResNet trunk on
// Hopper (sm_90a):
//   y = conv(x, w, stride, pad)              (bf16 operands, f32 accumulate)
//   y = y * scale[c] + bias[c]               (if affine)
//   y = y + residual                         (if residual)
//   y = max(y, 0) + a[c] * min(y, 0)         (if act; a = 0 is ReLU)
// stored in x's dtype (bf16, or f32 when the caller's x was f32), with x
// (F, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO, residual (F, Ho, Wo, Cout).
//
// Replaces B7, `omni_avsr_tpu/ops/conv_block.py::_conv_kernel` (wrapper
// `conv2d_fused_pallas`, `fused_conv`). The TPU kernel pre-flattens (H, W)
// into one row axis with W padded to 8 and splits stride-2 inputs into four
// phase planes so that each kernel position is one large MXU contraction;
// that layout inflated deep-layer work up to 2.7x and is not carried over.
//
// Both kernels here are implicit GEMMs: rows are output pixels, M = F * Ho
// * Wo; columns are output channels, N = Cout; the depth is K = kh * kw *
// Cin in the order of the HWIO weight reshaped to (K, Cout), as the JAX
// wrapper's `w2d`. Input pixels that a tap puts in the padding are
// zero-filled in shared memory without a read, so stride 2 and pad 0 or 1
// need no padded copy of x. `ops/conv_block.py::conv_plan` picks the
// kernel and its tile from the shape.
//
// What bounds the trunk's 13 geometries at 480 frames on the H100 SXM
// (989 TFLOP/s dense bf16, 3.35 TB/s, 50 MB L2), and what the design does:
//   - bytes: layer1's two convs (M 232,320, N 64, K 576: 30 MB of input
//     and 30 MB of output each, the residual 30 MB more; 17-27 us), layer2's
//     stride-2 conv and the three 1x1 downsamples (K 64-256, one to four
//     64-deep steps a tile). Every tap re-reads its input pixels, nine
//     times in all for a 3x3 conv: those reads are L2 hits (x is at most
//     30 MB) but their traffic, not HBM, is the cost; TMA moves each tap's
//     box in one request (a gather of the same rows with cp.async, 16
//     bytes a thread, was the bound of every conv). The epilogue stores 16
//     bytes a lane (below), and the persistent schedule hides each tile's
//     fixed latency behind the next tile's loads.
//   - operations: layer2's 3x3 stride-1 convs, layer3 and layer4 (K 1152-
//     4608, 10-21 us at the peak). The mma.sync kernel below (128 x 64
//     tiles of 4 warps, 32-deep steps, a __syncthreads per step) is capped
//     near 124 TFLOP/s by mma.sync's issue rate; wgmma is the only way to
//     the tensor cores' full rate, and tiles of 192 rows cut layer4's wave
//     tail (M 4320: 92 tiles of 21 frames x 3 x 3 fill 92 SMs in one
//     round, where 136 tiles of 128 rows took two).
//
// conv_wgmma_kernel (Cin % 64 == 0, Cout % 64 == 0 and output rows of at
// most 192 pixels: every trunk conv after the stem). One 64-deep K step is
// one tap (dh, dw) x 64 channels, 128 bytes of bf16 per output pixel. A
// tile is tf frames x th rows x all Wo columns of the output map, at most
// BM = 64 x NWG pixels (NWG 2 or 3 consumer warpgroups): whole frames
// where they fit (layer2-4), else whole rows (layer1: 8 of 22), so that
// the tap's input is one box of a rank-4 tensor map over x, (Cin, W, H,
// F), with the stride as the box's traversal stride and the padding as
// coordinates outside x; its rows land in shared memory in output-pixel
// order, in the 128-byte swizzle wgmma reads. One persistent block per SM
// walks the tiles, the BN-column tiles (128, or 64 for Cout 64) of one row
// tile in turn (they share its A in L2), through a ring of STAGES stages:
//   - one producer thread issues, per stage, the tap's A box and the B
//     tile, 64 k rows x BN columns of the (K, Cout) weight (rank-2 TMA, 64
//     x 64 boxes), both completing on the stage's mbarrier;
//   - each consumer warpgroup runs wgmma m64nBNk16 on its 64 rows, A and B
//     from shared memory (B MN-major), f32 accumulators in registers, one
//     step's products in flight while the next stage is awaited; it
//     releases the stage when that step's products have read it;
//   - the epilogue runs in registers while the producer already fills the
//     next tile's stages: a 4 x 4 transpose among the four lanes of a row
//     gives each lane 8 consecutive channels, stored (and the residual
//     read) 16 bytes at a time; tile rows past the map are dropped.
// conv_kernel (every other shape, such as Cin 16 or 24): one block
// computes a 128 x 64 output tile with 4 warps of 64 x 32, walking K in
// 32-deep steps through a ring of 4 cp.async stages (Cin a multiple of 8:
// a 16-byte copy never straddles two pixels), bf16 mma.sync m16n8k16 with
// ldmatrix fragment loads, and stores channel pairs.
// Both run the same f32 epilogue: the affine, the residual, then PReLU,
// one store in bf16 or f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using port::cp_async16;

constexpr int BM = 128, BN = 64, BK = 32, WM = 64, WN = 32, STAGES = 4;
constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int A_LD = BK + 8;  // bf16 per A row in shared memory (padded against bank conflicts)
constexpr int B_LD = BN + 8;  // bf16 per B row
constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;
constexpr size_t SMEM = (size_t)STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int A_ROWS_PER_THREAD = BM * BK / 8 / THREADS;  // 16-byte copies of A per stage
constexpr int B_COPIES_PER_THREAD = BK * BN / 8 / THREADS;

struct Geometry {
  int F, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, pad;
};

enum Flags { kAffine = 1, kAct = 2, kResidual = 4, kResidualF32 = 8, kOutF32 = 16 };

// The epilogue of both kernels, in f32: affine, then the residual, then
// PReLU (the BasicBlock order), on a pair of channels (col, col + 1) of one
// output row; Cout is even, so the pair is stored at once.
struct Epilogue {
  const float* scale;
  const float* bias;
  const float* prelu_a;
  const void* residual;
  void* out;
  int Cout, flags;

  struct Col {
    float s0, s1, b0, b1, a0, a1;
  };

  __device__ __forceinline__ Col col(int c) const {
    Col v{1.f, 1.f, 0.f, 0.f, 0.f, 0.f};
    if (flags & kAffine) {
      v.s0 = __ldg(scale + c);
      v.s1 = __ldg(scale + c + 1);
      v.b0 = __ldg(bias + c);
      v.b1 = __ldg(bias + c + 1);
    }
    if (flags & kAct) {
      v.a0 = __ldg(prelu_a + c);
      v.a1 = __ldg(prelu_a + c + 1);
    }
    return v;
  }

  // The same on 8 consecutive channels c .. c + 7 (c % 8 == 0) of one row,
  // v[i] = channels c + 2 i, c + 2 i + 1: 16-byte loads and stores.
  __device__ __forceinline__ void store8(int row, int c, float2 (&v)[4]) const {
    float y[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[2 * i] = v[i].x;
      y[2 * i + 1] = v[i].y;
    }
    if (flags & kAffine) {
      const float4* s4 = reinterpret_cast<const float4*>(scale + c);
      const float4* b4 = reinterpret_cast<const float4*>(bias + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 sc = __ldg(s4 + h), bi = __ldg(b4 + h);
        y[4 * h] = y[4 * h] * sc.x + bi.x;
        y[4 * h + 1] = y[4 * h + 1] * sc.y + bi.y;
        y[4 * h + 2] = y[4 * h + 2] * sc.z + bi.z;
        y[4 * h + 3] = y[4 * h + 3] * sc.w + bi.w;
      }
    }
    const size_t off = (size_t)row * Cout + c;
    if (flags & kResidual) {
      if (flags & kResidualF32) {
        const float4* r4 = reinterpret_cast<const float4*>(static_cast<const float*>(residual) + off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 r = r4[h];
          y[4 * h] += r.x;
          y[4 * h + 1] += r.y;
          y[4 * h + 2] += r.z;
          y[4 * h + 3] += r.w;
        }
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(residual) + off);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 r = __bfloat1622float2(r2[i]);
          y[2 * i] += r.x;
          y[2 * i + 1] += r.y;
        }
      }
    }
    if (flags & kAct) {
      const float4* a4 = reinterpret_cast<const float4*>(prelu_a + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = __ldg(a4 + h);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = y[4 * h + i];
          y[4 * h + i] = fmaxf(x, 0.f) + av[i] * fminf(x, 0.f);
        }
      }
    }
    if (flags & kOutF32) {
      float4* o4 = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
      o4[0] = make_float4(y[0], y[1], y[2], y[3]);
      o4[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      uint4 packed;
      packed.x = port::pack_bf16x2(y[0], y[1]);
      packed.y = port::pack_bf16x2(y[2], y[3]);
      packed.z = port::pack_bf16x2(y[4], y[5]);
      packed.w = port::pack_bf16x2(y[6], y[7]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) = packed;
    }
  }

  __device__ __forceinline__ void store(int row, int c, const Col& k, float v0, float v1) const {
    if (flags & kAffine) {
      v0 = v0 * k.s0 + k.b0;
      v1 = v1 * k.s1 + k.b1;
    }
    const size_t off = (size_t)row * Cout + c;
    if (flags & kResidual) {
      if (flags & kResidualF32) {
        const float2 r = *reinterpret_cast<const float2*>(static_cast<const float*>(residual) + off);
        v0 += r.x;
        v1 += r.y;
      } else {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(residual) + off);
        v0 += __bfloat162float(r.x);
        v1 += __bfloat162float(r.y);
      }
    }
    if (flags & kAct) {
      v0 = fmaxf(v0, 0.f) + k.a0 * fminf(v0, 0.f);
      v1 = fmaxf(v1, 0.f) + k.a1 * fminf(v1, 0.f);
    }
    if (flags & kOutF32) {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + off) = port::pack_bf16x2(v0, v1);
    }
  }
};

__global__ void __launch_bounds__(THREADS) conv_kernel(
    const __nv_bfloat16* __restrict__ x,   // (F, H, W, Cin)
    const __nv_bfloat16* __restrict__ w,   // (K, Cout)
    const Epilogue ep, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HWo = g.Ho * g.Wo;
  const int M = g.F * HWo;
  const int K = g.kh * g.kw * g.Cin;
  const int ktiles = (K + BK - 1) / BK;

  // This thread's A copies: rows a_row0 + 32 j, channels a_col .. a_col + 7
  // of the step's 32-deep slice. Their output pixels' input corners are
  // fixed for the whole K walk.
  const int a_col = (tid % (BK / 8)) * 8;
  const int a_row0 = tid / (BK / 8);
  int ih0[A_ROWS_PER_THREAD], iw0[A_ROWS_PER_THREAD], fbase[A_ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < A_ROWS_PER_THREAD; ++j) {
    const int m = m0 + a_row0 + j * (THREADS / (BK / 8));
    if (m < M) {
      const int f = m / HWo, p = m - f * HWo;
      const int oh = p / g.Wo, ow = p - oh * g.Wo;
      ih0[j] = oh * g.stride - g.pad;
      iw0[j] = ow * g.stride - g.pad;
      fbase[j] = f * g.H;
    } else {
      ih0[j] = -(1 << 28);  // fails the bounds test for every tap
      iw0[j] = 0;
      fbase[j] = 0;
    }
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = sA + stage * A_STAGE;
    const int k = k0 + a_col;
    int dh = 0, dw = 0, ci = 0;
    const bool k_ok = k < K;
    if (k_ok) {
      const int tap = k / g.Cin;
      ci = k - tap * g.Cin;
      dh = tap / g.kw;
      dw = tap - dh * g.kw;
    }
#pragma unroll
    for (int j = 0; j < A_ROWS_PER_THREAD; ++j) {
      const int r = a_row0 + j * (THREADS / (BK / 8));
      const int ih = ih0[j] + dh, iw = iw0[j] + dw;
      const bool ok = k_ok && (unsigned)ih < (unsigned)g.H && (unsigned)iw < (unsigned)g.W;
      const __nv_bfloat16* src =
          ok ? x + ((size_t)(fbase[j] + ih) * g.W + iw) * g.Cin + ci : x;
      cp_async16(a + r * A_LD + a_col, src, ok);
    }
    __nv_bfloat16* b = sB + stage * B_STAGE;
#pragma unroll
    for (int j = 0; j < B_COPIES_PER_THREAD; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = (k0 + r < K) && (n0 + c < g.Cout);
      const __nv_bfloat16* src = ok ? w + (size_t)(k0 + r) * g.Cout + n0 + c : w;
      cp_async16(b + r * B_LD + c, src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, st);
    port::cp_async_commit();
  }

  const int row_base = m0 + wm * WM;
  for (int it = 0; it < ktiles; ++it) {
    port::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with step it - 1
    const int nxt = it + STAGES - 1;
    if (nxt < ktiles) load_stage(nxt % STAGES, nxt);
    port::cp_async_commit();

    const __nv_bfloat16* a = sA + (it % STAGES) * A_STAGE;
    const __nv_bfloat16* b = sB + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ncol = wn * WN + np * 16 + (lane >> 4) * 8;
        port::ldmatrix_x4_trans(r, b + krow * B_LD + ncol);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (row_base + mt * 16 >= M) continue;  // warp-uniform: rows past M
        uint32_t afr[4];
        const int arow = wm * WM + mt * 16 + (lane & 15);
        port::ldmatrix_x4(afr, a + arow * A_LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) port::mma_bf16(acc[mt][nt], afr, bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  port::cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn * WN + nt * 8 + 2 * (lane & 3);
    if (col >= g.Cout) continue;
    const Epilogue::Col k = ep.col(col);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row_base + mt * 16 + (lane >> 2) + half * 8;
        if (row < M) ep.store(row, col, k, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}


// ------------------------------------------------------------------ wgmma

template <int NWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * NWG;            // accumulator rows per tile (output pixels)
  static constexpr int THREADS = 128 * NWG + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * 128;       // BM rows x 64 channels (one tap)
  static constexpr int B_BYTES = BN * 128;       // 64 k rows x BN columns, 64-column blocks
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = (200 * 1024) / STAGE > 8 ? 8 : (200 * 1024) / STAGE;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
};

// A tile of output pixels: `tf` frames x `th` rows x every column of the
// output map (tf * th * Wo <= BM), from frame f0 and row oh0.
struct Tiling {
  int tf, th, h_tiles, m_tiles, n_tiles;
};

// Pins registers at this point of the program: the compiler may not move
// their reads or writes across it, so none crosses a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// v[i] of lane t (of 4 consecutive lanes) <- v[t] of lane i: lane t sends
// v[t ^ k] to lane t ^ k, k = 1..3. Indices by t go through two stages of
// selects (bit 0, then bit 1), so v stays in registers.
__device__ __forceinline__ void permute_xor(float2 (&v)[4], int t) {
  float2 a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = (t & 1) ? v[k ^ 1] : v[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (t & 2) ? a[k ^ 2] : a[k];
}

__device__ __forceinline__ void transpose_quad(float2 (&v)[4], int t) {
  permute_xor(v, t);  // v[k] = v_t[t ^ k], the value for lane t ^ k
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    v[k].x = __shfl_xor_sync(0xffffffffu, v[k].x, k);
    v[k].y = __shfl_xor_sync(0xffffffffu, v[k].y, k);
  }
  permute_xor(v, t);  // v[i] = what lane i sent, v_i[t]
}

template <int NWG, int BN>
__global__ void __launch_bounds__(Cfg<NWG, BN>::THREADS, 1) conv_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,  // x (F, H, W, Cin) as (Cin, W, H, F), tap boxes
    const __grid_constant__ CUtensorMap w_map,  // w (K, Cout) in 64 x 64 boxes, 128-byte swizzle
    const Epilogue ep, const Geometry g, const Tiling tl) {
  using C = Cfg<NWG, BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_work = tl.m_tiles * tl.n_tiles;
  const int ksteps = g.kh * g.kw * g.Cin / 64;
  const int box_rows = tl.tf * tl.th * g.Wo;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      port::mbar_init(&full[i], 1);         // the producer's expect_tx
      port::mbar_init(&empty[i], 4 * NWG);  // one arrival per consumer warp
    }
    port::fence_mbar_init();
  }
  __syncthreads();

  // `it` counts the block's K steps over all its tiles (ring stage it %
  // STAGES), on both sides of the ring alike.
  if (warp == 4 * NWG) {  // the producer warp: its first lane issues every load
    if (lane == 0) {
      port::prefetch_tensor_map(&x_map);
      port::prefetch_tensor_map(&w_map);
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const int mt = w / tl.n_tiles, n0 = (w % tl.n_tiles) * BN;
        const int f0 = (mt / tl.h_tiles) * tl.tf, oh0 = (mt % tl.h_tiles) * tl.th;
        for (int kt = 0; kt < ksteps; ++kt, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) port::mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
          unsigned char* a = ring + st * C::STAGE;
          port::mbar_arrive_expect_tx(&full[st], box_rows * 128 + C::B_BYTES);
          // tap (dh, dw), channels ci .. ci + 63 of every output pixel of the
          // tile: the input from row oh0 * stride - pad + dh and column dw -
          // pad, every stride-th, zeros outside x (the padding)
          const int k0 = kt * 64, tap = k0 / g.Cin, ci = k0 - tap * g.Cin;
          const int dh = tap / g.kw, dw = tap - dh * g.kw;
          port::tma_load_4d(a, &x_map, &full[st], ci, dw - g.pad, oh0 * g.stride - g.pad + dh, f0);
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb)
            port::tma_load_2d(a + C::A_BYTES + nb * 8192, &w_map, &full[st], n0 + nb * 64, k0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  int it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int mt = w / tl.n_tiles, n0 = (w % tl.n_tiles) * BN;
    const int f0 = (mt / tl.h_tiles) * tl.tf, oh0 = (mt % tl.h_tiles) * tl.th;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ksteps; ++kt, ++it) {
      const int st = it % STAGES;
      port::mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t a = port::smem_u32(ring + st * C::STAGE) + wg * 64 * 128;
      const uint32_t b = port::smem_u32(ring + st * C::STAGE + C::A_BYTES);
      fence_regs(acc);
      port::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        port::WgmmaSS<BN>::template mma<1>(acc, port::wgmma_desc_sw128(a + kk * 32),
                                           port::wgmma_desc_sw128(b + kk * 2048, 8192));
      port::wgmma_commit();
      port::wgmma_wait<1>();  // the step before has read its stage
      fence_regs(acc);
      if (kt > 0 && lane == 0) port::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    port::wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) port::mbar_arrive(&empty[(it - 1) % STAGES]);

    // acc[4 j + 2 r + e] = row 16 (warp % 4) + lane / 4 + 8 r of the
    // warpgroup's 64, column 8 j + 2 (lane % 4) + e. The four lanes of a
    // row hold 32 consecutive columns in 4 j; a 4 x 4 transpose of column
    // pairs among them gives lane t the 8 consecutive columns 32 q + 8 t ..
    // + 7, which it stores at once.
    // Tile row i is pixel (f0 + i / (th Wo), oh0 + i / Wo % th, i % Wo):
    // output row m of the (M, Cout) result, or -1 past the map.
    const int t = lane & 3;
    int m_of[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * r;
      const int fi = i / (tl.th * g.Wo), rem = i - fi * tl.th * g.Wo;
      const int f = f0 + fi, oh = oh0 + rem / g.Wo, ow = rem % g.Wo;
      m_of[r] = (i < box_rows && f < g.F && oh < g.Ho) ? (f * g.Ho + oh) * g.Wo + ow : -1;
    }
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = make_float2(acc[4 * (4 * q + i) + 2 * r], acc[4 * (4 * q + i) + 2 * r + 1]);
        transpose_quad(v, t);
        if (m_of[r] >= 0) ep.store8(m_of[r], n0 + 32 * q + 8 * t, v);
      }
    }
  }
}

// Launches conv_wgmma_kernel<NWG, BN> on tiles of tf frames x th output
// rows: one block per SM, or one per tile where there are fewer tiles. The
// shared-memory attribute is set, and the SM count read, once on each
// device of the process.
template <int NWG, int BN>
int launch_wgmma(const void* x, const void* w, const Epilogue& ep, const Geometry& g, int tf,
                 int th, cudaStream_t stream) {
  using C = Cfg<NWG, BN>;
  if (tf < 1 || th < 1 || tf * th * g.Wo > C::BM || (tf > 1 && th != g.Ho) ||
      g.stride * g.Wo > 256 || g.stride * th > 256 || tf > 256) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  if (sms == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_wgmma_kernel<NWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    const cudaError_t e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e2 != cudaSuccess) return (int)e2;
  }
  CUtensorMap x_map, w_map;
  int rc = port::encode_conv_taps_sw128(&x_map, x, g.F, g.H, g.W, g.Cin, g.stride, g.Wo, th, tf);
  if (rc == 0) rc = port::encode_bf16_sw128(&w_map, w, g.kh * g.kw * g.Cin, g.Cout, g.Cout, 64, 64);
  if (rc != 0) return rc;
  Tiling tl;
  tl.tf = tf;
  tl.th = th;
  tl.h_tiles = (g.Ho + th - 1) / th;
  tl.m_tiles = (g.F + tf - 1) / tf * tl.h_tiles;
  tl.n_tiles = g.Cout / BN;
  const long long n_work = (long long)tl.m_tiles * tl.n_tiles;
  const int grid = (int)(n_work < sms ? n_work : sms);
  conv_wgmma_kernel<NWG, BN><<<grid, C::THREADS, C::SMEM, stream>>>(x_map, w_map, ep, g, tl);
  return (int)cudaGetLastError();
}

}  // namespace

// x (F, H, W, Cin) bf16, w (kh * kw * Cin, Cout) bf16 (HWIO flattened),
// scale, bias, prelu_a (Cout,) f32 or null when their flag is off,
// residual (F, Ho, Wo, Cout) bf16 or f32 (flag 8) or null, out (F, Ho, Wo,
// Cout) bf16 or f32 (flag 16). Flags: 1 affine, 2 act, 4 residual.
// Cin must be a multiple of 8, Cout a multiple of 8. The tile (bm, bn,
// tf, th) names the kernel: (0, 0, 0, 0) conv_kernel; (128 or 192, 64 or
// 128, frames, rows) conv_wgmma_kernel on tiles of tf frames x th output
// rows (tf * th * Wo <= bm; th == Ho when tf > 1), which needs Cin % 64
// == 0 and Cout % bn == 0.
extern "C" int conv_block_launch(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* prelu_a, const void* residual,
                                 void* out, int F, int H, int W, int Cin, int Cout, int kh,
                                 int kw, int stride, int pad, int flags, int bm, int bn, int tf,
                                 int th, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || Cin % 8 || Cout % 8) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{F, H, W, Cin, (H + 2 * pad - kh) / stride + 1, (W + 2 * pad - kw) / stride + 1,
             Cout, kh, kw, stride, pad};
  if (g.Ho <= 0 || g.Wo <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)F * g.Ho * g.Wo;
  if (M * Cout >= (1LL << 31) || (long long)F * H * W * Cin >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;  // the kernels index rows with int
  }
  if ((flags & 1) && (!scale || !bias)) return (int)cudaErrorInvalidValue;
  if ((flags & 2) && !prelu_a) return (int)cudaErrorInvalidValue;
  if ((flags & 4) && !residual) return (int)cudaErrorInvalidValue;
  const Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(prelu_a), residual, out, Cout, flags};
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bm != 0 || bn != 0) {
    if (Cin % 64 || Cout % bn) return (int)cudaErrorInvalidValue;
    if (bm == 128 && bn == 128) return launch_wgmma<2, 128>(x, w, ep, g, tf, th, st);
    if (bm == 128 && bn == 64) return launch_wgmma<2, 64>(x, w, ep, g, tf, th, st);
    if (bm == 192 && bn == 128) return launch_wgmma<3, 128>(x, w, ep, g, tf, th, st);
    if (bm == 192 && bn == 64) return launch_wgmma<3, 64>(x, w, ep, g, tf, th, st);
    return (int)cudaErrorInvalidValue;
  }
  // the shared-memory limit is raised once on each device of the process
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (Cout + BN - 1) / BN);
  conv_kernel<<<grid, THREADS, SMEM, st>>>(xb, static_cast<const __nv_bfloat16*>(w), ep, g);
  return (int)cudaGetLastError();
}
