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
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): operations.
// The trunk of 480 frames (22x22x64 after the stem) does ~274 GFLOP in its
// 19 convs, 0.28 ms at the peak, against ~0.1 GB of activations.
//
// Design: an implicit GEMM. Rows are output pixels, M = F * Ho * Wo (a
// tile spans frames, so layer4's 3x3 maps fill tiles too); columns are
// output channels, N = Cout; the depth is K = kh * kw * Cin in the order of
// the HWIO weight reshaped to (K, Cout), as the JAX wrapper's `w2d`. One
// block computes a 128 x 64 output tile with 4 warps of 64 x 32, walking K
// in 32-deep steps through a ring of 4 shared-memory stages filled with
// cp.async: each 16-byte copy brings 8 channels of one input pixel (Cin is
// a multiple of 8, so a copy never straddles two pixels or two taps) and
// is zero-filled, without a read, where the tap falls into the padding or
// the row lies past M. So stride 2 and pad 0 or 1 need no padded copy of
// x. The warps run bf16 mma.sync m16n8k16 with f32 accumulators and
// ldmatrix fragment loads; the epilogue applies the affine, the residual
// and PReLU in f32 and stores pairs of channels. wgmma, TMA and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

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

__global__ void __launch_bounds__(THREADS) conv_kernel(
    const __nv_bfloat16* __restrict__ x,   // (F, H, W, Cin)
    const __nv_bfloat16* __restrict__ w,   // (K, Cout)
    const float* __restrict__ scale,       // (Cout,) if affine
    const float* __restrict__ bias,        // (Cout,) if affine
    const float* __restrict__ prelu_a,     // (Cout,) if act
    const void* __restrict__ residual,     // (M, Cout) bf16 or f32 if residual
    void* __restrict__ out,                // (M, Cout) bf16 or f32
    const Geometry g, int flags) {
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

  // Epilogue in f32: affine, then the residual, then PReLU (the BasicBlock
  // order); Cout is even, so a lane's pair of channels is stored at once.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn * WN + nt * 8 + 2 * (lane & 3);
    if (col >= g.Cout) continue;
    float s0 = 1.f, s1 = 1.f, b0 = 0.f, b1 = 0.f, a0 = 0.f, a1 = 0.f;
    if (flags & kAffine) {
      s0 = scale[col];
      s1 = scale[col + 1];
      b0 = bias[col];
      b1 = bias[col + 1];
    }
    if (flags & kAct) {
      a0 = prelu_a[col];
      a1 = prelu_a[col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row_base + mt * 16 + (lane >> 2) + half * 8;
        if (row >= M) continue;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (flags & kAffine) {
          v0 = v0 * s0 + b0;
          v1 = v1 * s1 + b1;
        }
        const size_t off = (size_t)row * g.Cout + col;
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
          v0 = fmaxf(v0, 0.f) + a0 * fminf(v0, 0.f);
          v1 = fmaxf(v1, 0.f) + a1 * fminf(v1, 0.f);
        }
        if (flags & kOutF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + off) =
              port::pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

}  // namespace

// x (F, H, W, Cin) bf16, w (kh * kw * Cin, Cout) bf16 (HWIO flattened),
// scale, bias, prelu_a (Cout,) f32 or null when their flag is off,
// residual (F, Ho, Wo, Cout) bf16 or f32 (flag 8) or null, out (F, Ho, Wo,
// Cout) bf16 or f32 (flag 16). Flags: 1 affine, 2 act, 4 residual.
// Cin must be a multiple of 8, Cout a multiple of 8.
extern "C" int conv_block_launch(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* prelu_a, const void* residual,
                                 void* out, int F, int H, int W, int Cin, int Cout, int kh,
                                 int kw, int stride, int pad, int flags, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || Cin % 8 || Cout % 8) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{F, H, W, Cin, (H + 2 * pad - kh) / stride + 1, (W + 2 * pad - kw) / stride + 1,
             Cout, kh, kw, stride, pad};
  if (g.Ho <= 0 || g.Wo <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)F * g.Ho * g.Wo;
  if (M * Cout >= (1LL << 31) || (long long)F * H * W * Cin >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;  // the kernel indexes rows with int
  }
  if ((flags & 1) && (!scale || !bias)) return (int)cudaErrorInvalidValue;
  if ((flags & 2) && !prelu_a) return (int)cudaErrorInvalidValue;
  if ((flags & 4) && !residual) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // set once, on the first launch's device: one device per process
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (Cout + BN - 1) / BN);
  conv_kernel<<<grid, THREADS, SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(prelu_a), residual, out, g, flags);
  return (int)cudaGetLastError();
}
