// One-pass row statistics for exact beam-candidate selection on Hopper
// (sm_90a): for each row of x (R, V) f32, V % 128 == 0,
//   cm[r, c] = max of x[r, 128c : 128c + 128],
//   mx[r]    = max of the row,
//   se[r]    = sum over the row of exp(x - mx[r]).
//
// Replaces B5, `omni_avsr_tpu/ops/select_topk.py::_kernel` (wrapper
// `row_stats_chunkmax`), which holds an (8, V) row block in VMEM and
// reduces it in one grid step.
//
// Bound on the H100 SXM (3.35 TB/s): memory. At the beam-15 serving shape
// (R = 3 x 15 = 45, V = 128256) the kernel reads 23.1 MB and writes 0.18 MB,
// 6.9 us at the HBM rate; the arithmetic (one expf per element) is far
// below the card's rate.
//
// Design: a row of 501 KB does not fit in shared memory, and 45 rows are
// too few for 132 SMs, so each row is split over `parts` blocks (the
// wrapper picks about four blocks per SM). A block walks its range of
// chunks with one warp per chunk: each lane loads one float4 (a warp
// reads the 512 bytes of a chunk in one coalesced load, four chunks in
// flight per warp), the warp's shuffle max gives the chunk max, which lane 0
// stores. The sum is kept online against a running max that is the same
// for every lane of the warp (the max of the chunks seen so far), so one
// read of the row serves both statistics: when a chunk raises the max, the
// lane's sum is rescaled by exp(old - new). The warps' (max, sum) pairs
// combine in shared memory into the block's partial pair, and a second
// kernel, one warp per row, combines a row's partials: the max of the
// maxima (exact), and the sum of each partial sum times exp(its max - row
// max). expf, not __expf: the sum differs from the plain version only by
// summation order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One (part, row) per block: chunk maxima of chunks [c0, c1) and the
// partial (max, sum) of those chunks.
__global__ void __launch_bounds__(32 * kWarps) row_stats_partial(
    const float* __restrict__ x, float* __restrict__ cm, float* __restrict__ pmax,
    float* __restrict__ psum, int V, int per_part) {
  const int r = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = V / kChunk;
  const int c0 = part * per_part;
  const int c1 = min(C, c0 + per_part);
  const float4* row = reinterpret_cast<const float4*>(x + (size_t)r * V);
  float* cm_row = cm + (size_t)r * C;

  float m = -INFINITY, s = 0.f;  // the warp's running max (warp-uniform) and the lane's sum
  for (int c = c0 + warp; c < c1; c += kWarps * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cc = c + u * kWarps;
      v[u] = cc < c1 ? __ldg(row + (size_t)cc * (kChunk / 4) + lane)
                     : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cc = c + u * kWarps;
      if (cc >= c1) break;  // warp-uniform
      const float cmax = warp_max(fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
      if (lane == 0) cm_row[cc] = cmax;
      if (cmax > m) {  // warp-uniform
        s *= expf(m - cmax);  // exp(-inf) = 0 on the first chunk
        m = cmax;
      }
      s += expf(v[u].x - m) + expf(v[u].y - m) + expf(v[u].z - m) + expf(v[u].w - m);
    }
  }
  s = warp_sum(s);

  __shared__ float sm[kWarps], ss[kWarps];
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, sm[w]);
    float bs = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (sm[w] != -INFINITY) bs += ss[w] * expf(sm[w] - bm);  // a warp without chunks adds 0
    }
    pmax[(size_t)r * parts + part] = bm;
    psum[(size_t)r * parts + part] = bs;
  }
}

// One warp per row: the row's max and normaliser from its partials.
__global__ void row_stats_combine(const float* __restrict__ pmax, const float* __restrict__ psum,
                                  float* __restrict__ mx, float* __restrict__ se, int R,
                                  int parts) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const float* pm = pmax + (size_t)r * parts;
  const float* ps = psum + (size_t)r * parts;
  float m = -INFINITY;
  for (int j = lane; j < parts; j += 32) m = fmaxf(m, pm[j]);
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < parts; j += 32) {
    if (pm[j] != -INFINITY) s += ps[j] * expf(pm[j] - m);
  }
  s = warp_sum(s);
  if (lane == 0) {
    mx[r] = m;
    se[r] = s;
  }
}

}  // namespace

// x (R, V) f32 with V % 128 == 0 -> cm (R, V/128), mx (R,), se (R,) f32.
// pmax and psum hold R * parts floats each; every part of a row must hold
// at least one chunk (parts = ceil(C / ceil(C / parts))).
extern "C" int row_stats_launch(const void* x, void* cm, void* mx, void* se, void* pmax,
                                void* psum, int R, int V, int parts, void* stream) {
  if (R <= 0 || V <= 0 || V % kChunk || parts < 1) return (int)cudaErrorInvalidValue;
  const int C = V / kChunk;
  const int per_part = (C + parts - 1) / parts;
  if ((C + per_part - 1) / per_part != parts || R > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  row_stats_partial<<<dim3(parts, R), 32 * kWarps, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(cm), static_cast<float*>(pmax),
      static_cast<float*>(psum), V, per_part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int kRowsPerBlock = 8;
  row_stats_combine<<<(R + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const float*>(pmax), static_cast<const float*>(psum), static_cast<float*>(mx),
      static_cast<float*>(se), R, parts);
  return (int)cudaGetLastError();
}
