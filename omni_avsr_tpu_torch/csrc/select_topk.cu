// One-pass row statistics for exact beam-candidate selection on Hopper
// (sm_90a), in one launch: for each row of x (R, V) f32, V % 128 == 0,
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
// 6.9 us at the HBM rate; the card must keep about 20 KB in flight per SM
// to reach it, and the arithmetic (one ex2 per element) is far below the
// card's rate.
//
// Design: a row of 501 KB is read once, and 45 rows are too few for 132
// SMs, so each row is split over `parts` blocks of `per` chunks of 128
// (`ops/select_topk.py::row_plan`: four blocks of 256 threads per SM over
// all rows, each block at least 8 chunks; one block per row from R 265
// up). Each warp walks its block's chunks in groups of 4 (chunks g + w, g +
// w + 8, ...), one float4 a lane per chunk, double-buffered in registers:
// a group's four 16-byte loads per lane are issued before the group before
// it is reduced, so 8 loads a lane, 32 KB a block and 128 KB an SM are in
// flight, and the loads are `ld.global.cs` (evict first: the row is read
// once, so it does not push other lines out of L2, and on a cold L2 the
// lines it evicts are mostly its own, clean ones). Per chunk the warp's
// shuffle max gives the chunk max (lane 0 stores it); the warp's running
// max is raised once per group, and each element adds ex2((x - m) *
// log2 e). The 8 warps' (max, sum) pairs merge into the block's; a row of
// one block stores them, else each block leaves its pair in `partial` and
// takes a ticket of its row (an acquire-release atomic add); the
// row's last block merges the row's pairs in the order of the parts,
// stores the statistics and sets the ticket back to 0 for the next launch.
// One launch; `partial` and `ticket` are a buffer the wrapper makes once
// per device and stream. (Bulk copies into a shared-memory ring, the whole
// range in flight, measured no faster at R 45 and slower at R 480, where a
// block's ring refills in turn; a thread-block cluster's combine would
// leave R 8 and 13 on under half the SMs.)
//
// Precision: the maxima are exact (bit-equal to the plain version). The
// normaliser differs from a full-precision sum by the order of the sums
// and by ex2.approx.ftz (about 2 ulp, 1.2e-7 relative, per element); x - m
// is exact where x is within a factor 2 of m and else rounds by |x - m| *
// 6e-8, which moves exp(x - m) by at most that relative amount, so the
// terms that matter (x near m) are exact to about 2 ulp and the sum stays
// well inside rtol 1e-5 for any logit scale. ftz flushes terms below
// 2^-126 of the max's, which change the sum (at least 1) by less than 1e-37.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // floats per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;                   // chunks per warp per group of loads
constexpr int kGroupChunks = kWarps * kGroup;  // per block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// (m, s) := the merge of (m, s) and (pm, ps), two (max, sum of exp(x -
// max)) pairs; a pair of no elements has max -inf.
__device__ __forceinline__ void merge(float& m, float& s, float pm, float ps) {
  const float n = fmaxf(m, pm);
  if (n == -INFINITY) return;
  s = s * ex2((m - n) * kLog2e) + ps * ex2((pm - n) * kLog2e);
  m = n;
}

// One warp's walk over its block's chunks: chunk c of group g is
// g + u * kWarps + warp for u < kGroup; n chunks in the block's range.
struct Walk {
  const float4* row4;  // the range's first chunk
  float* cm;           // its chunk maxima
  int n, warp, lane;
  float m = -INFINITY, s = 0.f;  // the warp's running max (warp-uniform), the lane's sum

  __device__ __forceinline__ void load(float4 (&v)[kGroup], int g) const {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = g + u * kWarps + warp;
      v[u] = c < n ? __ldcs(row4 + (size_t)c * (kChunk / 4) + lane)
                   : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  }

  __device__ __forceinline__ void reduce(const float4 (&v)[kGroup], int g) {
    float gm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = g + u * kWarps + warp;
      const float cmax = warp_max(fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
      if (lane == 0 && c < n) cm[c] = cmax;
      gm = fmaxf(gm, cmax);
    }
    if (gm > m) {  // warp-uniform, and rare once the row's large values are seen
      s *= ex2((m - gm) * kLog2e);  // 0 on the first group (m = -inf)
      m = gm;
    }
    if (m == -INFINITY) return;  // every element so far is -inf and adds 0
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      s += ex2((v[u].x - m) * kLog2e) + ex2((v[u].y - m) * kLog2e) +
           ex2((v[u].z - m) * kLog2e) + ex2((v[u].w - m) * kLog2e);
  }
};

// One (part, row) per block: chunks [part * per, part * per + per) of row r.
__global__ void __launch_bounds__(kThreads, 4) row_stats_kernel(
    const float* __restrict__ x, float* __restrict__ cm, float* __restrict__ mx,
    float* __restrict__ se, float2* __restrict__ partial, unsigned* __restrict__ ticket, int V,
    int per) {
  __shared__ float wm[kWarps], ws[kWarps];
  const int r = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = V / kChunk;
  const int c0 = part * per;
  Walk w{reinterpret_cast<const float4*>(x + (size_t)r * V + (size_t)c0 * kChunk),
         cm + (size_t)r * C + c0, min(C, c0 + per) - c0, warp, lane};

  // two groups in flight: the next group's loads go out before this one
  // is reduced
  float4 va[kGroup], vb[kGroup];
  w.load(va, 0);
  for (int g = 0; g < w.n; g += 2 * kGroupChunks) {
    if (g + kGroupChunks < w.n) w.load(vb, g + kGroupChunks);
    w.reduce(va, g);
    if (g + kGroupChunks >= w.n) break;
    if (g + 2 * kGroupChunks < w.n) w.load(va, g + 2 * kGroupChunks);
    w.reduce(vb, g + kGroupChunks);
  }

  const float s = warp_sum(w.s);
  if (lane == 0) {
    wm[warp] = w.m;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp != 0) return;
  // warp 0: the block's pair, then the row's
  const float bm = lane < kWarps ? wm[lane] : -INFINITY;
  const float bs = lane < kWarps ? ws[lane] : 0.f;
  const float block_m = warp_max(bm);
  const float block_s = warp_sum(bm == -INFINITY ? 0.f : bs * ex2((bm - block_m) * kLog2e));
  if (parts == 1) {
    if (lane == 0) {
      mx[r] = block_m;
      se[r] = block_s;
    }
    return;
  }
  float2* row_partial = partial + (size_t)r * parts;
  unsigned t = 0;
  if (lane == 0) {
    row_partial[part] = make_float2(block_m, block_s);
    // the ticket releases this block's pair and acquires every pair
    // released before it
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(ticket + r)
                 : "memory");
  }
  t = __shfl_sync(0xffffffffu, t, 0);
  if (t != (unsigned)parts - 1) return;
  __syncwarp();  // the lanes' loads below come after lane 0's acquire
  // the row's last block: every part's pair is in L2; merge them in order
  float pm = -INFINITY, ps = 0.f;
  for (int j = lane; j < parts; j += 32) {
    const float2 p = __ldcg(row_partial + j);
    merge(pm, ps, p.x, p.y);
  }
  const float row_m = warp_max(pm);
  const float row_s = warp_sum(pm == -INFINITY ? 0.f : ps * ex2((pm - row_m) * kLog2e));
  if (lane == 0) {
    mx[r] = row_m;
    se[r] = row_s;
    ticket[r] = 0;  // for the next launch
  }
}

}  // namespace

// x (R, V) f32 with V % 128 == 0 -> cm (R, V/128), mx (R,), se (R,) f32,
// in one launch of `parts` blocks per row, `per` chunks each (every part
// holds at least one chunk: parts = ceil(C / per)). When parts > 1,
// `partial` holds R * parts float2 and `ticket` R zeros, which the kernel
// leaves at zero; `capacity` is the number of float2 in `partial` and of
// unsigned ints in `ticket`.
extern "C" int row_stats_launch(const void* x, void* cm, void* mx, void* se, void* partial,
                                void* ticket, int capacity, int R, int V, int parts, int per,
                                void* stream) {
  if (R <= 0 || R > 65535 || V <= 0 || V % kChunk || parts < 1 || per < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int C = V / kChunk;
  if ((C + per - 1) / per != parts) return (int)cudaErrorInvalidValue;
  if (parts > 1 && (long long)R * parts > capacity) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  row_stats_kernel<<<dim3(parts, R), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(cm), static_cast<float*>(mx),
      static_cast<float*>(se), static_cast<float2*>(partial), static_cast<unsigned*>(ticket), V,
      per);
  return (int)cudaGetLastError();
}
