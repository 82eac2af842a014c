// Balanced top-1 routing of the MoE decoder on Hopper (sm_90a), in one
// launch: the greedy of `omni_avsr_tpu/models/moe.py::_topk_balanced_assignment`.
// For router scores s (N, E) f32 and the tokens' visiting order (the
// stable descending sort of each token's best score, made by the wrapper),
// token order[i], for i = 0, 1, ..., N - 1 in turn, takes the first
// expert of the highest score among the experts whose load is below
// `capacity`, and that expert's load grows by one; a token that finds
// every expert full gets -1.
//
// Replaces no TPU kernel: the JAX package runs this greedy as a
// `lax.scan` over the tokens inside its jitted decoder. Eager PyTorch
// would take several launches per token, per layer and per call; this
// kernel is the scan in one launch (`ops/moe_route.py::balanced_assignment`).
//
// Bound on the H100 SXM: neither bytes nor operations. One pass over the
// scores (N * E * 4 bytes) and one write of the assignments (N * 4) is
// microseconds at 3.35 TB/s, but each token's choice depends on the loads
// the tokens before it left, so the scan is a chain of N dependent steps:
// latency.
//
// Design: one block of kThreads threads. The scores are staged into shared
// memory in the visiting order, `rows` tokens at a time, with each staged
// token's index beside them, double-buffered: warps 1..7 gather the next
// chunk while warp 0 scans the current one, so the scan reads nothing
// from global memory and its only global access is the store of each
// assignment. Warp 0 holds the experts across its lanes (lane l owns
// experts l, l + 32, ..., EPL of them) and each owner keeps its experts'
// loads in registers. A token's masked argmax is a lane-local pass, then
// two warp reductions: the largest score (as an order-preserving unsigned
// key, -0.0 taken as +0.0) and the lowest expert holding it, which is
// jnp.argmax's first index. Full experts drop out, and a token whose best
// is -inf (every expert full) gets -1. The assignments are integers,
// bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageFloats = 4096;  // floats per staging buffer (16 KB)
constexpr int kStageRows = 1024;    // tokens per staging buffer, at most
constexpr int kMaxExperts = 1024;   // 32 lanes x 32 registers of loads
constexpr unsigned kNegInfKey = 0x007fffffu;  // key(-inf); key 0 marks no candidate

// Order-preserving map of a non-NaN float to an unsigned key.
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int EPL>
__global__ void __launch_bounds__(kThreads)
balanced_route_kernel(const float* __restrict__ scores, const int64_t* __restrict__ order,
                      int32_t* __restrict__ assign, int N, int E, int capacity, int rows) {
  __shared__ float stage[2][kStageFloats];
  __shared__ int token[2][kStageRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto gather = [&](int buf, int first, int begin, int stride) {
    const int n = min(rows, N - first);
#pragma unroll 4
    for (int idx = begin; idx < n * E; idx += stride) {
      const int j = idx / E, e = idx - j * E;
      const int64_t tok = order[first + j];
      stage[buf][idx] = scores[tok * E + e];
      if (e == 0) token[buf][j] = (int)tok;
    }
  };
  gather(0, 0, tid, kThreads);
  __syncthreads();

  int load[EPL];
#pragma unroll
  for (int k = 0; k < EPL; ++k) load[k] = 0;

  for (int first = 0, buf = 0; first < N; first += rows, buf ^= 1) {
    if (warp != 0) {
      if (first + rows < N) gather(buf ^ 1, first + rows, tid - 32, kThreads - 32);
    } else {
      const int n = min(rows, N - first);
      const float* s = stage[buf];
      for (int j = 0; j < n; ++j) {
        unsigned best = 0u;
        int at = 0x7fffffff;
#pragma unroll
        for (int k = 0; k < EPL; ++k) {  // ascending experts: ">" keeps the first
          const int e = lane + 32 * k;
          if (e < E && load[k] < capacity) {
            const unsigned key = score_key(s[j * E + e]);
            if (key > best) { best = key; at = e; }
          }
        }
        const unsigned top = __reduce_max_sync(0xffffffffu, best);
        const int pick = (int)__reduce_min_sync(0xffffffffu, best == top ? (unsigned)at
                                                                        : 0xffffffffu);
        const bool ok = top > kNegInfKey;
        if (ok) {
#pragma unroll
          for (int k = 0; k < EPL; ++k) load[k] += (lane + 32 * k == pick);
        }
        if (lane == 0) assign[token[buf][j]] = ok ? pick : -1;
      }
    }
    __syncthreads();
  }
}

template <int EPL>
void launch(const void* scores, const void* order, void* assign, int N, int E, int capacity,
            int rows, cudaStream_t st) {
  balanced_route_kernel<EPL><<<1, kThreads, 0, st>>>(
      static_cast<const float*>(scores), static_cast<const int64_t*>(order),
      static_cast<int32_t*>(assign), N, E, capacity, rows);
}

}  // namespace

// scores (N, E) f32, order (N,) int64 (a permutation of 0..N-1), assign
// (N,) int32 out; all on the device, contiguous. Returns the CUDA error of
// the launch (0 on success).
extern "C" int balanced_route_launch(const void* scores, const void* order, void* assign, int N,
                                     int E, int capacity, void* stream) {
  if (N <= 0 || E <= 0 || E > kMaxExperts || capacity < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = min(kStageFloats / E, kStageRows);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int per_lane = (E + 31) / 32;
  if (per_lane <= 1) launch<1>(scores, order, assign, N, E, capacity, rows, st);
  else if (per_lane <= 2) launch<2>(scores, order, assign, N, E, capacity, rows, st);
  else if (per_lane <= 4) launch<4>(scores, order, assign, N, E, capacity, rows, st);
  else if (per_lane <= 8) launch<8>(scores, order, assign, N, E, capacity, rows, st);
  else if (per_lane <= 16) launch<16>(scores, order, assign, N, E, capacity, rows, st);
  else launch<32>(scores, order, assign, N, E, capacity, rows, st);
  return (int)cudaGetLastError();
}
