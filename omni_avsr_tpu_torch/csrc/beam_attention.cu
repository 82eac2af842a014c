// Beam-decode attention over a shared prefix, an UNPERMUTED generated-token
// cache plus an ancestor table, and the current token: one step, all kv
// heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel `omni_avsr_tpu/ops/beam_attention.py::_kernel`
// (Pallas). It computes the same function, not the same blocks: for query
// beam k, the generated cache entry (row r, slot n) is live iff
// anc[b, k, n] == r and n < step, so the live generated keys of beam k are
// exactly one per slot n < step, at row anc[b, k, n]. This kernel gathers
// that chain directly instead of forming the (K*G, K*N) cross product and
// masking it, which is exact by the same argument the TPU kernel's note
// gives (masked entries contribute exp(-inf) = 0 to the joint softmax).
//
// Design: one block per (batch item * beam, kv head), one warp per q-head
// of the GQA group (G warps). Each warp keeps its q row in registers (all
// lanes hold the full row), walks the P + step + 1 keys in chunks of 32
// (lane l scores key 32c + l), and keeps an online softmax in f32; the
// value contraction gives each lane D/32 output dims and reads each value
// row coalesced, all 32 rows of a chunk in flight at once. bf16 in and
// out, f32 logits, softmax and accumulator.
//
// Bound: at the serving shapes (K 15, N 32, Hq 32, Hkv 8, D 64, P 176) one
// launch reads about 1.35 MB of K/V at most (0.4 us at 3.35 TB/s) and does
// a few MFLOP, so it is memory- and launch-bound; the grid of B*K*Hkv = 120
// blocks per batch item spreads the reads over the SMs. Staging the shared
// prefix in shared memory with TMA and scoring it with wgmma across the
// K*G rows that share it is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedLogit = -1e30f;  // the TPU kernel's NEG_INF

template <int D>
__global__ void beam_attention_kernel(
    const __nv_bfloat16* __restrict__ q,      // (B*K, Hq, D)
    const __nv_bfloat16* __restrict__ pk,     // (B, Hkv, P, D)
    const __nv_bfloat16* __restrict__ pv,     // (B, Hkv, P, D)
    const __nv_bfloat16* __restrict__ gk,     // (B, Hkv, K, N, D)
    const __nv_bfloat16* __restrict__ gv,     // (B, Hkv, K, N, D)
    const __nv_bfloat16* __restrict__ kc,     // (B*K, Hkv, D)
    const __nv_bfloat16* __restrict__ vc,     // (B*K, Hkv, D)
    const float* __restrict__ prefix_bias,    // (B, P)
    const int32_t* __restrict__ anc,          // (B, K, N)
    __nv_bfloat16* __restrict__ out,          // (B*K, Hq, D)
    int K, int G, int Hkv, int P, int N, int step, float scale) {
  constexpr int DPL = D / 32;  // output dims per lane
  const int bk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = bk / K;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Hq = Hkv * G;
  const size_t q_row = ((size_t)bk * Hq + (size_t)h * G + g) * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; d += 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(q + q_row + d);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p2[i]);
      qr[d + 2 * i] = f.x;
      qr[d + 2 * i + 1] = f.y;
    }
  }

  const size_t bh = (size_t)b * Hkv + h;
  const __nv_bfloat16* pk_bh = pk + bh * P * D;
  const __nv_bfloat16* pv_bh = pv + bh * P * D;
  const __nv_bfloat16* gk_bh = gk + bh * K * N * D;
  const __nv_bfloat16* gv_bh = gv + bh * K * N * D;
  const size_t cur = ((size_t)bk * Hkv + h) * D;
  const float* bias_b = prefix_bias + (size_t)b * P;
  const int32_t* anc_bk = anc + (size_t)bk * N;
  const int T = P + step + 1;

  float m = -INFINITY;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int base = 0; base < T; base += 32) {
    const int j = base + lane;
    // Key j of this beam: prefix slot j, generated slot j - P of the
    // ancestor chain, or the current token. `src` names the value source
    // and `off` the row's element offset inside it.
    int src = 0;
    long long off = 0;
    float s = -INFINITY;  // lanes past the last key
    const __nv_bfloat16* krow = nullptr;
    float bias = 0.f;
    if (j < P) {
      off = (long long)j * D;
      krow = pk_bh + off;
      bias = bias_b[j];
    } else if (j < P + step) {
      src = 1;
      const int n = j - P;
      const int r = anc_bk[n];
      if (r >= 0 && r < K) {
        off = ((long long)r * N + n) * D;
        krow = gk_bh + off;
      } else {
        s = kMaskedLogit;  // no live row at this slot
      }
    } else if (j < T) {
      src = 2;
      krow = kc + cur;
    }
    // Value rows of this chunk, loaded before the scores are computed so
    // the K and V reads are in flight together. Each lane's row address is
    // shared by shuffle, and all 32 rows are requested before any is used
    // (lanes past the last key carry p = 0 and a valid row address).
    const __nv_bfloat16* vrow = (src == 0 ? pv_bh : (src == 1 ? gv_bh : vc + cur)) + off;
    const unsigned long long vaddr = reinterpret_cast<unsigned long long>(vrow);
    __nv_bfloat162 vv[32][DPL / 2];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(
          __shfl_sync(0xffffffffu, vaddr, jj)) + lane * (DPL / 2);
#pragma unroll
      for (int i = 0; i < DPL / 2; ++i) vv[jj][i] = row[i];
    }
    if (krow != nullptr) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 8) {
        uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(p2[i]);
          dot = fmaf(qr[d + 2 * i], f.x, dot);
          dot = fmaf(qr[d + 2 * i + 1], f.y, dot);
        }
      }
      s = dot * scale + bias;
    }
    float cmax = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    const float m_new = fmaxf(m, cmax);  // finite: lane 0 always holds a key
    const float corr = __expf(m - m_new);
    const float p = (j < T) ? __expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;

#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
      for (int i = 0; i < DPL / 2; ++i) {
        const float2 f = __bfloat1622float2(vv[jj][i]);
        acc[2 * i] = fmaf(pj, f.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(pj, f.y, acc[2 * i + 1]);
      }
    }
  }

  const float inv = 1.f / l;
  __nv_bfloat16* orow = out + q_row + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) orow[i] = __float2bfloat16(acc[i] * inv);
}

}  // namespace

extern "C" int beam_attention_launch(
    const void* q, const void* pk, const void* pv, const void* gk,
    const void* gv, const void* kc, const void* vc, const void* prefix_bias,
    const void* anc, void* out, int B, int K, int G, int Hkv, int P, int N,
    int D, int step, float scale, void* stream) {
  const dim3 grid(B * K, Hkv);
  const dim3 block(32 * G);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define BEAM_ATTN_ARGS                                                       \
  reinterpret_cast<const __nv_bfloat16*>(q),                                 \
      reinterpret_cast<const __nv_bfloat16*>(pk),                            \
      reinterpret_cast<const __nv_bfloat16*>(pv),                            \
      reinterpret_cast<const __nv_bfloat16*>(gk),                            \
      reinterpret_cast<const __nv_bfloat16*>(gv),                            \
      reinterpret_cast<const __nv_bfloat16*>(kc),                            \
      reinterpret_cast<const __nv_bfloat16*>(vc),                            \
      reinterpret_cast<const float*>(prefix_bias),                           \
      reinterpret_cast<const int32_t*>(anc),                                 \
      reinterpret_cast<__nv_bfloat16*>(out), K, G, Hkv, P, N, step, scale
  if (D == 64) {
    beam_attention_kernel<64><<<grid, block, 0, s>>>(BEAM_ATTN_ARGS);
  } else if (D == 128) {
    beam_attention_kernel<128><<<grid, block, 0, s>>>(BEAM_ATTN_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef BEAM_ATTN_ARGS
  return (int)cudaGetLastError();
}
