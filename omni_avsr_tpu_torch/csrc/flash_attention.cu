// Flash attention forward for Hopper (sm_90a): softmax(q k^T * scale) v
// with an online softmax, never writing the (T x S) logits to memory.
// Bidirectional or causal, per-batch key lengths, GQA, head dim 64 or 128,
// optional row logsumexp, optional attention-probability dropout; bf16 in
// and out, f32 logits, softmax and accumulator.
//
// Replaces the TPU kernel `omni_avsr_tpu/ops/flash_attention.py::_kernel`
// (B3) and keeps its semantics:
//   - masked logits are -1e30 (finite), the running max starts there, and
//     the result is acc / max(l, 1e-30) with lse = m + log(max(l, 1e-30));
//   - dropout zeroes probabilities after the softmax denominator l has
//     been accumulated (torch's dropout(softmax(s)) @ v), scales the kept
//     ones by 1 / (1 - rate) and rounds them to bf16 for the value product;
//   - the keep mask is the TPU kernel's `_keep_mask`, in keep_mask.cuh,
//     which the backward (flash_attention_bwd.cu) includes too.
//
// Design: one block of 4 warps per (64-query tile, batch * q-head); each
// warp owns 16 query rows and keeps their q fragments in registers. The
// block walks 64-key tiles of its kv head (GQA: q-head h reads kv-head
// h / G), double-buffered in shared memory with cp.async, so the next
// tile's K and V load while the current one is computed. Scores and the
// value product are bf16 mma.sync (m16n8k16, f32 accumulate); the
// probabilities go from the score accumulators straight into the A
// fragments of the value product (the layouts coincide). The key loop
// ends at the key length and, when causal, at the tile's last query, so
// fully masked tiles are skipped. Rows of a query without any valid key
// (length 0) come out as 0; the TPU kernel gives them a tiling-dependent
// average there.
//
// Bound on the H100 SXM: at Whisper's 30 s window (B 3, 16 heads,
// T = S = 1500, D 64) one launch does 4 * B * H * T * S * D = 27.6 GFLOP
// (28 us at 989 TFLOP/s) and moves 36.9 MB of q, k, v and out (11 us at
// 3.35 TB/s): compute-bound. mma.sync from ldmatrix fragments reaches a
// fraction of the wgmma peak; a wgmma/TMA pipeline with a larger query
// tile per block is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block (4 warps x 16)
constexpr int BKV = 64;   // keys per tile
constexpr int THREADS = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, T, Hq, D)
    const __nv_bfloat16* __restrict__ k,  // (B, S, Hkv, D)
    const __nv_bfloat16* __restrict__ v,  // (B, S, Hkv, D)
    __nv_bfloat16* __restrict__ out,      // (B, T, Hq, D)
    float* __restrict__ lse,              // (B * Hq, T) or null
    const int32_t* __restrict__ kv_lens,  // (B,) or null
    int T, int S, int Hq, int Hkv, float scale, int causal, int dropout, uint32_t seed,
    int32_t thresh, float keep_scale) {
  constexpr int LD = D + 8;  // padded smem row (bf16): conflict-free ldmatrix
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;  // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;       // 2 stages
  __nv_bfloat16* sV = sK + 2 * BKV * LD;  // 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hkv = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;

  int kv_limit = S;
  if (kv_lens != nullptr) kv_limit = min(S, max(0, kv_lens[b]));
  int n_tiles = (kv_limit + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, T) - 1) / BKV + 1);  // keys <= last query

  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + ((size_t)b * T * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + hkv) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + hkv) * D;
  constexpr int ROW_CHUNKS = D / 8;  // 16-byte chunks per row

  for (int i = tid; i < BQ * ROW_CHUNKS; i += THREADS) {
    const int r = i / ROW_CHUNKS, c = (i % ROW_CHUNKS) * 8;
    const bool ok = q0 + r < T;
    port::cp_async16(sQ + r * LD + c, ok ? qb + (size_t)(q0 + r) * q_stride + c : q, ok);
  }
  auto load_kv = [&](int stage, int tile) {
    const int j0 = tile * BKV;
    for (int i = tid; i < BKV * ROW_CHUNKS; i += THREADS) {
      const int r = i / ROW_CHUNKS, c = (i % ROW_CHUNKS) * 8;
      const bool ok = j0 + r < S;
      const size_t off = (size_t)(j0 + r) * kv_stride + c;
      port::cp_async16(sK + (stage * BKV + r) * LD + c, ok ? kb + off : k, ok);
      port::cp_async16(sV + (stage * BKV + r) * LD + c, ok ? vb + off : v, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  port::cp_async_commit();

  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t qf[KSTEPS][4];
  const uint32_t h_mix = (uint32_t)bh * 0x9E3779B9u;

  for (int t = 0; t < n_tiles; ++t) {
    port::cp_async_wait<0>();
    __syncthreads();  // tile t (and at t = 0 the q tile) landed; tile t-1 is consumed
    if (t + 1 < n_tiles) load_kv((t + 1) & 1, t + 1);
    port::cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        port::ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* tK = sK + (t & 1) * BKV * LD;
    const __nv_bfloat16* tV = sV + (t & 1) * BKV * LD;
    const int j0 = t * BKV;

    float s[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t r[4];
        const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int d = kk * 16 + ((lane >> 3) & 1) * 8;
        port::ldmatrix_x4(r, tK + key * LD + d);
        port::mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        port::mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale, mask, online softmax over this tile
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float val = s[n][e] * scale;
        if (key >= kv_limit || (causal && key > row)) val = kNegInf;
        s[n][e] = val;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_r[i], tmax[i]);
      corr[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        float pv = p;
        if (dropout) {
          const int key = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          pv = port::keep_elem((uint32_t)row, (uint32_t)key, (uint32_t)S, h_mix, seed, thresh)
                   ? p * keep_scale
                   : 0.f;
        }
        s[n][e] = pv;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // acc += p @ v: the score accumulators of key tiles 2c, 2c+1 are the
    // A fragment of the c-th 16-key step
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      uint32_t a[4];
      a[0] = port::pack_bf16x2(s[2 * c][0], s[2 * c][1]);
      a[1] = port::pack_bf16x2(s[2 * c][2], s[2 * c][3]);
      a[2] = port::pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]);
      a[3] = port::pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t r[4];
        const int krow = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int dcol = dp * 16 + (lane >> 4) * 8;
        port::ldmatrix_x4_trans(r, tV + krow * LD + dcol);
        port::mma_bf16(acc[2 * dp], a, r[0], r[1]);
        port::mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }
  port::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= T) continue;
    const float inv = 1.f / l_r[i];
    __nv_bfloat16* orow = out + ((size_t)b * T + row) * q_stride + (size_t)h * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(orow + d) =
          port::pack_bf16x2(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    }
    if (lse != nullptr && (lane & 3) == 0) lse[(size_t)bh * T + row] = m_r[i] + logf(l_r[i]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* kv_lens, int B, int T, int S, int Hq, int Hkv, float scale, int causal,
           int dropout, int seed, int thresh, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(BQ + 4 * BKV) * (D + 8) * 2;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((T + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int32_t*>(kv_lens), T, S, Hq, Hkv, scale,
      causal, dropout, (uint32_t)seed, (int32_t)thresh, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, Hq, D), k and v (B, S, Hkv, D) bf16 contiguous -> out like q;
// lse (B * Hq, T) f32 when not null; kv_lens (B,) int32 when not null.
// dropout != 0 applies the keep mask (seed, thresh) and scales kept
// probabilities by keep_scale = 1 / (1 - rate).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const void* kv_lens, int B, int T, int S,
                                      int Hq, int Hkv, int D, float scale, int causal,
                                      int dropout, int seed, int thresh, float keep_scale,
                                      void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch<64>(q, k, v, out, lse, kv_lens, B, T, S, Hq, Hkv, scale, causal, dropout,
                      seed, thresh, keep_scale, st);
  }
  if (D == 128) {
    return launch<128>(q, k, v, out, lse, kv_lens, B, T, S, Hq, Hkv, scale, causal, dropout,
                       seed, thresh, keep_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
