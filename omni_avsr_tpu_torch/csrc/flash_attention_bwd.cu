// Flash attention backward for Hopper (sm_90a): the gradients of
// softmax(q k^T * scale) v from the forward's row logsumexp, never writing
// the (T x S) probabilities to memory. Bidirectional or causal, per-batch
// key lengths, GQA, head dim 64 or 128, the forward's attention-probability
// dropout; bf16 q, k, v, out and d_out, f32 lse and logits, f32
// accumulators.
//
// Replaces the TPU kernels `omni_avsr_tpu/ops/flash_attention_bwd.py::
// _dq_kernel` and `::_dkv_kernel` (B4) and keeps their math:
//   p  = exp(q k^T * scale - lse), 0 where masked;
//   dv = p_drop^T d_out, with p_drop = keep ? p / (1 - rate) : 0;
//   dp = (d_out v^T) * keep / (1 - rate);
//   ds = p * (dp - dsum) * scale, dsum = rowsum(d_out * out) (the wrapper);
//   dq = ds k, dk = ds^T q.
// p_drop and ds are rounded to bf16 for their products, as the TPU kernels
// round them to the input dtype. The keep mask is the forward's
// (keep_mask.cuh), so both directions drop the same probabilities.
//
// Design: two kernels of 4 warps, launched one after the other.
//   - dq: one block per (64-query tile, batch * q-head); each warp owns 16
//     query rows and keeps their q and d_out fragments in registers. The
//     block walks 64-key tiles of its kv head, K and V double-buffered in
//     shared memory with cp.async; S = q k^T and dP = d_out v^T are bf16
//     mma.sync with f32 accumulators, dS goes from those accumulators
//     straight into the A fragments of dS k.
//   - dk/dv: one block per (64-key tile, batch * q-head); each warp owns 16
//     keys and keeps their k and v fragments in registers, and the block
//     walks 64-query tiles of q, d_out, lse and dsum. It computes S^T and
//     dP^T with keys as rows, so P^T and dS^T are A fragments of
//     P_drop^T d_out and dS^T q. It writes dk and dv per QUERY head in f32;
//     the wrapper sums them over the GQA group, as the TPU version does in
//     XLA: no atomics, the same result on every run.
// Under `causal`, tiles that are wholly masked are skipped (the key loop of
// dq ends at the tile's last query, the query loop of dk/dv starts at the
// tile's first key), and both loops end at the key length.
//
// Bound on the H100 SXM: the backward needs 5 products of 2 * T * S * D per
// head (S recomputed, dP, dv, dq, dk), half of them under `causal`. At the
// LLM's causal shape (B 4, Hq 32, Hkv 8, T = S ~ 350, D 64) that is 5 GFLOP
// (5 us at 989 TFLOP/s) against 29 MB of q, k, v, out, d_out, lse, dq, dk
// and dv (9 us at 3.35 TB/s); at AV-HuBERT's (B 4, 16 heads, T = S = 320)
// 4.2 GFLOP (4 us) against 21 MB (6 us): both bound by bytes on paper, and
// by launch and latency in practice at these small sizes. These two
// kernels do 7 products, not 5 (S and dP in both), and move the f32
// per-head dk/dv as well: the price of needing neither atomics nor a
// stored P. mma.sync from ldmatrix fragments reaches a fraction of the
// wgmma peak; a wgmma/TMA version in one pass is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // keys per tile
constexpr int THREADS = 128;

struct Args {
  const __nv_bfloat16* q;     // (B, T, Hq, D)
  const __nv_bfloat16* k;     // (B, S, Hkv, D)
  const __nv_bfloat16* v;     // (B, S, Hkv, D)
  const __nv_bfloat16* dout;  // (B, T, Hq, D)
  const float* lse;           // (B * Hq, T)
  const float* dsum;          // (B * Hq, T)
  const int32_t* kv_lens;     // (B,) or null
  __nv_bfloat16* dq;          // (B, T, Hq, D)
  float* dk;                  // (B, S, Hq, D): per query head
  float* dv;                  // (B, S, Hq, D): per query head
  int T, S, Hq, Hkv;
  float scale;
  int causal, dropout;
  uint32_t seed;
  int32_t thresh;
  float keep_scale;
};

// Copies `rows` rows of D bf16 starting at row r0 of a (rows_total, stride)
// matrix into a padded shared tile, zero-filling rows past `limit`.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          const __nv_bfloat16* any_valid, size_t stride, int r0,
                                          int limit, int tid) {
  constexpr int LD = D + 8, ROW_CHUNKS = D / 8;
  for (int i = tid; i < 64 * ROW_CHUNKS; i += THREADS) {
    const int r = i / ROW_CHUNKS, c = (i % ROW_CHUNKS) * 8;
    const bool ok = r0 + r < limit;
    port::cp_async16(dst + r * LD + c, ok ? base + (size_t)(r0 + r) * stride + c : any_valid, ok);
  }
}

__device__ __forceinline__ int key_limit(const Args& a, int b) {
  return a.kv_lens != nullptr ? min(a.S, max(0, a.kv_lens[b])) : a.S;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sDO = sQ + BQ * LD;
  __nv_bfloat16* sK = sDO + BQ * LD;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * BKV * LD;  // 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hkv = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int T = a.T, S = a.S;

  const int kv_limit = key_limit(a, b);
  int n_tiles = (kv_limit + BKV - 1) / BKV;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, T) - 1) / BKV + 1);  // keys <= last query

  const size_t q_stride = (size_t)a.Hq * D, kv_stride = (size_t)a.Hkv * D;
  const size_t q_off = ((size_t)b * T * a.Hq + h) * D;
  const size_t kv_off = ((size_t)b * S * a.Hkv + hkv) * D;
  load_tile<D>(sQ, a.q + q_off, a.q, q_stride, q0, T, tid);
  load_tile<D>(sDO, a.dout + q_off, a.dout, q_stride, q0, T, tid);
  auto load_kv = [&](int stage, int tile) {
    load_tile<D>(sK + stage * BKV * LD, a.k + kv_off, a.k, kv_stride, tile * BKV, S, tid);
    load_tile<D>(sV + stage * BKV * LD, a.v + kv_off, a.v, kv_stride, tile * BKV, S, tid);
  };
  if (n_tiles > 0) load_kv(0, 0);
  port::cp_async_commit();

  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse_r[i] = row < T ? a.lse[(size_t)bh * T + row] : 0.f;
    dsum_r[i] = row < T ? a.dsum[(size_t)bh * T + row] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
  const uint32_t h_mix = (uint32_t)bh * 0x9E3779B9u;

  for (int t = 0; t < n_tiles; ++t) {
    port::cp_async_wait<0>();
    __syncthreads();  // tile t (and at t = 0 the q, d_out tiles) landed; tile t-1 is consumed
    if (t + 1 < n_tiles) load_kv((t + 1) & 1, t + 1);
    port::cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int off = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        port::ldmatrix_x4(qf[kk], sQ + off);
        port::ldmatrix_x4(df[kk], sDO + off);
      }
    }
    const __nv_bfloat16* tK = sK + (t & 1) * BKV * LD;
    const __nv_bfloat16* tV = sV + (t & 1) * BKV * LD;
    const int j0 = t * BKV;

    // S = q k^T and dP = d_out v^T, 16 rows x 64 keys per warp
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t r[4];
        const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        port::ldmatrix_x4(r, tK + off);
        port::mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        port::mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        port::ldmatrix_x4(r, tV + off);
        port::mma_bf16(dp[2 * np], df[kk], r[0], r[1]);
        port::mma_bf16(dp[2 * np + 1], df[kk], r[2], r[3]);
      }
    }

    // dS = p * (dp * keep / (1 - rate) - dsum) * scale, kept in s
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool valid = key < kv_limit && row < T && !(a.causal && key > row);
        const float p = valid ? __expf(s[n][e] * a.scale - lse_r[e >> 1]) : 0.f;
        float dpv = dp[n][e];
        if (a.dropout)
          dpv = port::keep_elem((uint32_t)row, (uint32_t)key, (uint32_t)S, h_mix, a.seed,
                                a.thresh) ? dpv * a.keep_scale : 0.f;
        s[n][e] = p * (dpv - dsum_r[e >> 1]) * a.scale;
      }
    }

    // dq += dS k: the accumulators of key tiles 2c, 2c+1 are the A fragment
    // of the c-th 16-key step
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      uint32_t af[4];
      af[0] = port::pack_bf16x2(s[2 * c][0], s[2 * c][1]);
      af[1] = port::pack_bf16x2(s[2 * c][2], s[2 * c][3]);
      af[2] = port::pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]);
      af[3] = port::pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t r[4];
        const int krow = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        port::ldmatrix_x4_trans(r, tK + krow * LD + dp2 * 16 + (lane >> 4) * 8);
        port::mma_bf16(acc[2 * dp2], af, r[0], r[1]);
        port::mma_bf16(acc[2 * dp2 + 1], af, r[2], r[3]);
      }
    }
  }
  port::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= T) continue;
    __nv_bfloat16* drow = a.dq + ((size_t)b * T + row) * q_stride + (size_t)h * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(drow + d) = port::pack_bf16x2(acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Args a) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BKV * LD;
  __nv_bfloat16* sQ = sV + BKV * LD;     // 2 stages
  __nv_bfloat16* sDO = sQ + 2 * BQ * LD;  // 2 stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * LD);  // lse, 2 stages
  float* sDs = sL + 2 * BQ;                                 // dsum, 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hkv = h / (a.Hq / a.Hkv);
  const int k0 = blockIdx.x * BKV;
  const int T = a.T, S = a.S;

  const int kv_limit = key_limit(a, b);
  const int q_end = k0 < kv_limit ? (T + BQ - 1) / BQ : 0;  // no valid key here: dk = dv = 0
  const int q_begin = a.causal ? k0 / BQ : 0;  // earlier queries see none of these keys
  const int n_q = max(0, q_end - q_begin);

  const size_t q_stride = (size_t)a.Hq * D, kv_stride = (size_t)a.Hkv * D;
  const size_t q_off = ((size_t)b * T * a.Hq + h) * D;
  const size_t kv_off = ((size_t)b * S * a.Hkv + hkv) * D;
  load_tile<D>(sK, a.k + kv_off, a.k, kv_stride, k0, S, tid);
  load_tile<D>(sV, a.v + kv_off, a.v, kv_stride, k0, S, tid);
  auto load_q = [&](int stage, int tile) {
    const int i0 = tile * BQ;
    load_tile<D>(sQ + stage * BQ * LD, a.q + q_off, a.q, q_stride, i0, T, tid);
    load_tile<D>(sDO + stage * BQ * LD, a.dout + q_off, a.dout, q_stride, i0, T, tid);
    for (int r = tid; r < BQ; r += THREADS) {  // plain loads: the rows need not be aligned
      const int row = i0 + r;
      sL[stage * BQ + r] = row < T ? a.lse[(size_t)bh * T + row] : 0.f;
      sDs[stage * BQ + r] = row < T ? a.dsum[(size_t)bh * T + row] : 0.f;
    }
  };
  if (n_q > 0) load_q(0, q_begin);
  port::cp_async_commit();

  const int key0 = k0 + warp * 16 + (lane >> 2);  // this thread's keys: key0, key0 + 8
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  const uint32_t h_mix = (uint32_t)bh * 0x9E3779B9u;

  for (int it = 0; it < n_q; ++it) {
    port::cp_async_wait<0>();
    __syncthreads();  // tile `it` (and at it = 0 the k, v tiles) landed; tile it-1 is consumed
    if (it + 1 < n_q) load_q((it + 1) & 1, q_begin + it + 1);
    port::cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int off = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        port::ldmatrix_x4(kf[kk], sK + off);
        port::ldmatrix_x4(vf[kk], sV + off);
      }
    }
    const __nv_bfloat16* tQ = sQ + (it & 1) * BQ * LD;
    const __nv_bfloat16* tDO = sDO + (it & 1) * BQ * LD;
    const float* tL = sL + (it & 1) * BQ;
    const float* tDs = sDs + (it & 1) * BQ;
    const int i0 = (q_begin + it) * BQ;

    // S^T = k q^T and dP^T = v d_out^T, 16 keys x 64 queries per warp
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t r[4];
        const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        port::ldmatrix_x4(r, tQ + off);
        port::mma_bf16(s[2 * np], kf[kk], r[0], r[1]);
        port::mma_bf16(s[2 * np + 1], kf[kk], r[2], r[3]);
        port::ldmatrix_x4(r, tDO + off);
        port::mma_bf16(dp[2 * np], vf[kk], r[0], r[1]);
        port::mma_bf16(dp[2 * np + 1], vf[kk], r[2], r[3]);
      }
    }

    // P_drop^T into s, dS^T into dp
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * (lane & 3) + (e & 1);
        const int row = i0 + qc;
        const int key = key0 + (e >> 1) * 8;
        const bool valid = key < kv_limit && row < T && !(a.causal && key > row);
        const float p = valid ? __expf(s[n][e] * a.scale - tL[qc]) : 0.f;
        float pd = p, dpv = dp[n][e];
        if (a.dropout) {
          const bool keep = port::keep_elem((uint32_t)row, (uint32_t)key, (uint32_t)S, h_mix,
                                            a.seed, a.thresh);
          pd = keep ? p * a.keep_scale : 0.f;
          dpv = keep ? dpv * a.keep_scale : 0.f;
        }
        s[n][e] = pd;
        dp[n][e] = p * (dpv - tDs[qc]) * a.scale;
      }
    }

    // dv += P_drop^T d_out, dk += dS^T q: the accumulators of query tiles
    // 2c, 2c+1 are the A fragments of the c-th 16-query step
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      uint32_t ap[4], ad[4];
      ap[0] = port::pack_bf16x2(s[2 * c][0], s[2 * c][1]);
      ap[1] = port::pack_bf16x2(s[2 * c][2], s[2 * c][3]);
      ap[2] = port::pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]);
      ap[3] = port::pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3]);
      ad[0] = port::pack_bf16x2(dp[2 * c][0], dp[2 * c][1]);
      ad[1] = port::pack_bf16x2(dp[2 * c][2], dp[2 * c][3]);
      ad[2] = port::pack_bf16x2(dp[2 * c + 1][0], dp[2 * c + 1][1]);
      ad[3] = port::pack_bf16x2(dp[2 * c + 1][2], dp[2 * c + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t r[4];
        const int off = (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp2 * 16 +
                        (lane >> 4) * 8;
        port::ldmatrix_x4_trans(r, tDO + off);
        port::mma_bf16(dv[2 * dp2], ap, r[0], r[1]);
        port::mma_bf16(dv[2 * dp2 + 1], ap, r[2], r[3]);
        port::ldmatrix_x4_trans(r, tQ + off);
        port::mma_bf16(dk[2 * dp2], ad, r[0], r[1]);
        port::mma_bf16(dk[2 * dp2 + 1], ad, r[2], r[3]);
      }
    }
  }
  port::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key >= S) continue;
    const size_t off = (((size_t)b * S + key) * a.Hq + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(a.dk + off + d) = make_float2(dk[dt][2 * i], dk[dt][2 * i + 1]);
      *reinterpret_cast<float2*>(a.dv + off + d) = make_float2(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t tile = (size_t)(D + 8) * 2;  // bytes per padded bf16 row
  constexpr size_t smem_dq = (2 * BQ + 4 * BKV) * tile;
  constexpr size_t smem_dkv = (2 * BKV + 4 * BQ) * tile + 4 * BQ * sizeof(float);
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  flash_bwd_dq_kernel<D><<<dim3((a.T + BQ - 1) / BQ, B * a.Hq), THREADS, smem_dq, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<D><<<dim3((a.S + BKV - 1) / BKV, B * a.Hq), THREADS, smem_dkv, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, d_out (B, T, Hq, D) and k, v (B, S, Hkv, D) bf16 contiguous;
// lse and dsum (B * Hq, T) f32; kv_lens (B,) int32 or null ->
// dq (B, T, Hq, D) bf16, dk and dv (B, S, Hq, D) f32 per query head.
// dropout != 0 applies the forward's keep mask (seed, thresh) with
// keep_scale = 1 / (1 - rate).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dsum,
                                          const void* kv_lens, void* dq, void* dk, void* dv,
                                          int B, int T, int S, int Hq, int Hkv, int D,
                                          float scale, int causal, int dropout, int seed,
                                          int thresh, float keep_scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(dsum),
               static_cast<const int32_t*>(kv_lens),
               static_cast<__nv_bfloat16*>(dq),
               static_cast<float*>(dk),
               static_cast<float*>(dv),
               T, S, Hq, Hkv, scale, causal, dropout, (uint32_t)seed, (int32_t)thresh,
               keep_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, st);
  if (D == 128) return launch<128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
