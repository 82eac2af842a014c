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
//   ds = p * (dp - dsum) * scale, dsum = rowsum(d_out * out) (the dq kernel);
//   dq = ds k, dk = ds^T q.
// p_drop and ds are rounded to bf16 for their products, as the TPU kernels
// round them to the input dtype. The keep mask is the forward's
// (keep_mask.cuh), so both directions drop the same probabilities.
//
// Design: two kernels, launched one after the other on the same stream;
// the wrapper allocates dq, dk, dv and the dsum buffer and runs no other op.
// Every product is a Hopper wgmma (m64, f32 accumulators): q, k, v and
// d_out tiles of 64 rows reach shared memory by cp.async in the 128-byte
// swizzle that wgmma's descriptors read, in 64-column blocks; S and dP
// come from two shared-memory operands, and P (dropped) and dS go from
// their accumulators straight into registers as the A operand of the
// products that follow, against a k, q or d_out tile read transposed.
//   - dq: one warpgroup per (64-query tile, batch * q-head). It loads the
//     tile's q, d_out and out, computes dsum = rowsum(d_out * out) in f32
//     for its rows and stores it to a (B * Hq, T) buffer for the second
//     kernel. It walks the 64-key tiles of its kv head, K and V
//     double-buffered: S = q k^T and dP = d_out v^T (SS), dS in registers,
//     dq += dS k (RS, k transposed).
//   - dk/dv: one block of two warpgroups per (64-key tile, batch * KV
//     head). The block walks the G query heads of the kv head's group and,
//     for each, the query tiles that see its keys, reading q, d_out, lse
//     and the first kernel's dsum; warpgroup w takes every other one of
//     these steps, with its own double-buffered tiles and barrier. Each
//     step: S^T = k q^T and dP^T = v d_out^T (SS, keys as rows), P_drop^T
//     and dS^T in registers, dv += P_drop^T d_out and dk += dS^T q (RS,
//     d_out and q transposed). dk and dv stay in f32 registers over the
//     whole group; the two warpgroups' sums are added through shared memory
//     at the end, and the block stores dk and dv once, in bf16. The GQA sum
//     happens in the kernel, in a fixed order: no atomics and no
//     per-query-head buffer, the same result on every run.
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
// by latency in practice at these small sizes: a step's five products
// depend on one another through registers, so a warpgroup waits on each.
// These two kernels do 7 products, not 5 (S and dP in both): the price of
// needing neither atomics nor a stored P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_sm80.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // keys per tile
constexpr int DQ_THREADS = 128;   // one warpgroup
constexpr int DKV_THREADS = 256;  // two warpgroups

struct Args {
  const __nv_bfloat16* q;     // (B, T, Hq, D)
  const __nv_bfloat16* k;     // (B, S, Hkv, D)
  const __nv_bfloat16* v;     // (B, S, Hkv, D)
  const __nv_bfloat16* o;     // (B, T, Hq, D): the forward's output
  const __nv_bfloat16* dout;  // (B, T, Hq, D)
  const float* lse;           // (B * Hq, T)
  float* dsum;                // (B * Hq, T): written by dq, read by dk/dv
  const int32_t* kv_lens;     // (B,) or null
  __nv_bfloat16* dq;          // (B, T, Hq, D)
  __nv_bfloat16* dk;          // (B, S, Hkv, D)
  __nv_bfloat16* dv;          // (B, S, Hkv, D)
  int T, S, Hq, Hkv;
  float scale;
  int causal, dropout;
  uint32_t seed;
  uint32_t bh0;  // the keep mask's flattened index of batch row 0, head 0
  int32_t thresh;
  float keep_scale;
};

// A tile of 64 rows x D bf16 in shared memory: 64-column blocks of 64 rows
// x 128 bytes (8 KB), the 16-byte chunk c of row r at chunk c ^ (r % 8).
template <int D>
constexpr int TILE = 64 * D * 2;

// The byte offset of 16-byte chunk cc (columns 8 cc .. 8 cc + 7) of row r.
__device__ __forceinline__ int swz(int r, int cc) {
  return (cc >> 3) * 8192 + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// Copies rows r0 .. r0 + 63 of a (rows_total, stride) matrix into a tile,
// zero-filling rows past `limit`.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const __nv_bfloat16* base,
                                          const __nv_bfloat16* any_valid, size_t stride, int r0,
                                          int limit, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i / CH, cc = i % CH;
    const bool ok = r0 + r < limit;
    port::cp_async16(dst + swz(r, cc), ok ? base + (size_t)(r0 + r) * stride + cc * 8 : any_valid,
                     ok);
  }
}

// cp.async writes (generic proxy) become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A tile as a K-major operand (its rows are m or n, its columns k): the
// 16-deep step kk.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  return port::wgmma_desc_sw128(port::smem_addr(tile) + (kk >> 2) * 8192 + (kk & 3) * 32);
}

// A tile as the transposed B operand (its rows are k, its columns n): the
// 16-deep step c (rows 16 c ..), 64-column blocks 8 KB apart.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int c) {
  return port::wgmma_desc_sw128(port::smem_addr(tile) + c * 2048, 8192);
}

// The A fragment of 16-deep step c from an m64n64 accumulator (columns
// 16 c .. 16 c + 15 become k), rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int c, uint32_t (&a)[4]) {
  a[0] = port::pack_bf16x2(d[8 * c], d[8 * c + 1]);
  a[1] = port::pack_bf16x2(d[8 * c + 2], d[8 * c + 3]);
  a[2] = port::pack_bf16x2(d[8 * c + 4], d[8 * c + 5]);
  a[3] = port::pack_bf16x2(d[8 * c + 6], d[8 * c + 7]);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~(uintptr_t)1023);
}

__device__ __forceinline__ int key_limit(const Args& a, int b) {
  return a.kv_lens != nullptr ? min(a.S, max(0, a.kv_lens[b])) : a.S;
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS) flash_bwd_dq_kernel(const Args a) {
  constexpr int TB = TILE<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sDO = sQ + TB;
  unsigned char* sO = sDO + TB;
  unsigned char* sK = sO + TB;       // 2 stages
  unsigned char* sV = sK + 2 * TB;   // 2 stages
  float* sDsum = reinterpret_cast<float*>(sV + 2 * TB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the last query tiles first: under `causal` they see the most keys
  const int bh = blockIdx.x % (gridDim.x / ((a.T + BQ - 1) / BQ));
  const int q0 = ((a.T + BQ - 1) / BQ - 1 - blockIdx.x / (gridDim.x / ((a.T + BQ - 1) / BQ))) * BQ;
  const int b = bh / a.Hq, h = bh % a.Hq, hkv = h / (a.Hq / a.Hkv);
  const int T = a.T, S = a.S;

  const int kv_limit = key_limit(a, b);
  int n_tiles = (kv_limit + BKV - 1) / BKV;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + BQ, T) - 1) / BKV + 1);  // keys <= last query

  const size_t q_stride = (size_t)a.Hq * D, kv_stride = (size_t)a.Hkv * D;
  const size_t q_off = ((size_t)b * T * a.Hq + h) * D;
  const size_t kv_off = ((size_t)b * S * a.Hkv + hkv) * D;
  load_tile<D, DQ_THREADS>(sQ, a.q + q_off, a.q, q_stride, q0, T, tid);
  load_tile<D, DQ_THREADS>(sDO, a.dout + q_off, a.dout, q_stride, q0, T, tid);
  load_tile<D, DQ_THREADS>(sO, a.o + q_off, a.o, q_stride, q0, T, tid);
  auto load_kv = [&](int stage, int tile) {
    load_tile<D, DQ_THREADS>(sK + stage * TB, a.k + kv_off, a.k, kv_stride, tile * BKV, S, tid);
    load_tile<D, DQ_THREADS>(sV + stage * TB, a.v + kv_off, a.v, kv_stride, tile * BKV, S, tid);
  };
  if (n_tiles > 0) load_kv(0, 0);
  port::cp_async_commit();
  port::cp_async_wait<0>();
  __syncthreads();

  // dsum = rowsum(d_out * out) in f32: two threads per row, each half of D
  {
    const int r = tid >> 1;
    float acc = 0.f;
#pragma unroll
    for (int cc = (tid & 1) * (D / 16); cc < ((tid & 1) + 1) * (D / 16); ++cc) {
      const uint4 d4 = *reinterpret_cast<const uint4*>(sDO + swz(r, cc));
      const uint4 o4 = *reinterpret_cast<const uint4*>(sO + swz(r, cc));
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 df = __bfloat1622float2(d2[i]), of = __bfloat1622float2(o2[i]);
        acc += df.x * of.x + df.y * of.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      sDsum[r] = acc;
      if (q0 + r < T) a.dsum[(size_t)bh * T + q0 + r] = acc;
    }
  }
  __syncthreads();  // sDsum written

  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse_r[i] = row < T ? a.lse[(size_t)bh * T + row] : 0.f;
    dsum_r[i] = sDsum[row - q0];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t h_mix = (a.bh0 + (uint32_t)bh) * 0x9E3779B9u;

  for (int t = 0; t < n_tiles; ++t) {
    port::cp_async_wait<0>();
    fence_async();
    __syncthreads();  // tile t landed; tile t-1 is consumed
    if (t + 1 < n_tiles) load_kv((t + 1) & 1, t + 1);
    port::cp_async_commit();
    const unsigned char* tK = sK + (t & 1) * TB;
    const unsigned char* tV = sV + (t & 1) * TB;
    const int j0 = t * BKV;

    // S = q k^T and dP = d_out v^T: 64 queries x 64 keys
    float s[32], dp[32];
    port::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      port::WgmmaSS<64>::mma(s, desc_k(sQ, kk), desc_k(tK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      port::WgmmaSS<64>::mma(dp, desc_k(sDO, kk), desc_k(tV, kk), kk > 0);
    port::wgmma_commit();
    port::wgmma_wait<0>();

    // dS = p * (dp * keep / (1 - rate) - dsum) * scale, kept in s
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int r = (i >> 1) & 1, row = row0 + 8 * r;
      const bool valid = key < kv_limit && row < T && !(a.causal && key > row);
      const float p = valid ? __expf(s[i] * a.scale - lse_r[r]) : 0.f;
      float dpv = dp[i];
      if (a.dropout)
        dpv = port::keep_elem((uint32_t)row, (uint32_t)key, (uint32_t)S, h_mix, a.seed,
                              a.thresh) ? dpv * a.keep_scale : 0.f;
      s[i] = p * (dpv - dsum_r[r]) * a.scale;
    }

    // dq += dS k, k read transposed (its rows are the keys)
    port::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      uint32_t af[4];
      acc_to_a(s, c, af);
      port::WgmmaRS<D>::template mma<1>(acc, af, desc_mn(tK, c));
    }
    port::wgmma_commit();
    port::wgmma_wait<0>();
  }
  port::cp_async_wait<0>();

  // acc[4j + 2r + e] = row row0 + 8r, column 8j + 2 (lane % 4) + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    __nv_bfloat16* drow = a.dq + ((size_t)b * T + row) * q_stride + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + 8 * j + 2 * (lane & 3)) =
          port::pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS) flash_bwd_dkv_kernel(const Args a) {
  constexpr int TB = TILE<D>;
  constexpr int WG_BYTES = 4 * TB + 4 * BQ * (int)sizeof(float);  // a warpgroup's ring
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + TB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;  // warpgroup, warp in it
  // this warpgroup's ring: 2 stages of (q tile, d_out tile), then lse and dsum
  unsigned char* sQ = sV + TB + wg * WG_BYTES;
  unsigned char* sDO = sQ + 2 * TB;
  float* sL = reinterpret_cast<float*>(sDO + 2 * TB);
  float* sDs = sL + 2 * BQ;

  // the first key tiles first: under `causal` the most queries see them
  const int bkv = blockIdx.x % (gridDim.x / ((a.S + BKV - 1) / BKV));
  const int k0 = blockIdx.x / (gridDim.x / ((a.S + BKV - 1) / BKV)) * BKV;
  const int b = bkv / a.Hkv, hkv = bkv % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int T = a.T, S = a.S;

  const int kv_limit = key_limit(a, b);
  const int q_end = k0 < kv_limit ? (T + BQ - 1) / BQ : 0;  // no valid key here: dk = dv = 0
  const int q_begin = a.causal ? k0 / BQ : 0;  // earlier queries see none of these keys
  const int n_q = max(0, q_end - q_begin);
  const int n_it = G * n_q;  // (head of the group, query tile), heads outer
  const int n_mine = (n_it - wg + 1) / 2;  // this warpgroup's steps: wg, wg + 2, ...

  const size_t q_stride = (size_t)a.Hq * D, kv_stride = (size_t)a.Hkv * D;
  const size_t kv_off = ((size_t)b * S * a.Hkv + hkv) * D;
  load_tile<D, DKV_THREADS>(sK, a.k + kv_off, a.k, kv_stride, k0, S, tid);
  load_tile<D, DKV_THREADS>(sV, a.v + kv_off, a.v, kv_stride, k0, S, tid);
  auto load_q = [&](int stage, int it) {
    const int h = hkv * G + it / n_q;
    const int i0 = (q_begin + it % n_q) * BQ;
    const size_t q_off = ((size_t)b * T * a.Hq + h) * D;
    const size_t bh = (size_t)b * a.Hq + h;
    load_tile<D, 128>(sQ + stage * TB, a.q + q_off, a.q, q_stride, i0, T, wtid);
    load_tile<D, 128>(sDO + stage * TB, a.dout + q_off, a.dout, q_stride, i0, T, wtid);
    if (wtid < BQ) {  // plain loads: the rows need not be aligned
      const int row = i0 + wtid;
      sL[stage * BQ + wtid] = row < T ? a.lse[bh * T + row] : 0.f;
      sDs[stage * BQ + wtid] = row < T ? a.dsum[bh * T + row] : 0.f;
    }
  };
  if (n_mine > 0) load_q(0, wg);
  port::cp_async_commit();
  port::cp_async_wait<0>();
  fence_async();
  __syncthreads();  // k, v and both warpgroups' first tiles landed

  const int key0 = k0 + wq * 16 + (lane >> 2);  // this thread's keys: key0, key0 + 8
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int m = 0; m < n_mine; ++m) {
    if (m > 0) {
      port::cp_async_wait<0>();
      fence_async();
      named_barrier(1 + wg, 128);  // this warpgroup's step m landed; step m-1 is consumed
    }
    if (m + 1 < n_mine) load_q((m + 1) & 1, wg + 2 * (m + 1));
    port::cp_async_commit();
    const int it = wg + 2 * m;
    const unsigned char* tQ = sQ + (m & 1) * TB;
    const unsigned char* tDO = sDO + (m & 1) * TB;
    const float* tL = sL + (m & 1) * BQ;
    const float* tDs = sDs + (m & 1) * BQ;
    const int h = hkv * G + it / n_q;
    const int i0 = (q_begin + it % n_q) * BQ;
    const uint32_t h_mix = (a.bh0 + (uint32_t)(b * a.Hq + h)) * 0x9E3779B9u;

    // S^T = k q^T and dP^T = v d_out^T: 64 keys x 64 queries
    float s[32], dp[32];
    port::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      port::WgmmaSS<64>::mma(s, desc_k(sK, kk), desc_k(tQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      port::WgmmaSS<64>::mma(dp, desc_k(sV, kk), desc_k(tDO, kk), kk > 0);
    port::wgmma_commit();
    port::wgmma_wait<0>();

    // P_drop^T into s, dS^T into dp
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int row = i0 + qc;
      const int key = key0 + 8 * ((i >> 1) & 1);
      const bool valid = key < kv_limit && row < T && !(a.causal && key > row);
      const float p = valid ? __expf(s[i] * a.scale - tL[qc]) : 0.f;
      float pd = p, dpv = dp[i];
      if (a.dropout) {
        const bool keep = port::keep_elem((uint32_t)row, (uint32_t)key, (uint32_t)S, h_mix,
                                          a.seed, a.thresh);
        pd = keep ? p * a.keep_scale : 0.f;
        dpv = keep ? dpv * a.keep_scale : 0.f;
      }
      s[i] = pd;
      dp[i] = p * (dpv - tDs[qc]) * a.scale;
    }

    // dv += P_drop^T d_out, dk += dS^T q, d_out and q read transposed
    port::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      uint32_t ap[4], ad[4];
      acc_to_a(s, c, ap);
      acc_to_a(dp, c, ad);
      port::WgmmaRS<D>::template mma<1>(dv, ap, desc_mn(tDO, c));
      port::WgmmaRS<D>::template mma<1>(dk, ad, desc_mn(tQ, c));
    }
    port::wgmma_commit();
    port::wgmma_wait<0>();
  }
  port::cp_async_wait<0>();
  __syncthreads();  // both warpgroups are done with their rings

  // warpgroup 1 leaves its sums in shared memory (its ring, 512 * D bytes);
  // warpgroup 0 adds them and stores dk, dv in bf16
  float* red = reinterpret_cast<float*>(sV + TB + WG_BYTES);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      red[i * 128 + wtid] = dk[i];
      red[(D / 2 + i) * 128 + wtid] = dv[i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] += red[i * 128 + wtid];
    dv[i] += red[(D / 2 + i) * 128 + wtid];
  }
  // dk[4j + 2r + e] = key key0 + 8r, column 8j + 2 (lane % 4) + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= S) continue;
    const size_t off = (((size_t)b * S + key) * a.Hkv + hkv) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(a.dk + off + d) =
          port::pack_bf16x2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + off + d) =
          port::pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem_dq = 1024 + 7 * (size_t)TILE<D> + BQ * sizeof(float);
  constexpr size_t smem_dkv = 1024 + 2 * (size_t)TILE<D> + 2 * (4 * (size_t)TILE<D> + 4 * BQ * 4);
  static_assert(4 * TILE<D> + 4 * BQ * 4 >= 512 * D, "a ring holds a warpgroup's dk/dv sums");
  // the shared-memory limits are raised once on each device of the process
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  flash_bwd_dq_kernel<D><<<(a.T + BQ - 1) / BQ * B * a.Hq, DQ_THREADS, smem_dq, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<D>
      <<<(a.S + BKV - 1) / BKV * B * a.Hkv, DKV_THREADS, smem_dkv, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, d_out (B, T, Hq, D) and k, v (B, S, Hkv, D) bf16 contiguous; lse
// (B * Hq, T) f32; kv_lens (B,) int32 or null -> dq (B, T, Hq, D), dk and dv
// (B, S, Hkv, D) bf16, and dsum (B * Hq, T) f32 (scratch between the two
// kernels). dropout != 0 applies the forward's keep mask (seed, bh0, thresh)
// with keep_scale = 1 / (1 - rate).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dsum, const void* kv_lens, void* dq, void* dk,
                                          void* dv, int B, int T, int S, int Hq, int Hkv, int D,
                                          float scale, int causal, int dropout, int seed,
                                          int bh0, int thresh, float keep_scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(o),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse),
               static_cast<float*>(dsum),
               static_cast<const int32_t*>(kv_lens),
               static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv),
               T, S, Hq, Hkv, scale, causal, dropout, (uint32_t)seed, (uint32_t)bh0,
               (int32_t)thresh, keep_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, st);
  if (D == 128) return launch<128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
