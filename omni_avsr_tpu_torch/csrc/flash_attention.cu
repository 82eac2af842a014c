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
// Rows of a query without any valid key (length 0) come out as 0; the TPU
// kernel gives them a tiling-dependent average there.
//
// Bound on the H100 SXM: at Whisper's 30 s window (B 3, 16 heads,
// T = S = 1500, D 64) one launch does 4 * B * H * T * S * D = 27.6 GFLOP
// (28 us at 989 TFLOP/s) and moves 36.9 MB of q, k, v and out (11 us at
// 3.35 TB/s): bound by the tensor cores, which only wgmma drives at full
// rate, and about as much by the softmax's 108 M exponentials at the SFUs'
// 16 a clock per SM.
//
// Design: one persistent block per SM walks work tiles of BQ queries of
// one (batch, q-head), the last query tiles first (under `causal` they see
// the most keys):
//   - a producer warpgroup, whose first lane issues TMA loads through
//     rank-4 tensor maps of q, k and v ((D, H, T, B), boxes of 64 columns
//     x BQ or 64 positions of one head, 128-byte swizzle; positions past T
//     or S read as zero, never as the next batch entry's): each tile's q
//     into one of two buffers, and a ring of STAGES (k tile, v tile) stages
//     of 64 keys of the kv head (GQA: q-head h reads kv-head h / G), each
//     completing on an mbarrier; the consumers release q buffers and
//     stages through a second set. The next tile's q and first keys load
//     while the consumers finish the current tile.
//   - NWG consumer warpgroups of 64 query rows (three at D 64, two at D
//     128; the producer gives them its registers with setmaxnreg). S = q
//     k^T is a wgmma with both operands in shared memory (K-major); the
//     mask, the online softmax and the dropout hash run in registers on
//     wgmma's accumulator fragment; P, rounded to bf16, goes from there
//     straight into the A registers of O += P v, a wgmma against the v
//     tile read transposed (MN-major).
//   - overlap: each warpgroup issues tile j's S product together with tile
//     j-1's P v product and runs tile j's softmax while P v runs; the
//     three warpgroups interleave on the SM without a fixed order.
// The key loop ends at the key length and, when causal, at the tile's last
// query, so fully masked tiles are skipped; the mask is applied only on
// tiles that cross the key length or the diagonal, without branches per
// element. Any finite scale: a scale of 0 or below runs a second
// instantiation (`kAnyScale`) whose softmax scales the logits before the
// max and the mask (`softmax_tile`).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"
#include "mma_sm80.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int NWG = D == 64 ? 3 : 2;      // consumer warpgroups of 64 query rows
  static constexpr int BQ = 64 * NWG;              // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);  // and one producer warpgroup
  static constexpr int CONSUMER_REGS = NWG == 3 ? 160 : 240;  // per thread, after setmaxnreg
  static constexpr int BKV = 64;                   // keys per tile
  static constexpr int STAGES = D == 64 ? 6 : 4;   // ring stages of (k tile, v tile)
  static constexpr int Q_BYTES = BQ * D * 2;       // D / 64 blocks of BQ rows x 128 bytes
  static constexpr int KV_TILE = BKV * D * 2;      // D / 64 blocks of BKV rows x 128 bytes
  static constexpr int STAGE = 2 * KV_TILE;        // k tile, then v tile
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + (size_t)STAGES * STAGE +
                                 (2 * STAGES + 4) * sizeof(uint64_t);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pins registers at this point of the program: the compiler may not move
// their reads or writes across it, so none crosses a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// A tile of `rows` rows of D columns (D / 64 blocks of rows x 128 bytes) as
// a K-major operand: its 16-deep step kk.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows, int kk) {
  return port::wgmma_desc_sw128(port::smem_u32(tile) + (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// The same tile as the transposed B operand (its rows are k, its columns
// n): the 16-deep step c, 64-column blocks rows * 128 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int rows, int c) {
  return port::wgmma_desc_sw128(port::smem_u32(tile) + c * 2048, rows * 128);
}

// S = q k^T: 64 queries x BKV keys of one key tile
template <int D, int BQ, int BKV>
__device__ __forceinline__ void issue_qk(float (&s)[BKV / 2], const unsigned char* q,
                                         const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    port::WgmmaSS<BKV>::mma(s, desc_k(q, BQ, kk), desc_k(k, BKV, kk), kk > 0);
}

// O += P v, v read transposed (its rows are the keys)
template <int D, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BKV / 16][4],
                                         const unsigned char* v) {
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c)
    port::WgmmaRS<D>::template mma<1>(o, pa[c], desc_mn(v, BKV, c));
}

// What the softmax of a thread's rows needs besides the tile.
struct Rows {
  int row0;      // this thread's rows: row0, row0 + 8
  int wg_row0;   // the warpgroup's first row
  int t4;        // lane % 4
  int kv_limit;  // keys at or past it are masked
  int causal, dropout, S;
  float sl2;     // scale * log2(e): logits in log2 units
  uint32_t h_mix, seed;
  int32_t thresh;
  float keep_scale;
};

// Mask, online softmax and dropout of the key tile from key j0, in place
// on s (raw logits in, P out); m and l are the rows' running max (scaled
// logits, log2 units) and this thread's share of their sums; corr the
// factor of the running sums. For a positive scale the max is taken on
// the raw logits and scaled after, and each element costs one FFMA and one
// ex2 beside the max and the sum; the mask runs only on tiles that cross
// the key length or the diagonal, without branches. kAnyScale (a scale of
// 0 or below, a kernel of its own so that the positive path stays as it
// is) scales every tile first and masks after: the max of raw logits is
// the wrong one below 0, and a scale of 0 would turn a masked -inf into
// NaN. The running max starts at -1e30, below every live scaled logit.
template <int BKV, bool kAnyScale>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int j0, const Rows& a) {
  if (kAnyScale || j0 + BKV > a.kv_limit || (a.causal && j0 + BKV - 1 > a.wg_row0)) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {  // s[i]: row row0 + 8 ((i >> 1) & 1), key below
      const int key = j0 + 8 * (i >> 2) + 2 * a.t4 + (i & 1);
      const int row = a.row0 + 8 * ((i >> 1) & 1);
      const bool masked = (key >= a.kv_limit) | (a.causal & (key > row));
      s[i] = masked ? -INFINITY : (kAnyScale ? s[i] * a.sl2 : s[i]);
    }
  }
  const float mul = kAnyScale ? 1.f : a.sl2;  // the factor from s to log2 units
  // four independent chains per row for the max and the sum
  float mc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mc[r][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i)
    mc[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mc[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float mx[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(mc[r][0], mc[r][1]), fmaxf(mc[r][2], mc[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * mul);  // masked logits: -inf, m[r] stays
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= corr[r];
  }
  float lc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if (a.dropout) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ex2(fmaf(s[i], mul, neg_m[r]));
      lc[r][(i >> 2) & 3] += p;
      const int key = j0 + 8 * (i >> 2) + 2 * a.t4 + (i & 1);
      s[i] = port::keep_elem((uint32_t)(a.row0 + 8 * r), (uint32_t)key, (uint32_t)a.S, a.h_mix,
                             a.seed, a.thresh)
                 ? p * a.keep_scale
                 : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      s[i] = ex2(fmaf(s[i], mul, neg_m[(i >> 1) & 1]));
      lc[(i >> 1) & 1][(i >> 2) & 3] += s[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += (lc[r][0] + lc[r][1]) + (lc[r][2] + lc[r][3]);
}

// P (in s) -> bf16 A registers: the accumulator's columns 16 c .. 16 c + 15
// are the c-th 16-deep step
template <int BKV>
__device__ __forceinline__ void p_to_a(const float (&s)[BKV / 2], uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c) {
    pa[c][0] = port::pack_bf16x2(s[8 * c], s[8 * c + 1]);
    pa[c][1] = port::pack_bf16x2(s[8 * c + 2], s[8 * c + 3]);
    pa[c][2] = port::pack_bf16x2(s[8 * c + 4], s[8 * c + 5]);
    pa[c][3] = port::pack_bf16x2(s[8 * c + 6], s[8 * c + 7]);
  }
}

// A work tile: BQ queries of one (batch, q-head), the last query tiles
// first (under `causal` they see the most keys), and its key tiles.
struct Work {
  int q0, bh, b, h, hkv, kv_limit, n_tiles;
};

template <int BQ, int BKV>
__device__ __forceinline__ Work work_tile(int w, int n_qt, int BH, int T, int S, int Hq, int Hkv,
                                          int causal, const int32_t* kv_lens) {
  Work t;
  t.bh = w % BH;
  t.q0 = (n_qt - 1 - w / BH) * BQ;
  t.b = t.bh / Hq;
  t.h = t.bh % Hq;
  t.hkv = t.h / (Hq / Hkv);
  t.kv_limit = kv_lens != nullptr ? min(S, max(0, kv_lens[t.b])) : S;
  t.n_tiles = (t.kv_limit + BKV - 1) / BKV;
  if (causal) t.n_tiles = min(t.n_tiles, (min(t.q0 + BQ, T) - 1) / BKV + 1);  // keys <= last query
  return t;
}

template <int D, bool kAnyScale>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,  // q (B, T, Hq, D) as (D, Hq, T, B)
    const __grid_constant__ CUtensorMap k_map,  // k (B, S, Hkv, D) as (D, Hkv, S, B)
    const __grid_constant__ CUtensorMap v_map,  // v, as k
    __nv_bfloat16* __restrict__ out,            // (B, T, Hq, D)
    float* __restrict__ lse,                    // (B * Hq, T) or null
    const int32_t* __restrict__ kv_lens,        // (B,) or null
    int B, int T, int S, int Hq, int Hkv, float scale, int causal, int dropout, uint32_t seed,
    uint32_t bh0, int32_t thresh, float keep_scale) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV, STAGES = C::STAGES, NWG = C::NWG, BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);  // 2 buffers
  unsigned char* sKV = sQ + 2 * C::Q_BYTES;  // stage st: k at st * STAGE, v KV_TILE further
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;  // 2
  uint64_t* q_empty = q_full + 2;     // 2

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (T + BQ - 1) / BQ, BH = B * Hq, n_work = n_qt * BH;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      port::mbar_init(&full[i], 1);
      port::mbar_init(&empty[i], 4 * NWG);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      port::mbar_init(&q_full[i], 1);
      port::mbar_init(&q_empty[i], 4 * NWG);
    }
    port::fence_mbar_init();
  }
  __syncthreads();

  // The block walks work tiles blockIdx.x, + gridDim.x, ...; `lt` counts
  // those with keys (q buffer lt % 2), `it` their key tiles (ring stage it %
  // STAGES), on both sides of the ring alike.
  if (warp >= 4 * NWG) {  // the producer warpgroup: lane 0 of its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * NWG && lane == 0) {
      port::prefetch_tensor_map(&q_map);
      port::prefetch_tensor_map(&k_map);
      port::prefetch_tensor_map(&v_map);
      int lt = 0, it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work t = work_tile<BQ, BKV>(w, n_qt, BH, T, S, Hq, Hkv, causal, kv_lens);
        if (t.n_tiles == 0) continue;
        const int qb = lt & 1;
        if (lt >= 2) port::mbar_wait(&q_empty[qb], ((lt >> 1) - 1) & 1);
        port::mbar_arrive_expect_tx(&q_full[qb], C::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          port::tma_load_4d(sQ + qb * C::Q_BYTES + cb * BQ * 128, &q_map, &q_full[qb], cb * 64,
                            t.h, t.q0, t.b);
        ++lt;
        for (int j = 0; j < t.n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) port::mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
          port::mbar_arrive_expect_tx(&full[st], C::STAGE);
          unsigned char* kt = sKV + st * C::STAGE;
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) {
            port::tma_load_4d(kt + cb * BKV * 128, &k_map, &full[st], cb * 64, t.hkv, j * BKV,
                              t.b);
            port::tma_load_4d(kt + C::KV_TILE + cb * BKV * 128, &v_map, &full[st], cb * 64,
                              t.hkv, j * BKV, t.b);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS) : "memory");
  const int wg = warp >> 2;  // consumer warpgroup
  Rows rows;
  rows.t4 = lane & 3;
  rows.causal = causal;
  rows.dropout = dropout;
  rows.S = S;
  rows.sl2 = scale * kLog2e;
  rows.seed = seed;
  rows.thresh = thresh;
  rows.keep_scale = keep_scale;
  int lt = 0, it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const Work t = work_tile<BQ, BKV>(w, n_qt, BH, T, S, Hq, Hkv, causal, kv_lens);
    rows.wg_row0 = t.q0 + wg * 64;
    rows.row0 = rows.wg_row0 + (warp & 3) * 16 + (lane >> 2);
    rows.kv_limit = t.kv_limit;
    rows.h_mix = (bh0 + (uint32_t)t.bh) * 0x9E3779B9u;
    float m_r[2] = {kNegInf, kNegInf};  // running max, log2 units
    float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    if (t.n_tiles > 0) {
      const int qb = lt & 1;
      const unsigned char* sQw = sQ + qb * C::Q_BYTES + wg * 64 * 128;  // this warpgroup's rows
      float s[BKV / 2];          // S, then P, of one key tile
      uint32_t pa[BKV / 16][4];  // P in bf16: the A registers of P v
      float corr[2];

      port::mbar_wait(&q_full[qb], (lt >> 1) & 1);
      port::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      port::wgmma_fence();
      issue_qk<D, BQ, BKV>(s, sQw, sKV + (it % STAGES) * C::STAGE);
      port::wgmma_commit();
      port::wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<BKV, kAnyScale>(s, m_r, l_r, corr, 0, rows);
      p_to_a<BKV>(s, pa);
      for (int j = 1; j < t.n_tiles; ++j) {
        const int cur = (it + j) % STAGES, prev = (it + j - 1) % STAGES;
        port::mbar_wait(&full[cur], ((it + j) / STAGES) & 1);
        fence_regs(o);
        fence_regs(pa);
        port::wgmma_fence();
        issue_qk<D, BQ, BKV>(s, sQw, sKV + cur * C::STAGE);
        port::wgmma_commit();
        issue_pv<D, BKV>(o, pa, sKV + prev * C::STAGE + C::KV_TILE);
        port::wgmma_commit();
        port::wgmma_wait<1>();  // S of tile j landed; P v of tile j - 1 runs on
        fence_regs(s);
        softmax_tile<BKV, kAnyScale>(s, m_r, l_r, corr, j * BKV, rows);
        port::wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) port::mbar_arrive(&empty[prev]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        p_to_a<BKV>(s, pa);
      }
      const int last = (it + t.n_tiles - 1) % STAGES;
      fence_regs(o);
      fence_regs(pa);
      port::wgmma_fence();
      issue_pv<D, BKV>(o, pa, sKV + last * C::STAGE + C::KV_TILE);
      port::wgmma_commit();
      port::wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) {
        port::mbar_arrive(&empty[last]);
        port::mbar_arrive(&q_empty[qb]);
      }
      ++lt;
      it += t.n_tiles;
    }

    // o[4 j + 2 r + e] = row row0 + 8 r, column 8 j + 2 t4 + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      l_r[r] = fmaxf(l_r[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rows.row0 + 8 * r;
      if (row >= T) continue;
      const float inv = 1.f / l_r[r];
      __nv_bfloat16* orow = out + (((size_t)t.b * T + row) * Hq + t.h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * rows.t4) =
            port::pack_bf16x2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (lse != nullptr && rows.t4 == 0)
        lse[(size_t)t.bh * T + row] =
            (m_r[r] == kNegInf ? kNegInf : m_r[r] * kLn2) + logf(l_r[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* kv_lens, int B, int T, int S, int Hq, int Hkv, float scale, int causal,
           int dropout, int seed, int bh0, int thresh, float keep_scale, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  // the shared-memory attribute is set, and the SM count read, once on
  // each device of the process
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  if (sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(flash_fwd_kernel<D, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    }
    if (e != cudaSuccess) return (int)e;
    const cudaError_t e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e2 != cudaSuccess) return (int)e2;
  }
  CUtensorMap q_map, k_map, v_map;
  int rc = port::encode_bthd_sw128(&q_map, q, B, T, Hq, D, BQ);
  if (rc == 0) rc = port::encode_bthd_sw128(&k_map, k, B, S, Hkv, D, C::BKV);
  if (rc == 0) rc = port::encode_bthd_sw128(&v_map, v, B, S, Hkv, D, C::BKV);
  if (rc != 0) return rc;
  const int n_work = (T + BQ - 1) / BQ * B * Hq;  // one block per SM walks the work tiles
  const auto kernel = scale > 0.f ? flash_fwd_kernel<D, false> : flash_fwd_kernel<D, true>;
  kernel<<<min(n_work, sms), C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      static_cast<const int32_t*>(kv_lens), B, T, S, Hq, Hkv, scale, causal, dropout,
      (uint32_t)seed, (uint32_t)bh0, (int32_t)thresh, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, Hq, D), k and v (B, S, Hkv, D) bf16 contiguous, 16-byte aligned
// -> out like q; lse (B * Hq, T) f32 when not null; kv_lens (B,) int32 when
// not null. dropout != 0 applies the keep mask (seed, thresh) and scales
// kept probabilities by keep_scale = 1 / (1 - rate); the mask hashes
// batch row b, head h as the flattened index bh0 + b * Hq + h (bh0: the
// first row's index in the global batch, times Hq).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const void* kv_lens, int B, int T, int S,
                                      int Hq, int Hkv, int D, float scale, int causal,
                                      int dropout, int seed, int bh0, int thresh,
                                      float keep_scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch<64>(q, k, v, out, lse, kv_lens, B, T, S, Hq, Hkv, scale, causal, dropout,
                      seed, bh0, thresh, keep_scale, st);
  }
  if (D == 128) {
    return launch<128>(q, k, v, out, lse, kv_lens, B, T, S, Hq, Hkv, scale, causal, dropout,
                       seed, bh0, thresh, keep_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
