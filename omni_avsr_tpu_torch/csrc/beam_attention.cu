// Beam-decode attention over a shared prefix, an UNPERMUTED generated-token
// cache plus an ancestor table, and the current token: one step, all kv
// heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel `omni_avsr_tpu/ops/beam_attention.py::_kernel`
// (Pallas) and computes its function: for query beam k, the generated cache
// entry (row r, slot n) is live iff anc[b, k, n] == r and n < step; the
// prefix, the live generated keys and the beam's current token enter one
// joint f32 softmax (masked entries contribute exp(-inf) = 0, as the TPU
// kernel's note argues), then the value contraction.
//
// Bound: at the serving shapes (B 3, K 15, Hq 32 / Hkv 8, D 64, P 176,
// step 17) one launch reads under 1.5 MB of K/V once (0.4-0.8 us at 3.35
// TB/s) and does a few MFLOP: bytes, far below any launch's latency. What
// costs time is the length of the serial chain each SM walks, so the
// design keeps it short and spreads one (batch item, kv head) over several
// SMs.
//
// Design: the K * G query rows that share a kv head's keys (60 at
// serving, padded to 64; larger groups in chunks of 64) are scored
// together, 16 rows per warp, on tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulators; q stays in A fragments for the whole launch). Their key
// list is [prefix P | generated K * step | current K]: the generated part
// is scored as the TPU kernel scores it, every row r < K at every slot n <
// step against every query row, masked by anc[b, k, n] == r, and not by
// gathering each beam's chain, so all rows share one B operand and each
// live cache row is read once for all beams; the current tokens are K keys,
// each live for its own beam only. The keys are cut into 64-key tiles and
// the tiles split over the S blocks of a thread-block cluster (flash-
// decoding): S is planned per call (`ops/beam_attention.py::plan_splits`),
// so that B * Hkv * S blocks fill the card also at K 1 and B 1. Each block
// stages its tiles in shared memory with cp.async (double-buffered; a tile
// of the prefix is read once for all K * G rows; the tile's keys carry a
// 64-bit mask of the beams they are live for, so a mask costs one shift),
// keeps an online softmax per row, and leaves its partial (max, sum, acc)
// in shared memory; after a cluster barrier each block merges a 1/S share
// of the rows, reading the S partials through distributed shared memory in
// one round of loads, and stores them. One launch, no scratch in device
// memory, nothing encoded or allocated per call on the host.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF, in log2 units here
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;     // query rows per block: 4 warps of 16
constexpr int kKeys = 64;     // keys per tile
constexpr int kThreads = 128;
constexpr int kMaxSplits = 8;  // the portable cluster size
// Key codes: the prefix (live, with its bias), a generated entry (n << 8 |
// r: live iff anc[b, beam, n] == r), a current token (-2 - beam: live for
// that beam only), past the key list (never live).
constexpr int kPrefix = -1;
constexpr int kNone = INT32_MIN;

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;           // bf16 per K or V row in shared memory
  static constexpr int TILE = kKeys * LD;    // bf16 per K or V tile
  static constexpr int CHUNKS = D / 8;       // 16-byte copies per row
  static constexpr int ACC_LD = D + 4;       // f32 per row of the partial acc
  static constexpr size_t KV_BYTES = 2 * 2 * TILE * sizeof(__nv_bfloat16);  // 2 stages x (K, V)
  static constexpr size_t META_BYTES = 2 * kKeys * (sizeof(int) + sizeof(float));
  static constexpr size_t ML_BYTES = 2 * kRows * sizeof(float) + kKeys * sizeof(uint64_t);
  static_assert(kRows * ACC_LD * sizeof(float) <= KV_BYTES, "partials alias the K/V stages");
  static size_t smem(int K, int N) {
    return KV_BYTES + META_BYTES + ML_BYTES + (size_t)K * (N + 1) * 4;  // beams' rows padded
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte global -> shared copy
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(port::smem_addr(dst)), "l"(src));
}

struct Args {
  const __nv_bfloat16* q;   // (B*K, Hq, D)
  const __nv_bfloat16* pk;  // (B, Hkv, P, D)
  const __nv_bfloat16* pv;
  const __nv_bfloat16* gk;  // (B, Hkv, K, N, D)
  const __nv_bfloat16* gv;
  const __nv_bfloat16* kc;  // (B*K, Hkv, D)
  const __nv_bfloat16* vc;
  const float* prefix_bias;  // (B, P)
  const int32_t* anc;        // (B, K, N)
  __nv_bfloat16* out;        // (B*K, Hq, D)
  int K, G, Hkv, P, N, step;
  float scale;
};

// Copies key tile `tile` of (b, h) into stage buffers sk, sv (zeros past
// the key list) and each key's code and bias (the prefix's by cp.async, so
// that no load stalls the thread before the copies of q and the ancestor
// table are issued).
template <int D>
__device__ __forceinline__ void load_tile(const Args& a, int b, int h, int tile, int T,
                                          __nv_bfloat16* sk, __nv_bfloat16* sv, int* code,
                                          float* bias) {
  using C = Cfg<D>;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * a.Hkv + h;
  const int gen_end = a.P + a.K * a.step;
#pragma unroll
  for (int i = 0; i < kKeys * C::CHUNKS / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int key = idx / C::CHUNKS, c = idx % C::CHUNKS;
    const int j = tile * kKeys + key;
    const __nv_bfloat16* krow = a.pk;
    const __nv_bfloat16* vrow = a.pv;
    int kcode = kNone;
    if (j < a.P) {
      const size_t off = (bh * a.P + j) * D;
      krow = a.pk + off;
      vrow = a.pv + off;
      kcode = kPrefix;
      if (c == 0) cp_async4(bias + key, a.prefix_bias + (size_t)b * a.P + j);
    } else if (j < gen_end) {
      const int jj = j - a.P, r = jj / a.step, n = jj - r * a.step;
      const size_t off = ((bh * a.K + r) * a.N + n) * D;
      krow = a.gk + off;
      vrow = a.gv + off;
      kcode = (n << 8) | r;
    } else if (j < T) {
      const int beam = j - gen_end;
      const size_t off = (((size_t)b * a.K + beam) * a.Hkv + h) * D;
      krow = a.kc + off;
      vrow = a.vc + off;
      kcode = -2 - beam;
    }
    const bool ok = kcode != kNone;
    port::cp_async16(sk + key * C::LD + c * 8, krow + c * 8, ok);
    port::cp_async16(sv + key * C::LD + c * 8, vrow + c * 8, ok);
    if (c == 0) {
      code[key] = kcode;
      if (kcode != kPrefix) bias[key] = 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) beam_attention_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* skv = reinterpret_cast<__nv_bfloat16*>(smem);  // stage s: K at 2 s TILE, V after
  int* codes = reinterpret_cast<int*>(smem + C::KV_BYTES);      // 2 x kKeys
  float* biases = reinterpret_cast<float*>(codes + 2 * kKeys);  // 2 x kKeys
  float* part_m = biases + 2 * kKeys;                           // kRows
  float* part_l = part_m + kRows;                               // kRows
  uint64_t* beams = reinterpret_cast<uint64_t*>(part_l + kRows);  // kKeys: the tile's live beams
  int* anc_s = reinterpret_cast<int*>(beams + kKeys);              // K x (N + 1)
  float* part_acc = reinterpret_cast<float*>(smem);  // kRows x ACC_LD, over the stages at the end

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, rank = blockIdx.x;  // the cluster spans gridDim.x
  const int h = blockIdx.y % a.Hkv, chunk = blockIdx.y / a.Hkv, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int Hq = a.Hkv * a.G, R = a.K * a.G;
  const int row_base = chunk * kRows;                   // the chunk's first query row
  const int rows = min(kRows, R - row_base);            // its valid rows
  const int T = a.P + a.K * a.step + a.K;               // the key list
  const int n_tiles = (T + kKeys - 1) / kKeys;
  const int t_begin = rank * n_tiles / S, t_end = (rank + 1) * n_tiles / S;

  // the first tile's copies, then the ancestor table of batch item b (the
  // generated keys' masks) and q while they are in flight
  if (t_begin < t_end) {
    load_tile<D>(a, b, h, t_begin, T, skv, skv + C::TILE, codes, biases);
    port::cp_async_commit();
  }
  for (int i = tid; i < a.K * a.N; i += kThreads) {
    const int k = i / a.N;
    cp_async4(anc_s + k * (a.N + 1) + i - k * a.N, a.anc + (size_t)b * a.K * a.N + i);
  }
  port::cp_async_commit();

  // This thread's two query rows (warp's 16: g8 and g8 + 8): q as mma A
  // fragments for the whole launch, their beams for the masks.
  const bool warp_live = warp * 16 < rows;
  uint32_t qa[D / 16][4];
  int beam[2];
  size_t q_off[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_base + warp * 16 + g8 + 8 * r;
    const bool ok = i < R;
    beam[r] = ok ? i / a.G : 0;
    q_off[r] = ok ? (((size_t)b * a.K + beam[r]) * Hq + (size_t)h * a.G + i % a.G) * D : 0;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1, d = kk * 16 + 2 * t4 + 8 * (e >> 1);
      const bool ok = row_base + warp * 16 + g8 + 8 * r < R;
      qa[kk][e] = ok ? *reinterpret_cast<const uint32_t*>(a.q + q_off[r] + d) : 0u;
    }
  }

  float m_r[2] = {kMasked, kMasked};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {  // the next tile into the other stage
      const int nx = st ^ 1;
      load_tile<D>(a, b, h, t + 1, T, skv + 2 * nx * C::TILE, skv + (2 * nx + 1) * C::TILE,
                   codes + nx * kKeys, biases + nx * kKeys);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();  // tile t and its codes are in shared memory
    // each key's beams: bit k set iff the key is live for query beam k
    if (tid < kKeys) {
      const int c = codes[st * kKeys + tid];
      uint64_t bits = 0;
      if (c == kPrefix) {
        bits = ~0ull;
      } else if (c >= 0) {
        const int n = c >> 8, r = c & 255;
#pragma unroll 4
        for (int k = 0; k < a.K; ++k) bits |= (uint64_t)(anc_s[k * (a.N + 1) + n] == r) << k;
      } else if (c != kNone) {
        bits = 1ull << (-2 - c);
      }
      beams[tid] = bits;
    }
    __syncthreads();
    const __nv_bfloat16* sk = skv + 2 * st * C::TILE;
    const __nv_bfloat16* sv = sk + C::TILE;
    const float* bias = biases + st * kKeys;

    if (warp_live) {
      // S = q k^T: s[nt] = 16 rows x keys 8 nt .. 8 nt + 7
      float s[kKeys / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kKeys / 16; ++np) {
          uint32_t r[4];
          const int key = np * 16 + (lane >> 4) * 8 + (lane & 7);
          port::ldmatrix_x4(r, sk + key * C::LD + kk * 16 + ((lane >> 3) & 1) * 8);
          port::mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
          port::mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
        }
      }
      // masks and the online softmax; s[nt][e]: row g8 + 8 (e >> 1), key
      // 8 nt + 2 t4 + (e & 1)
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = nt * 8 + 2 * t4 + (e & 1);
          const bool live = (beams[key] >> beam[e >> 1]) & 1;
          s[nt][e] = live ? fmaf(s[nt][e], a.scale, bias[key]) * kLog2e : kMasked;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = ex2(m_r[r] - m_new);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = ex2(s[nt][e] - m_r[e >> 1]);
          lsum[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + lsum[r];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= corr[e >> 1];
      // O += P v, P rounded to bf16 (the TPU kernel's MXU dot does so)
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t pa[4];
        pa[0] = port::pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);
        pa[1] = port::pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);
        pa[2] = port::pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
        pa[3] = port::pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t r[4];
          const int key = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          port::ldmatrix_x4_trans(r, sv + key * C::LD + dp * 16 + (lane >> 4) * 8);
          port::mma_bf16(o[2 * dp], pa, r[0], r[1]);
          port::mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The block's partial: row max, row sum and unnormalised acc per row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = warp * 16 + g8 + 8 * r;
    if (t4 == 0) {
      part_m[row] = m_r[r];
      part_l[row] = l_r[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(part_acc + row * C::ACC_LD + dt * 8 + 2 * t4) =
          make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
  }
  cluster.sync();  // every block's partial is in its shared memory

  // Block `rank` merges rows rank, rank + S, ... of the chunk, 4 columns a
  // thread at a time, from the S partials.
  const int mine = rows > rank ? (rows - rank + S - 1) / S : 0;
  for (int item = tid; item < mine * (D / 4); item += kThreads) {
    const int row = rank + S * (item / (D / 4)), d = (item % (D / 4)) * 4;
    float ms[kMaxSplits], ls[kMaxSplits];
    float4 vs[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {  // one round of remote loads
      if (s < S) {
        ms[s] = *cluster.map_shared_rank(part_m + row, s);
        ls[s] = *cluster.map_shared_rank(part_l + row, s);
        vs[s] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part_acc + row * C::ACC_LD + d, s));
      }
    }
    float M = kMasked;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < S) M = fmaxf(M, ms[s]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < S) {
        const float w = ex2(ms[s] - M);
        L = fmaf(w, ls[s], L);
        acc.x = fmaf(w, vs[s].x, acc.x);
        acc.y = fmaf(w, vs[s].y, acc.y);
        acc.z = fmaf(w, vs[s].z, acc.z);
        acc.w = fmaf(w, vs[s].w, acc.w);
      }
    }
    const float inv = 1.f / L;
    const int i = row_base + row;
    const int bm = i / a.G;
    const size_t off = (((size_t)b * a.K + bm) * Hq + (size_t)h * a.G + i % a.G) * D + d;
    uint2 packed;
    packed.x = port::pack_bf16x2(acc.x * inv, acc.y * inv);
    packed.y = port::pack_bf16x2(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(a.out + off) = packed;
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int D>
int launch(const Args& a, int B, int splits, cudaStream_t stream) {
  using C = Cfg<D>;
  const size_t smem = C::smem(a.K, a.N);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  // the shared-memory limit is raised once on each device of the process
  constexpr int kMaxDevices = 64;
  static size_t smem_set[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 != cudaSuccess) return (int)e0;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = smem;
  }
  const int chunks = (a.K * a.G + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv * chunks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, beam_attention_kernel<D>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B*K, Hq, D), pk and pv (B, Hkv, P, D), gk and gv (B, Hkv, K, N, D),
// k_cur and v_cur (B*K, Hkv, D) bf16 contiguous and 16-byte aligned,
// prefix_bias (B, P) f32, anc (B, K, N) int32 -> out like q. The key list
// is split over `splits` (1..8) blocks of a cluster. K is at most 64 (a
// key's live beams are one 64-bit mask).
extern "C" int beam_attention_launch(
    const void* q, const void* pk, const void* pv, const void* gk,
    const void* gv, const void* kc, const void* vc, const void* prefix_bias,
    const void* anc, void* out, int B, int K, int G, int Hkv, int P, int N,
    int D, int step, float scale, int splits, void* stream) {
  if (B <= 0 || K <= 0 || K > 64 || G <= 0 || Hkv <= 0 || P < 0 || N <= 0 || step < 0 ||
      step > N || splits < 1 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pk),
               static_cast<const __nv_bfloat16*>(pv), static_cast<const __nv_bfloat16*>(gk),
               static_cast<const __nv_bfloat16*>(gv), static_cast<const __nv_bfloat16*>(kc),
               static_cast<const __nv_bfloat16*>(vc), static_cast<const float*>(prefix_bias),
               static_cast<const int32_t*>(anc), static_cast<__nv_bfloat16*>(out),
               K, G, Hkv, P, N, step, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, splits, s);
  if (D == 128) return launch<128>(a, B, splits, s);
  return (int)cudaErrorInvalidValue;
}
