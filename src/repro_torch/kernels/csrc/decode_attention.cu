// Ragged flash-decoding for Hopper (sm_90a): single-query GQA decode
// attention over a contiguous KV cache or a paged block pool, with the KV
// of each (row, kv head) split across the blocks of one thread-block
// cluster.
//
// Replaces the TPU kernels flash_decode_pallas and flash_decode_paged_pallas
// (repro/kernels/flash_attention/decode_attention.py).  Both C entry points
// below run ONE kernel body; they differ only in the functor that maps a
// (row b, split j) to the first token row of its K/V tile: b*S + j*bk for
// the contiguous cache (B, S, KV, D), table[b, j] * bs for the pool
// (num_blocks, bs, KV, D).  Because the body and every summation order are
// shared, paged output is bitwise equal to contiguous output at
// bk == block_size.
//
// What bounds it: bytes.  A decode step reads each live K/V row once and
// does 4*G*D operations per key (G = 3 on smollm-360m, 10 on
// recurrentgemma-2b), far below the card's ~295 operations per byte, so
// the floor is HBM bandwidth: 4.3 us for recurrentgemma-2b's 8 rows at
// head_dim 256.  The arithmetic is fp64 by contract (below): about 71 M
// fp64 multiply-adds there, some 4 us at the card's 33.5 TFLOP/s of fp64
// on all 132 SMs.  So what costs the time is latency and fill, and the
// design is about both:
//   * one cluster of up to 8 blocks per (row, kv head), each block a
//     contiguous range of the row's live splits; the grid is sized from the
//     host-known split count (lengths are never read to the host) and kept
//     resident in one wave (decode_attention.py: plan); a block with no
//     live split still meets the cluster barriers;
//   * each block streams its K tiles, then its V tiles, through a ring of
//     up to 4 cp.async stages; short splits are grouped into tiles of at
//     least 64 keys;
//   * both products run on the fp64 tensor cores (mma.m8n8k4.f64): the
//     operands come from registers, not from a shared-memory broadcast per
//     multiply-add, and each K or V element is widened to fp64 once.
//
// The combine is a replay, not a log-sum-exp merge.  The plain version
// (decode_attention.py) runs the online softmax split by split, and the
// kernel must reproduce its bits.  Every rounding of that recurrence
// depends on the running max only through m_j, the prefix max of the split
// maxima over splits 0..j.  Given m_j all of split j's terms are known:
//   p_j    = fp32(exp64(s - m_j))        corr_j = fp32(exp64(m_{j-1} - m_j))
//   sum_j  = fp32(sum64 p_j)             pv_j   = fp32(sum64 T(p_j) * V)
// so the splits run in parallel and only l = l*corr_j + sum_j and
// acc = acc*corr_j + pv_j, two round-to-nearest fp32 operations each,
// run in split order.  A rescale-and-sum merge of per-block partials would
// round other values.  The kernel runs in three phases:
//   1. scores s[g, t] = fp32(sum64 q.k) * scale, masked to -1e30, written
//      to the workspace; the block's maximum per query head;
//   2. cluster barrier; each block takes the prefix max of the lower
//      ranks' maxima through distributed shared memory, then walks its
//      splits in order: split max, m_j, p, corr_j, sum_j (p rounded to V's
//      type into shared memory) and pv_j, all written to the workspace;
//   3. cluster barrier; each block replays a slice of the G*D outputs over
//      the row's live splits in order and writes out = acc / max(l, 1e-30).
// Splits before the first live key (the paged window) are fully masked:
// the plain version gives them p = 1 against a prefix max of -1e30, and
// the first live split's corr = exp(-1e30 - m) = 0 wipes them exactly, so
// the kernel skips them.  Nothing depends on which block took a split or
// on the other rows, so a row's output is the same alone or in a batch,
// at any cluster size.
//
// Sizes and types: every head size D that is a multiple of 8 up to 256,
// groups of up to kMaxG = 16 query heads (two 8-row mma blocks), splits up
// to 256 keys, and q/K/V all bf16 or all fp32 (a template parameter).
// Shared memory holds the ring of K/V tiles with their score rows, q and
// the tile's p in fp64, and the maxima; rows are padded so that the rows an
// mma fragment reads at once fall on distinct banks.  The wrapper
// (decode_attention.py: plan, smem_bytes) picks the tile, the ring depth
// and the cluster size, and refuses what would not fit in 227 KB.  The fp32
// workspace (wrapper-allocated) holds, per (row, kv head, split), G score
// rows and G * (D + 2) partials; it stays in L2.
//
// Semantics copied exactly from the reference: lengths clamped to
// [1, max_len] (a length of 0 attends one key); masked scores are -1e30,
// not -inf; p is rounded to V's type before the P.V product; the final
// divide is by max(l, 1e-30); the paged window keeps k_idx >
// len - 1 - window.
//
// In bf16 it is bitwise equal to the plain version, so that the ABFT
// fingerprint (kernels/abft.py), which recomputes sampled rows on the
// plain version and compares within 1e-5 of the output's scale, never
// flags a clean step.  Summation order cannot be matched between this
// kernel and PyTorch's reductions, so every sum is made independent of its
// order instead: the q.k and p.V dot products and a split's sum of p
// accumulate in fp64, where the products of bf16 values (16 significant
// bits) add exactly, and round once to fp32; exp runs in fp64 and rounds
// once; the replay is explicit round-to-nearest fp32 multiplies and adds
// (no FMA contraction), as PyTorch's separate elementwise operations are.
// The tensor cores' fp64 sums are exact for the same reason, whatever
// order they add in.
// In fp32 the products (48 significant bits) are still exact in fp64 but
// a sum of up to 256 of them is not: kernel and plain version round fp64
// sums taken in other orders (relative error near 1e-16), so an fp32 score
// or output may differ by an ulp; they agree within 1e-6 of the output's
// scale, well inside the 1e-5 the ABFT fingerprint allows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxBk = 256;
constexpr int kMaxCluster = 8;

// p rounded to V's type before the P.V product (a no-op in fp32)
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct ContigRows {
  int S, bk;
  __device__ __forceinline__ long long operator()(int b, int j) const {
    return (long long)b * S + (long long)j * bk;
  }
};

struct PagedRows {
  const int* table;
  int n_blk, bs;
  __device__ __forceinline__ long long operator()(int b, int j) const {
    return (long long)table[(long long)b * n_blk + j] * bs;
  }
};

// The launch plan, chosen by the wrapper (decode_attention.py: plan):
// ts splits per K/V tile, `nbuf` ring stages, `cluster` blocks per
// (row, kv head).
struct Plan {
  int ts, nbuf, cluster;
};

struct Shape {
  int KV, G, D, bk, n_splits, max_len, window;
  float scale;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return ceil_div(a, b) * b; }
// the least stride >= bytes that is `mod` past a multiple of 128 bytes, so
// that the rows an mma fragment reads at once fall on distinct banks
__host__ __device__ inline int bank_stride(int bytes, int mod) {
  return round_up(bytes - mod, 128) + mod;
}

// Shared-memory layout, in bytes from the start (every piece a multiple
// of 16): nbuf K/V tiles of ts*bk rows (row_bytes apart) and their score
// rows (ts*G rows of bkp floats); q as fp64 (mt8 rows of qstride); the
// tile's p as fp64 (ts*mt8 rows of pstride); the tile's split and prefix
// maxima (3, ts, G floats); the per-warp and per-block maxima of kMaxG
// heads.  decode_attention.py: smem_bytes computes the same total.
struct Layout {
  int row_bytes, tile_bytes, score_bytes, q_bytes, p_bytes, split_bytes;
  int bkp, mt, mt8, qstride, pstride;
  size_t total;
  __host__ __device__ Layout(const Shape& s, const Plan& p, int itemsize) {
    row_bytes = bank_stride(s.D * itemsize, 16);
    tile_bytes = p.ts * s.bk * row_bytes;
    bkp = round_up(s.bk, 4);
    score_bytes = p.ts * s.G * bkp * 4;
    mt = ceil_div(s.G, 8);
    mt8 = 8 * mt;
    qstride = bank_stride(s.D * 8, 32) / 8;
    q_bytes = mt8 * qstride * 8;
    pstride = bank_stride(bkp * 8, 32) / 8;
    p_bytes = p.ts * mt8 * pstride * 8;
    split_bytes = round_up(3 * p.ts * s.G * 4, 16);
    total = (size_t)p.nbuf * (tile_bytes + score_bytes) + q_bytes + p_bytes + split_bytes +
            (size_t)(kWarps + 2) * kMaxG * 4;
  }
};

constexpr int kStamps = 6;  // per block, when the caller asks for them
constexpr int kBatch = 8;  // splits whose partials the replay loads at once
constexpr int kMaxStages = 4;
constexpr int kPvTiles = 4;  // 8-column tiles of one P.V work item

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// c += a * b on the fp64 tensor cores, one 8x8x4 tile per warp: lane l
// holds A[l/4][l%4], B[l%4][l/4] and C[l/4][2*(l%4) + {0, 1}].  Products of
// bf16 values and their sums are exact in fp64, so the tensor cores give
// the same bits as the plain version's fp64 sums in any order.
__device__ __forceinline__ void dmma(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}

template <typename T, class Rows>
__global__ void __launch_bounds__(kThreads, 3)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, float* __restrict__ ws, long long* stamps,
              Rows rows, Shape s, Plan plan) {
  // with `stamps`, thread 0 of each block records the device clock (ns) at
  // entry, after phase 1, the first barrier, phase 2, the second barrier
  // and exit
  auto stamp = [&](int i) {
    if (stamps != nullptr && threadIdx.x == 0)
      stamps[(size_t)blockIdx.x * kStamps + i] = global_ns();
  };
  stamp(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int G = s.G, D = s.D, bk = s.bk, KV = s.KV, n = s.n_splits;
  const int C = plan.cluster, ts = plan.ts, nbuf = plan.nbuf;
  const Layout lay(s, plan, sizeof(T));
  const int bkp = lay.bkp, mt = lay.mt, mt8 = lay.mt8, row_bytes = lay.row_bytes;
  const int qstride = lay.qstride, pstride = lay.pstride;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = smem;                                             // nbuf x tile
  float* scores = reinterpret_cast<float*>(smem + nbuf * lay.tile_bytes);  // nbuf x score tile
  double* qs = reinterpret_cast<double*>(
      smem + (size_t)nbuf * (lay.tile_bytes + lay.score_bytes));           // (mt8, qstride)
  double* ps = qs + lay.q_bytes / 8;                                       // (ts, mt8, pstride)
  float* sx = reinterpret_cast<float*>(ps + lay.p_bytes / 8);              // (ts, G) split max
  float* smp = sx + ts * G;                                                // (ts, G) m_{j-1}
  float* smj = smp + ts * G;                                               // (ts, G) m_j
  float* wmax = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sx) + lay.split_bytes);             // (kWarps, kMaxG)
  float* bmax = wmax + kWarps * kMaxG;                                     // (kMaxG,)
  float* mrun = bmax + kMaxG;                                              // (kMaxG,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fc = lane & 3;  // mma fragment row and column
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / C;  // b * KV + h
  const int b = pair / KV, h = pair % KV;
  const int len = min(max(lengths[b], 1), s.max_len);
  const int n_live = ceil_div(len, bk);
  // splits before the first live key (window >= 1) are fully masked and
  // wiped by the first live split's corr = 0; window 0 masks every key, and
  // then every split is walked, as the plain version walks them
  const int j0 = s.window > 0 ? max(0, len - s.window) / bk : 0;
  const int nl = n_live - j0;
  const int jb = j0 + (int)((long long)rank * nl / C);
  const int je = j0 + (int)((long long)(rank + 1) * nl / C);
  const int n_tiles = ceil_div(je - jb, ts);

  float* ws_scores = ws + (size_t)pair * n * G * bkp;  // (n, G, bkp)
  float* ws_parts = ws + (size_t)gridDim.x / C * n * G * bkp +
                    (size_t)pair * n * G * (D + 2);  // (n, [corr G, sum G, pv G*D])
  const size_t part = (size_t)G * (D + 2);

  // issue the cp.async copies of tile `i` of `phase` (0: K rows; 1: V rows
  // and their score rows) into ring stage `buf`
  const int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  auto load_tile = [&](int phase, int i, int buf) {
    const int jt = jb + i * ts, nts = min(ts, je - jt);
    if (nts <= 0) return;
    const T* src = phase == 0 ? k : v;
    unsigned char* dst = tiles + buf * lay.tile_bytes;
    for (int c = tid; c < nts * bk * CH; c += kThreads) {
      const int t = c / CH, dc = c % CH;
      const long long r = rows(b, jt + t / bk) + t % bk;
      cp_async16(dst + t * row_bytes + dc * 16,
                 reinterpret_cast<const unsigned char*>(src + (r * KV + h) * D) + dc * 16);
    }
    if (phase == 1) {
      float* sdst = scores + buf * (lay.score_bytes / 4);
      const float* ssrc = ws_scores + (size_t)jt * G * bkp;
      for (int c = tid; c < nts * G * bkp / 4; c += kThreads)
        cp_async16(sdst + c * 4, ssrc + c * 4);
    }
  };
  auto wait_tile = [&]() {  // this thread's copies of the oldest tile landed
    switch (nbuf) {
      case 4: cp_async_wait<3>(); break;
      case 3: cp_async_wait<2>(); break;
      case 2: cp_async_wait<1>(); break;
      default: cp_async_wait<0>();
    }
    __syncthreads();
  };

  // the first K tiles go out before q is staged (fp64, zero rows past G)
  for (int st = 0; st < nbuf - 1; ++st) {
    load_tile(0, st, st);
    cp_async_commit();
  }
  // q in 16-byte vectors, two per thread in flight at once
  constexpr int VEC = 16 / sizeof(T);
  const uint4* qv = reinterpret_cast<const uint4*>(q + (size_t)pair * G * D);
  for (int i0 = tid; i0 < G * D / VEC; i0 += 2 * kThreads) {
    uint4 raw[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (i0 + u * kThreads < G * D / VEC) raw[u] = __ldg(qv + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = (i0 + u * kThreads) * VEC;
      if (e < G * D) {
        const T* x = reinterpret_cast<const T*>(&raw[u]);
        double* dst = qs + (e / D) * qstride + e % D;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = (double)to_f32(x[i]);
      }
    }
  }
  for (int idx = G * D + tid; idx < mt8 * D; idx += kThreads)
    qs[(idx / D) * qstride + idx % D] = 0.0;

  // ---- phase 1: scores, and the block's maximum per query head ----------
  // S (G x keys) = Q (G x D) . K^T on the fp64 tensor cores: warp w takes
  // the tile's 8-key column blocks w, w + 8, ..., all of D for each
  float mx[2] = {kNegInf, kNegInf};  // heads fr and fr + 8
  for (int i = 0; i < n_tiles; ++i) {
    load_tile(0, i + nbuf - 1, (i + nbuf - 1) % nbuf);
    cp_async_commit();
    wait_tile();
    const int jt = jb + i * ts, nts = min(ts, je - jt), nkeys = nts * bk;
    const unsigned char* kt = tiles + (i % nbuf) * lay.tile_bytes;
    for (int nt = warp; nt * 8 < nkeys; nt += kWarps) {
      const int key = nt * 8 + fr;  // this lane's B column
      const T* krow = reinterpret_cast<const T*>(kt + min(key, nkeys - 1) * row_bytes);
      // two accumulator chains per head block, over alternate k-steps (D
      // is a multiple of 8), added at the end: exact for bf16, one fixed
      // order for fp32
      double acc[2][2][2] = {};
      for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int dk = d0 + 4 * hh + fc;
          const double bv = key < nkeys ? (double)to_f32(krow[dk]) : 0.0;
          dmma(acc[0][hh][0], acc[0][hh][1], qs[fr * qstride + dk], bv);
          if (mt > 1) dmma(acc[1][hh][0], acc[1][hh][1], qs[(fr + 8) * qstride + dk], bv);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int g = m * 8 + fr;
        if (m < mt && g < G) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int kk = nt * 8 + 2 * fc + x;  // this accumulator's key
            if (kk < nkeys) {
              const int js = kk / bk, tt = kk % bk;
              const int kidx = (jt + js) * bk + tt;
              bool live = kidx < len;
              if (s.window >= 0) live = live && (kidx > len - 1 - s.window);
              const double dot = acc[m][0][x] + acc[m][1][x];
              const float sc = live ? __fmul_rn((float)dot, s.scale) : kNegInf;
              mx[m] = fmaxf(mx[m], sc);
              ws_scores[(size_t)(jt + js) * G * bkp + g * bkp + tt] = sc;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  stamp(1);

  // the next phase's first tiles load while the block meets the cluster
  for (int st = 0; st < nbuf - 1; ++st) {
    load_tile(1, st, st);
    cp_async_commit();
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {  // over the four lanes that hold head m*8 + fr
    mx[m] = fmaxf(mx[m], __shfl_xor_sync(0xffffffffu, mx[m], 1));
    mx[m] = fmaxf(mx[m], __shfl_xor_sync(0xffffffffu, mx[m], 2));
  }
  if (fc == 0) {
    wmax[warp * kMaxG + fr] = mx[0];
    wmax[warp * kMaxG + 8 + fr] = mx[1];
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w * kMaxG + tid]);
    bmax[tid] = m;
  }
  cluster.sync();  // every block's maximum is published
  stamp(2);

  // ---- phase 2: prefix max of the lower ranks, then the split partials --
  if (tid < G) {
    float m = kNegInf;
    for (int r = 0; r < rank; ++r) m = fmaxf(m, *cluster.map_shared_rank(bmax + tid, r));
    mrun[tid] = m;
  }
  // a split's row of scores is taken by rl lanes (bk rounded up to a power
  // of two, at most a warp), so every row of the tile runs at once
  int rl = 1;
  while (rl < bk && rl < 32) rl <<= 1;
  const int rr = tid / rl, rlane = tid % rl, row_step = kThreads / rl;
  const int ntd = D / 8;  // 8-column tiles of the output
  const int pv_items_per_split = ceil_div(ntd, kPvTiles);
  for (int i = 0; i < n_tiles; ++i) {
    load_tile(1, i + nbuf - 1, (i + nbuf - 1) % nbuf);
    cp_async_commit();
    wait_tile();
    const int jt = jb + i * ts, nts = min(ts, je - jt);
    const float* stile = scores + (i % nbuf) * (lay.score_bytes / 4);
    const unsigned char* vt = tiles + (i % nbuf) * lay.tile_bytes;
    const int nrows = nts * G;  // row js * G + g

    for (int base = 0; base < nrows; base += row_step) {
      const int r = base + rr;
      float m = kNegInf;
      if (r < nrows) {
        const float* srow = stile + r * bkp;
        for (int t = rlane; t < bk; t += rl) m = fmaxf(m, srow[t]);
      }
      for (int o = rl >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (r < nrows && rlane == 0) sx[r] = m;
    }
    __syncthreads();
    if (tid < G) {  // m_j through the tile's splits in order
      float m = mrun[tid];
      for (int js = 0; js < nts; ++js) {
        smp[js * G + tid] = m;
        m = fmaxf(m, sx[js * G + tid]);
        smj[js * G + tid] = m;
      }
      mrun[tid] = m;
    }
    __syncthreads();
    for (int base = 0; base < nrows; base += row_step) {
      const int r = base + rr;
      double sum = 0.0;
      if (r < nrows) {
        const int js = r / G, g = r % G;
        const float m_new = smj[r];
        const float* srow = stile + r * bkp;
        double* prow = ps + (js * mt8 + g) * pstride;
        for (int t = rlane; t < bkp; t += rl) {
          float p = 0.f;  // zero past the split (the mma reads 4 keys at a time)
          if (t < bk) {
            p = (float)exp((double)__fsub_rn(srow[t], m_new));
            sum += (double)p;
          }
          prow[t] = (double)round_to(p, v);
        }
      }
      for (int o = rl >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (r < nrows && rlane == 0) {
        const int js = r / G, g = r % G;
        float* dst = ws_parts + (size_t)(jt + js) * part;
        dst[g] = (float)exp((double)__fsub_rn(smp[r], smj[r]));
        dst[G + g] = (float)sum;
      }
    }
    __syncthreads();

    // pv (G x D) = T(p) (G x bk) . V (bk x D) per split on the fp64 tensor
    // cores: a work item is one split and up to kPvTiles 8-column tiles
    for (int item = warp; item < nts * pv_items_per_split; item += kWarps) {
      const int js = item / pv_items_per_split;
      const int nt0 = (item % pv_items_per_split) * kPvTiles;
      const int ntn = min(kPvTiles, ntd - nt0);
      double acc[2][kPvTiles][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < kPvTiles; ++u) acc[m][u][0] = acc[m][u][1] = 0.0;
      const double* p0 = ps + (js * mt8 + fr) * pstride;
      for (int t0 = 0; t0 < bk; t0 += 4) {
        const int t = t0 + fc;  // this lane's A column and B row
        const double a0 = p0[t];
        const double a1 = mt > 1 ? p0[8 * pstride + t] : 0.0;
        const T* vrow = reinterpret_cast<const T*>(vt + (js * bk + min(t, bk - 1)) * row_bytes);
#pragma unroll
        for (int u = 0; u < kPvTiles; ++u) {
          if (u < ntn) {
            const double bv = t < bk ? (double)to_f32(vrow[(nt0 + u) * 8 + fr]) : 0.0;
            dmma(acc[0][u][0], acc[0][u][1], a0, bv);
            if (mt > 1) dmma(acc[1][u][0], acc[1][u][1], a1, bv);
          }
        }
      }
      float* dst = ws_parts + (size_t)(jt + js) * part + 2 * G;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int g = m * 8 + fr;
        if (m < mt && g < G) {
#pragma unroll
          for (int u = 0; u < kPvTiles; ++u) {
            if (u < ntn) {
              const int d = (nt0 + u) * 8 + 2 * fc;
              dst[g * D + d] = (float)acc[m][u][0];
              dst[g * D + d + 1] = (float)acc[m][u][1];
            }
          }
        }
      }
    }
    __syncthreads();
  }
  stamp(3);
  cp_async_wait<0>();  // no copy may be left in flight at exit
  cluster.sync();      // every split's partials are written
  stamp(4);

  // ---- phase 3: the ordered fp32 replay of a slice of the outputs -------
  T* orow = out + (size_t)pair * G * D;
  for (int o = rank * kThreads + tid; o < G * D; o += C * kThreads) {
    const int g = o / D, dd = o % D;
    float l = 0.f, a = 0.f;
    for (int j = j0; j < n_live; j += kBatch) {
      float cb[kBatch], sb[kBatch], pb[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u < n_live) {
          const float* src = ws_parts + (size_t)(j + u) * part;
          cb[u] = __ldcg(src + g);
          sb[u] = __ldcg(src + G + g);
          pb[u] = __ldcg(src + 2 * G + g * D + dd);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u < n_live) {
          l = __fadd_rn(__fmul_rn(l, cb[u]), sb[u]);
          a = __fadd_rn(__fmul_rn(a, cb[u]), pb[u]);
        }
      }
    }
    store(orow + o, __fdiv_rn(a, fmaxf(l, 1e-30f)));
  }
  stamp(5);
}

template <typename T, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* ws, long long ws_floats,
                   void* stamps, Rows rows, int B, Shape s, Plan p, cudaStream_t stream) {
  if (B < 1 || s.KV < 1 || s.G < 1 || s.G > kMaxG || s.bk < 1 || s.bk > kMaxBk ||
      s.D < 8 || s.D > kMaxD || s.D % 8 || s.n_splits < 1)
    return cudaErrorInvalidValue;
    if (p.ts < 1 || p.nbuf < 1 || p.nbuf > kMaxStages || p.cluster < 1 || p.cluster > kMaxCluster ||
      p.cluster > s.n_splits)
    return cudaErrorInvalidValue;
  const Layout lay(s, p, sizeof(T));
  const long long need =
      (long long)B * s.KV * s.n_splits * s.G * (lay.bkp + s.D + 2);
  if (ws_floats < need) return cudaErrorInvalidValue;
  auto kern = decode_kernel<T, Rows>;
  if (lay.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * s.KV * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<long long*>(stamps), rows, s, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class Rows>
cudaError_t dispatch(int fp32, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* ws, long long ws_floats,
                     void* stamps, Rows rows, int B, Shape s, Plan p,
                     cudaStream_t stream) {
  if (fp32)
    return launch<float>(q, k, v, lengths, out, ws, ws_floats, stamps, rows, B, s, p,
                         stream);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, ws, ws_floats, stamps, rows, B, s,
                               p, stream);
}

}  // namespace

// q (B, KV, G, D), k/v (B, S, KV, D), all bf16 (fp32 = 0) or all fp32
// (fp32 = 1), lengths (B,) int32 -> out (B, KV, G, D) in q's type; ws an
// fp32 workspace of ws_floats; stamps null, or kStamps int64 per block for
// the device clock at each phase's end; (ts, nbuf, cluster) the wrapper's
// plan
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* ws,
                            long long ws_floats, void* stamps, int B, int S, int KV, int G,
                            int D, int bk, int fp32, float scale, int ts,
                            int nbuf, int cluster, void* stream) {
  if (bk < 1 || S % bk) return cudaErrorInvalidValue;
  return dispatch(fp32, q, k, v, lengths, out, ws, ws_floats, stamps, ContigRows{S, bk}, B,
                  Shape{KV, G, D, bk, S / bk, S, -1, scale},
                  Plan{ts, nbuf, cluster}, static_cast<cudaStream_t>(stream));
}

// q (B, KV, G, D), pools (num_blocks, bs, KV, D) of q's type, tables
// (B, n_blk) and lengths (B,) int32 -> out (B, KV, G, D); window < 0 means
// none; ws, stamps and the plan as for flash_decode
extern "C" int flash_decode_paged(const void* q, const void* kpool,
                                  const void* vpool, const void* tables,
                                  const void* lengths, void* out, void* ws,
                                  long long ws_floats, void* stamps, int B, int n_blk, int bs,
                                  int KV, int G, int D, int window, int fp32,
                                  float scale, int ts, int nbuf, int cluster,
                                  void* stream) {
  PagedRows rows{static_cast<const int*>(tables), n_blk, bs};
  return dispatch(fp32, q, kpool, vpool, lengths, out, ws, ws_floats, stamps, rows, B,
                  Shape{KV, G, D, bs, n_blk, n_blk * bs, window, scale},
                  Plan{ts, nbuf, cluster}, static_cast<cudaStream_t>(stream));
}
