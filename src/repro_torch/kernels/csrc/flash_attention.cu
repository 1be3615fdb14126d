// Flash attention for Hopper (sm_90a): causal or sliding-window GQA
// attention of a block of queries over a key/value sequence, with an
// online softmax, for prefill and for cached chunks.
//
// Replaces the TPU kernel flash_attention_pallas (repro/kernels/
// flash_attention/flash_attention.py; the static _flash_kernel and the
// dynamic _flash_kernel_dyn, which share _update).  What it computes, per
// query head row (b, hq) with K/V head hk = hq / G (GQA inside the kernel:
// K and V are never repeated G-fold) and per query t at absolute position
// qp = q_offset + t:
//
//   s[t, k] = fp32(q_t . k_k) * scale           (scale = 1/sqrt(D), after the product)
//   live    = k < kv_live  and (causal: qp >= k)  and (window: qp - k < window)
//   s       = live ? s : -1e30                    (finite, as the reference masks)
//   online softmax over the visited keys k < n_visit, in tiles:
//     m' = max(m, max_k s); p = exp(s - m'); c = exp(m - m')
//     l  = l * c + sum_k p;  acc = acc * c + round_to_V(p) . V;  m = m'
//   out = acc / max(l, 1e-30), cast to q's type.
//
// The visited set is the reference's, so a row with no live key gets what
// the reference gives it: every visited key then has p = exp(0) = 1, and
// the row is the mean of the visited V rows, zero rows of the reference's
// block padding included.  The static variant visits the keys up to Tk
// rounded up to the reference's bk; the dynamic one those up to kv_len
// rounded up to bk (it skips the dead blocks j * bk >= kv_len).  The
// wrapper passes that bound as n_visit; keys in [Tk, n_visit) read as zero
// rows, keys past n_visit score -inf and add nothing.  For a row that has a
// live key, a tile with no live key adds exactly nothing: before the row's
// first live tile its sums are wiped by c = exp(-1e30 - m') = 0, after it
// its p are exp(-1e30 - m) = 0.  So when every row of a query tile has a
// live key, the block walks only the tiles that hold a live key of some row
// (the causal diagonal, the sliding window) and the result is bitwise what
// walking every tile gives; a tile with a dead row walks all visited keys.
//
// Layout: q and out are (B, Hq, Tq, D) views, k and v (B, KV, Tk, D) views,
// each with its own element strides for the first three axes and the head
// axis contiguous, so the reference's (B, T, KV, G, D) / (B, T, KV, D)
// arrays are read and written in place (no split-heads or padding copies).
// q_offset, kv_live and n_visit are run-time arguments: no build per length.
//
// What bounds it: operations.  At the prefill shapes of the served models
// (T of 1024-4096, D of 64-256) the two products do 4*D flops per live
// (query, key) pair against 2*D*2 bytes per key read once, hundreds of
// flops per byte, above the card's ~295 ridge; at D = 64 the softmax
// (one exp per pair, and its max and sum) takes longer than the products.
// So the bf16 body keeps the tensor cores fed, takes loads and stores off
// the threads and hides the softmax behind products:
//   * warp roles: three warpgroups.  One producer thread (warpgroup 0,
//     24 registers after setmaxnreg) issues every TMA load: a 128-query Q
//     tile, then its key tiles into a ring of 2-4 stages, K and V each
//     with its own full mbarrier (S can start while V lands) and one empty
//     mbarrier a stage that the consumers' eight warps release.  Two
//     consumer warpgroups (240 registers) own 64 query rows each.  The
//     waits do not trap: with a trap in the kernel ptxas holds every
//     warpgroup to the launch bound's 168 registers;
//   * persistent: one block per SM walks query tiles (longest rows first,
//     the rounds snaking over the blocks), and the ring's counter runs on
//     across them, so the next tile's Q and keys load while this one
//     finishes; at D <= 128 Q is freed once a tile's last S is done;
//   * TMA reads the strided views in place through 4-D tensor maps (the
//     64-column panel, then the head, sequence and batch axes in the order
//     of their strides), 128-byte swizzle; its zero fill supplies the rows
//     past Tq and Tk (the reference's padded keys in [Tk, n_visit)) and
//     the columns past D;
//   * S = Q K^T on wgmma m64nBKVk16 with both operands in shared memory,
//     K-major (D contiguous); all D/16 depth steps behind one fence, one
//     commit group;
//   * the online softmax runs on the S accumulator registers in the log2
//     domain (exp as exp2 of the scaled score), with branch-free masks
//     only on the tiles that cross the causal diagonal, the window edge,
//     kv_live or n_visit, maxima and sums as trees;
//   * O += P V on wgmma m64nNk16 (N = D rounded up to 64) with P rounded
//     to bf16 straight from the S registers (the accumulator's layout is
//     the A fragment's) and V through an N-major descriptor; O is
//     rescaled only once the previous P V group has been waited for.  At
//     D <= 64 each consumer issues S of the next key tile before P V of
//     this one, and the two consumers take turns to issue on named
//     barriers, so one's softmax runs while the other's products do;
//   * at D > 128 O leaves through the consumer's rows of the Q tile and a
//     TMA store, below it by the threads;
//   * tiles from D alone (plan(), mirrored in flash_attention.py): 128
//     queries, 128 keys up to D = 128 and 64 beyond, as many stages as fit
//     in 227 KB up to 4;
//   * each query tile is computed wholly by one block in key order, every
//     sum in one fixed order (shuffle butterflies within a row, tiles in
//     order), no split-KV and no atomics: repeat runs are bitwise.
// fp32 takes a second body, by dtype alone: the same walk on the CUDA
// cores in full fp32 (no TF32), one block of 4 warps per (row, 16-query
// tile), a warp per query, a lane per key for the scores and per column
// for P.V; its loads go through registers into one shared buffer between
// two __syncthreads.
// D is any multiple of 8 up to 256 in both bodies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;      // the fp32 body's block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qsb, qsh, qst;  // q (B, Hq, Tq, D), strides in elements
  long long ksb, ksh, kst;  // k (B, KV, Tk, D)
  long long vsb, vsh, vst;  // v (B, KV, Tk, D)
  long long osb, osh, ost;  // out (B, Hq, Tq, D)
  int Hq, G, Tq, Tk, D;
  int causal, window;       // window < 0: none
  int q_offset, kv_live, n_visit;
  int n_qt;                 // query tiles per head row
  float scale;
};

__device__ __forceinline__ bool live(int qp, int key, const Args& a) {
  return key < a.kv_live && (!a.causal || qp >= key) &&
         (a.window < 0 || qp - key < a.window);
}

// The first and last live key of the query at position qp (first > last:
// none); both grow with qp
__device__ __forceinline__ int first_live(int qp, const Args& a) {
  return a.window >= 0 ? max(0, qp - a.window + 1) : 0;
}
__device__ __forceinline__ int last_live(int qp, const Args& a) {
  return a.causal ? min(a.kv_live - 1, qp) : a.kv_live - 1;
}

// The tiles of bkv keys that the bq queries from q0 walk: those holding a
// live key of one of its queries when every query has one, else every
// visited tile.  A query's live keys are [first_live, last_live], both
// bounds grow with its position, and the positions whose interval is not
// empty form one interval, so every query has a live key when the first
// and the last query do.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int bq, int bkv, int& j0,
                                           int& j1) {
  const int qa = a.q_offset + q0, qb = a.q_offset + min(q0 + bq, a.Tq) - 1;
  int k0 = 0, k1 = a.n_visit;
  if (first_live(qa, a) <= last_live(qa, a) && first_live(qb, a) <= last_live(qb, a)) {
    k0 = first_live(qa, a);
    k1 = min(k1, last_live(qb, a) + 1);
  }
  j0 = k0 / bkv;
  j1 = k1 > 0 ? (k1 + bkv - 1) / bkv : 0;
}

// ------------------------------------------------------------- bf16 body --

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int TC_THREADS = 3 * WG;      // producer, two consumers
constexpr int TC_BQ = 128;              // queries of a block: 64 a consumer
constexpr int SMEM_LIMIT = 232448;      // 227 KB of dynamic shared memory
constexpr int MAX_STAGES = 4;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// The tiles and ring of the bf16 body, from D alone: 128 queries, BKV keys
// (128 while the 64-column panels of D are at most 2, else 64), as many
// stages of (K, V) as fit in 227 KB up to 4; shared memory holds the Q
// tile, the ring, the 1024-byte alignment of the swizzle atoms and the
// barriers.  Mirrored by flash_attention.py's plan().
struct Plan {
  int bq, bkv, stages, smem;
};

Plan plan(int D) {
  const int dp = (D + 63) / 64;
  Plan p;
  p.bq = TC_BQ;
  p.bkv = dp <= 2 ? 128 : 64;
  const int stage = 2 * dp * p.bkv * 128;
  const int fixed = dp * TC_BQ * 128 + 1024 + 8 * (2 + 3 * MAX_STAGES);
  p.stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) / stage);
  p.smem = fixed + p.stages * stage;
  return p;
}

// Where a tensor map puts the head, sequence and batch axes (dims 1-3;
// dim 0 is the 64-column panel of D), and whether the head and batch axes
// are read at their index (0: a broadcast axis of stride 0, read at 0)
struct Axes {
  int h, t, b, h_on, b_on;
};

struct TcArgs {
  Args a;
  Axes qx, kx, vx, ox;
  int stages;
  int n_bh;     // B * Hq head rows
  int n_tiles;  // n_bh * n_qt query tiles
};

// The query tile of a block's round k: tiles are ordered longest rows
// first (the last query tile of every head row, then the tiles before it;
// neighbours share K/V heads), and the rounds go alternately forward and
// backward over the blocks, so a block that took a long tile in one round
// takes a short one in the next.  Its key tiles [j0, j1) of bkv keys.
struct Tile {
  int b, hq, q0, j0, j1;
};

__device__ __forceinline__ Tile tile_of(const TcArgs& p, int k, int bkv) {
  const int tau = k * (int)gridDim.x +
                  ((k & 1) ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x);
  Tile t{0, 0, 0, 0, -1};  // j1 < 0: past the last tile
  if (tau >= p.n_tiles) return t;
  const int qt = p.a.n_qt - 1 - tau / p.n_bh, bh = tau % p.n_bh;
  t.b = bh / p.a.Hq;
  t.hq = bh % p.a.Hq;
  t.q0 = qt * TC_BQ;
  tile_range(p.a, t.q0, TC_BQ, bkv, t.j0, t.j1);
  return t;
}

// The coordinates (dims 1-3) of a map's box at head h, position t, batch b
struct Coords {
  int c1, c2, c3;
};

__device__ __forceinline__ Coords coords(const Axes& x, int h, int t, int b) {
  h = x.h_on ? h : 0;
  b = x.b_on ? b : 0;
  return {x.h == 1 ? h : x.t == 1 ? t : b, x.h == 2 ? h : x.t == 2 ? t : b,
          x.h == 3 ? h : x.t == 3 ? t : b};
}

// One TMA box of `map` (64 columns from `col`, the box's rows along the
// sequence axis from t) into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        const Axes& x, int col, int h, int t, int b) {
  const Coords k = coords(x, h, t, b);
  hopper::tma_load_4d(dst, map, bar, col, k.c1, k.c2, k.c3);
}

// The same box stored from shared memory at src
__device__ __forceinline__ void tma_box_store(const CUtensorMap* map, uint32_t src,
                                              const Axes& x, int col, int h, int t, int b) {
  const Coords k = coords(x, h, t, b);
  hopper::tma_store_4d(map, src, col, k.c1, k.c2, k.c3);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x to within an ulp (MUFU.RCP), without the IEEE division's call to
// its slow path
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for this consumer's 64 queries and the stage's BKV keys: KS
// depth steps of 16 behind one fence, one commit group.  dq and dk are
// the descriptors of the first step; a step moves 32 bytes inside the
// 128-byte rows, a panel of 64 columns moves rows x 128 bytes.
template <int BKV, int KS>
__device__ __forceinline__ void issue_s(float (&s)[BKV / 2], uint64_t dq, uint64_t dk) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    hopper::wgmma_ss<BKV>(s, dq + (kk / 4) * (TC_BQ * 128 >> 4) + 2 * (kk % 4),
                          dk + (kk / 4) * (BKV * 128 >> 4) + 2 * (kk % 4), kk > 0);
  hopper::wgmma_commit();
}

// O += P V: BKV / 16 key steps of m64nNk16, P from registers, V's N-major
// panels BKV x 128 bytes apart; one commit group
template <int N, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[N / 2], const uint32_t (&pf)[BKV / 16][4],
                                         uint32_t v_stage) {
  const uint64_t dv = hopper::desc_b128(v_stage, BKV * 128);
  hopper::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc) hopper::wgmma_rs<N>(o, pf[kc], dv + kc * (2048 >> 4));
  hopper::wgmma_commit();
}

// The online-softmax update of one tile on the S registers of this
// thread's two rows (s[4 j + 2 i + e]: row i, key kv0 + 8 j + t2 + e), in
// the log2 domain: y = s * scale * log2e, m2 the running max of y, so
// exp(s * scale - m) = exp2(y - m2).  A masked tile first rewrites s as y,
// with the image of the reference's -1e30 (kNegInf2) for a dead key of the
// row (outside [lo, hi]) and -inf past n_visit; an interior tile (every
// pair live) keeps the raw products, takes their max and scales it once
// (rounding is monotone: the same max as of the scaled products), and
// folds the scale into exp2's multiply-add.  Then corr = exp2(m2 - m2'),
// p = exp2(y - m2') in place, and this thread's share of the row sum l =
// l * corr + sum p (the 4 lanes of a row add their shares at the end).  A
// row that has seen no live key has m2 = kNegInf2, so its visited dead
// keys get p = exp2(0) = 1, as in the reference.  Maxima and sums run as
// trees of 4 in one fixed order.
constexpr float kNegInf2 = kNegInf * kLog2e;

template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m2)[2], float (&l)[2],
                                             float (&corr)[2], const Args& a, int kv0,
                                             const int (&lo)[2], const int (&hi)[2], int t2,
                                             bool masked) {
  const float sl = a.scale * kLog2e;
  if (masked) {
#pragma unroll
    for (int x = 0; x < BKV / 2; ++x) {
      const int i = (x >> 1) & 1, key = kv0 + 8 * (x >> 2) + t2 + (x & 1);
      const float y = __fmul_rn(s[x], sl);
      s[x] = key >= a.n_visit ? -INFINITY : (key >= lo[i]) & (key <= hi[i]) ? y : kNegInf2;
    }
  }
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) mx[i][r] = -INFINITY;
#pragma unroll
  for (int x = 0; x < BKV / 2; ++x) {
    float& acc = mx[(x >> 1) & 1][(x >> 2) & 3];
    acc = fmaxf(acc, s[x]);
  }
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if (!masked) v = __fmul_rn(v, sl);
    const float m_new = fmaxf(m2[i], v);
    corr[i] = ex2(m2[i] - m_new);
    m2[i] = m_new;
    mb[i] = -m_new;
  }
  const float c = masked ? 1.f : sl;
  float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int x = 0; x < BKV / 2; ++x) {
    const int i = (x >> 1) & 1;
    s[x] = ex2(fmaf(s[x], c, mb[i]));
    sum[i][(x >> 2) & 3] += s[x];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]),
                     __fadd_rn(__fadd_rn(sum[i][0], sum[i][1]), __fadd_rn(sum[i][2], sum[i][3])));
}

// P (bf16) as the A fragments of the P V steps: keys 16 kc .. 16 kc + 15
// are accumulator columns 8 (2 kc) .. 8 (2 kc + 1) + 7, whose registers
// s[8 kc .. 8 kc + 7] are the m16n8k16 A fragment in order
template <int BKV>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BKV / 16][4], const float (&s)[BKV / 2]) {
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) pf[kc][r] = pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N / 2], const float (&corr)[2]) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) o[x] = __fmul_rn(o[x], corr[(x >> 1) & 1]);
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o, const TcArgs p) {
  constexpr int BKV = DP <= 2 ? 128 : 64;
  constexpr int N = 64 * DP;  // P V width: D rounded up to 64
  constexpr uint32_t Q_PANEL = TC_BQ * 128, KV_PANEL = BKV * 128;
  constexpr uint32_t STAGE = 2 * DP * KV_PANEL;  // K panels, then V panels
  // The consumers' schedule, by D alone (measured: PERF.md, the flash steps).
  // At D <= 64, where the softmax's exps cost about as much as the
  // products, each consumer issues S of tile j + 1 before P V of tile j
  // (its softmax of one tile runs while the tensor cores do the other's
  // P V), and the two consumers take turns to issue on two named barriers
  // (one's softmax runs while the other's products do).  Beyond, each
  // consumer waits for S, runs the softmax, then P V: the overlap slowed
  // D = 240-256 by a third.
  constexpr bool OVERLAP = DP == 1, PINGPONG = DP == 1;
  // At D > 128 O leaves through the consumer's rows of the Q tile and a
  // TMA store (its 128-256 columns a row as scattered 4-byte stores held a
  // consumer ~7,000 cycles a tile); up to D = 128 the threads store it,
  // and Q is freed as soon as a tile's last S is done, so the next tile's
  // Q loads during the last softmax, P V and stores.
  constexpr bool TMA_STORE = DP >= 3;
  const Args& a = p.a;
  const int stages = p.stages;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;  // Q panels
  const uint32_t ring = base + DP * Q_PANEL;
  // barriers: Q full and empty, then kfull[s], vfull[s], empty[s]
  const uint32_t qfull = ring + stages * STAGE, qempty = qfull + 8, kfull = qempty + 8,
                 vfull = kfull + 8 * stages, empty = vfull + 8 * stages;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    // one arrival per consumer warp, or per consumer once TMA has read O
    hopper::mbar_init(qempty, TMA_STORE ? 2 : 8);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(kfull + 8 * s, 1);
      hopper::mbar_init(vfull + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // The block is persistent: it walks its tiles (tile_of) round by round,
  // and the ring's load counter n runs on across them, so the producer
  // loads the next tile's Q and keys while the consumers finish this one
  // and store it.  The warpgroup's role is warp-uniform to the compiler (a
  // broadcast from lane 0), so the registers setmaxnreg sets apply to each
  // role's code.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG, 0);
  if (wg == 0) {  // producer warpgroup: one thread issues every load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensor_map(&tm_q);
      hopper::prefetch_tensor_map(&tm_k);
      hopper::prefetch_tensor_map(&tm_v);
      int n = 0;
      for (int k = 0;; ++k) {
        const Tile t = tile_of(p, k, BKV);
        if (t.j1 < 0) break;
        const int hk = t.hq / a.G;
        if (k > 0) hopper::mbar_wait<false>(qempty, (k - 1) & 1);  // the last Q is free
        hopper::mbar_expect_tx(qfull, DP * Q_PANEL);
        for (int c = 0; c < DP; ++c)
          tma_box(base + c * Q_PANEL, &tm_q, qfull, p.qx, 64 * c, t.hq, t.q0, t.b);
        for (int j = t.j0; j < t.j1; ++j, ++n) {
          const int s = n % stages;
          hopper::mbar_wait<false>(empty + 8 * s, ((n / stages) & 1) ^ 1);
          const uint32_t ks = ring + s * STAGE, vs = ks + DP * KV_PANEL;
          hopper::mbar_expect_tx(kfull + 8 * s, DP * KV_PANEL);
          for (int c = 0; c < DP; ++c)
            tma_box(ks + c * KV_PANEL, &tm_k, kfull + 8 * s, p.kx, 64 * c, hk, j * BKV, t.b);
          hopper::mbar_expect_tx(vfull + 8 * s, DP * KV_PANEL);
          for (int c = 0; c < DP; ++c)
            tma_box(vs + c * KV_PANEL, &tm_v, vfull + 8 * s, p.vx, 64 * c, hk, j * BKV, t.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c (0, 1) owns query rows 64 c .. 64 c + 63 of a
  // tile; thread (warp w, lane) holds rows 16 w + lane / 4 (+ 8) of them
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1, tid = threadIdx.x - wg * WG;
  const int w = tid >> 5, lane = tid & 31, t2 = (lane & 3) * 2;
  const uint64_t dq = hopper::desc_k128(base + c * 64 * 128);

  // PINGPONG: consumer c issues on named barrier 1 + c, then hands the
  // turn to the other one's
  auto turn_begin = [&]() {
    if (PINGPONG) hopper::bar_sync(1 + c, 2 * WG);
  };
  auto turn_end = [&]() {
    if (PINGPONG) hopper::bar_arrive(2 - c, 2 * WG);
  };
  auto release = [&](uint32_t bar) {
    if (lane == 0) hopper::mbar_arrive(bar);
    __syncwarp();
  };

  if (PINGPONG && c == 1) hopper::bar_arrive(1, 2 * WG);  // consumer 0 issues first
  int n = 0;
  for (int k = 0;; ++k) {
    const Tile t = tile_of(p, k, BKV);
    if (t.j1 < 0) break;
    const int row0 = t.q0 + 64 * c + 16 * w + (lane >> 2);
    // the live keys of this thread's two rows: [lo, hi]
    const int lo[2] = {first_live(a.q_offset + row0, a), first_live(a.q_offset + row0 + 8, a)};
    const int hi[2] = {last_live(a.q_offset + row0, a), last_live(a.q_offset + row0 + 8, a)};
    // the consumer's first and last query position (rows past Tq are
    // never stored), for the test of tiles that need no mask
    const int wq_lo = a.q_offset + t.q0 + 64 * c;
    const int wq_hi = a.q_offset + min(t.q0 + 64 * c + 63, a.Tq - 1);
    auto interior = [&](int kv0) {
      return kv0 + BKV <= a.kv_live && kv0 + BKV <= a.n_visit &&
             (!a.causal || kv0 + BKV - 1 <= wq_lo) &&
             (a.window < 0 || wq_hi - kv0 < a.window);
    };

    // s, the S tile, is declared afresh for each key tile: no value of it
    // lives from one tile's product to the next
    float o[N / 2], m2[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int x = 0; x < N / 2; ++x) o[x] = 0.f;

    hopper::mbar_wait<false>(qfull, k & 1);
    if (!OVERLAP) {
      for (int j = t.j0; j < t.j1; ++j, ++n) {
        const int st = n % stages;
        const uint32_t ph = (n / stages) & 1, ks = ring + st * STAGE, vs = ks + DP * KV_PANEL;
        float s[BKV / 2];
        hopper::mbar_wait<false>(kfull + 8 * st, ph);
        turn_begin();
        issue_s<BKV, 4 * DP>(s, dq, hopper::desc_k128(ks));
        turn_end();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (!TMA_STORE && j + 1 == t.j1) release(qempty);  // the tile's last S is done
        softmax_tile<BKV>(s, m2, l, corr, a, j * BKV, lo, hi, t2, !interior(j * BKV));
        rescale<N>(o, corr);
        pack_p<BKV>(pf, s);
        hopper::mbar_wait<false>(vfull + 8 * st, ph);
        turn_begin();
        issue_pv<N, BKV>(o, pf, vs);
        turn_end();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) hopper::fence_regs(pf[kc]);
        release(empty + 8 * st);
      }
    } else if (t.j0 < t.j1) {
      // S of tile j + 1 goes out before P V of tile j; O is rescaled by the
      // previous tile's corr while S runs, after the P V before it was
      // waited for
      {
        const int st = n % stages;
        float s[BKV / 2];
        hopper::mbar_wait<false>(kfull + 8 * st, (n / stages) & 1);
        turn_begin();
        issue_s<BKV, 4 * DP>(s, dq, hopper::desc_k128(ring + st * STAGE));
        turn_end();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (!TMA_STORE && t.j0 + 1 == t.j1) release(qempty);
        softmax_tile<BKV>(s, m2, l, corr, a, t.j0 * BKV, lo, hi, t2, !interior(t.j0 * BKV));
        pack_p<BKV>(pf, s);
        ++n;
      }
      for (int j = t.j0 + 1; j < t.j1; ++j, ++n) {
        const int st = n % stages, pst = (n - 1) % stages;
        const uint32_t ks = ring + st * STAGE, pvs = ring + pst * STAGE + DP * KV_PANEL;
        float s[BKV / 2];
        hopper::mbar_wait<false>(kfull + 8 * st, (n / stages) & 1);
        turn_begin();
        issue_s<BKV, 4 * DP>(s, dq, hopper::desc_k128(ks));
        rescale<N>(o, corr);
        hopper::mbar_wait<false>(vfull + 8 * pst, ((n - 1) / stages) & 1);
        issue_pv<N, BKV>(o, pf, pvs);
        turn_end();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        if (!TMA_STORE && j + 1 == t.j1) release(qempty);
        softmax_tile<BKV>(s, m2, l, corr, a, j * BKV, lo, hi, t2, !interior(j * BKV));
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) hopper::fence_regs(pf[kc]);
        release(empty + 8 * pst);
        pack_p<BKV>(pf, s);
      }
      const int pst = (n - 1) % stages;
      rescale<N>(o, corr);
      hopper::mbar_wait<false>(vfull + 8 * pst, ((n - 1) / stages) & 1);
      turn_begin();
      issue_pv<N, BKV>(o, pf, ring + pst * STAGE + DP * KV_PANEL);
      turn_end();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) hopper::fence_regs(pf[kc]);
      release(empty + 8 * pst);
    }
    if (!TMA_STORE && t.j0 >= t.j1) release(qempty);  // no key tile: Q is free

    // out = o / max(l, 1e-30), as o times the reciprocal, l the sum of the
    // row's 4 lanes; accumulator register 4 j + 2 i + e is row i, column
    // 8 j + t2 + e
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = rcp(fmaxf(l[i], 1e-30f));
    }
    if (TMA_STORE) {
      // this consumer's 64 rows of the Q tile take O in bf16, laid out as
      // TMA reads them (column 8 j + t2: panel j / 8, 16-byte chunk j % 8
      // XOR row % 8); one thread stores them (rows past Tq and columns past
      // D are clipped), and once TMA has read them Q is free
      const uint32_t mine = base + c * 64 * 128;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * w + (lane >> 2) + 8 * i;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          hopper::st_shared_b32(
              mine + (j / 8) * Q_PANEL + r * 128 + (((j % 8) ^ (r % 8)) << 4) + 2 * t2,
              pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]));
      }
      hopper::fence_async_shared();
      hopper::bar_sync(3 + c, WG);
      if (tid == 0) {
        for (int cc = 0; cc < DP; ++cc)
          tma_box_store(&tm_o, mine + cc * Q_PANEL, p.ox, 64 * cc, t.hq, t.q0 + 64 * c, t.b);
        hopper::bulk_commit();
        hopper::bulk_wait<0, true>();
        hopper::mbar_arrive(qempty);
      }
    } else {
      bf16* O = static_cast<bf16*>(a.out) + t.b * a.osb + t.hq * a.osh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        if (r >= a.Tq) continue;
        bf16* orow = O + (long long)r * a.ost;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + t2;
          if (col < a.D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
        }
      }
    }
  }
  if (PINGPONG && c == 0) hopper::bar_sync(1, 2 * WG);  // consumer 1's last turn
  if (TMA_STORE && tid == 0) hopper::bulk_wait<0, false>();  // the stores are done
}

// A 4-D tensor map of a (B, H, T, D) bf16 view at element strides (sb, sh,
// st) for boxes of 64 columns x `rows` positions: dim 0 is D, then the
// head, sequence and batch axes in the order of their strides (an axis of
// size 1, or of stride 0, goes last as size 1 and is read at 0)
cudaError_t make_map(CUtensorMap* map, Axes* x, const void* ptr, int D, long long H,
                     long long T, long long B, long long sh, long long st, long long sb,
                     int rows) {
  const long long size[3] = {H, T, B}, stride[3] = {sh, st, sb};
  bool on[3];
  int order[3], n = 0;
  for (int i = 0; i < 3; ++i) {
    if (size[i] < 1 || stride[i] < 0 || (i == 1 && size[i] > 1 && stride[i] == 0))
      return cudaErrorInvalidValue;
    on[i] = size[i] > 1 && stride[i] > 0;
    if (on[i]) {
      int k = n++;
      for (; k > 0 && stride[order[k - 1]] > stride[i]; --k) order[k] = order[k - 1];
      order[k] = i;
    }
  }
  for (int i = 0; i < 3; ++i)
    if (!on[i]) order[n++] = i;
  uint64_t dims[4] = {(uint64_t)D, 1, 1, 1}, strides[3];
  uint32_t box[4] = {64, 1, 1, 1};
  int pos[3];
  uint64_t next = ((uint64_t)D * 2 + 15) / 16 * 16;
  for (int k = 0; k < 3; ++k) {
    const int i = order[k];
    dims[k + 1] = on[i] ? (uint64_t)size[i] : 1;
    strides[k] = on[i] ? (uint64_t)stride[i] * 2 : next;
    next = strides[k] * dims[k + 1];
    box[k + 1] = i == 1 ? (uint32_t)rows : 1;
    pos[i] = k + 1;
  }
  *x = Axes{pos[0], pos[1], pos[2], (int)on[0], (int)on[2]};
  return hopper::bf16_tensor_map(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DP>
cudaError_t launch_tc(const Args& a, int B, int KV, const Plan& pl, long long blocks,
                      cudaStream_t stream) {
  TcArgs p;
  p.a = a;
  p.stages = pl.stages;
  p.n_bh = B * a.Hq;
  p.n_tiles = (int)blocks;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)(blocks < sms ? blocks : sms);  // one resident block an SM
  CUtensorMap tq, tk, tv, to;
  if (e == cudaSuccess) e = make_map(&tq, &p.qx, a.q, a.D, a.Hq, a.Tq, B, a.qsh, a.qst, a.qsb, pl.bq);
  if (e == cudaSuccess)
    e = make_map(&tk, &p.kx, a.k, a.D, KV, a.Tk, B, a.ksh, a.kst, a.ksb, pl.bkv);
  if (e == cudaSuccess)
    e = make_map(&tv, &p.vx, a.v, a.D, KV, a.Tk, B, a.vsh, a.vst, a.vsb, pl.bkv);
  if (e == cudaSuccess)
    e = make_map(&to, &p.ox, a.out, a.D, a.Hq, a.Tq, B, a.osh, a.ost, a.osb, 64);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (e != cudaSuccess) return e;
  flash_tc_kernel<DP><<<grid, TC_THREADS, pl.smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32 --

constexpr int kFQ = 16, kFKV = 32;  // fp32 tiles: 4 warps x 4 queries, 32 keys

size_t f32_smem(int D) {
  return (size_t)(kFQ * D + kFKV * (D + 1) + kFKV * D) * sizeof(float);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Args a) {
  constexpr int RPW = kFQ / (kThreads / 32);  // queries per warp
  constexpr int DPL = DMAX / 32;              // accumulator columns per lane
  const int D = a.D, KLD = D + 1;             // K rows padded by a word
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // (kFQ, D)
  float* ks = qs + kFQ * D;                    // (kFKV, KLD)
  float* vs = ks + kFKV * KLD;                 // (kFKV, D)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = a.n_qt - 1 - (int)(blockIdx.x % a.n_qt);
  const int bh = blockIdx.x / a.n_qt;
  const int b = bh / a.Hq, hq = bh % a.Hq, hk = hq / a.G;
  const int q0 = qt * kFQ;
  const float* Q = static_cast<const float*>(a.q) + b * a.qsb + hq * a.qsh;
  const float* K = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* V = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;
  float* O = static_cast<float*>(a.out) + b * a.osb + hq * a.osh;

  for (int i = threadIdx.x; i < kFQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = q0 + r < a.Tq ? Q[(long long)(q0 + r) * a.qst + d] : 0.f;
  }
  int j0, j1;
  tile_range(a, q0, kFQ, kFKV, j0, j1);
  __syncthreads();  // the Q tile is in shared memory

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    const int kv0 = j * kFKV;
    __syncthreads();
    for (int i = threadIdx.x; i < kFKV * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const bool in = kv0 + t < a.Tk;
      ks[t * KLD + d] = in ? K[(long long)(kv0 + t) * a.kst + d] : 0.f;
      vs[i] = in ? V[(long long)(kv0 + t) * a.vst + d] : 0.f;
    }
    __syncthreads();

    const int key = kv0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i, qp = a.q_offset + q0 + row;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row * D + d], ks[lane * KLD + d], dot);
      float x = __fmul_rn(dot, a.scale);
      if (key >= a.n_visit)
        x = -INFINITY;
      else if (!live(qp, key, a))
        x = kNegInf;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(x - m_new), c = expf(m[i] - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], c), sum);
      m[i] = m_new;
      float pv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) pv[e] = 0.f;
      for (int t = 0; t < kFKV; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          if (lane + 32 * e < D) pv[e] = fmaf(pt, vs[t * D + lane + 32 * e], pv[e]);
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] = __fadd_rn(__fmul_rn(acc[i][e], c), pv[e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = q0 + warp * RPW + i;
    if (r >= a.Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (lane + 32 * e < D) O[r * a.ost + lane + 32 * e] = __fdiv_rn(acc[i][e], den);
  }
}

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, const Args& a, int blocks, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, out (B, Hq, Tq, D) and k, v (B, KV, Tk, D) views, all bf16 (fp32 = 0)
// or all fp32 (fp32 = 1), at the given element strides with the D axis
// contiguous; Hq = KV * G; D a multiple of 8 up to 256; bf16 views 16-byte
// aligned with strides of whole 16 bytes (TMA's rule).  Keys k < kv_live
// are live (with the causal and window masks, window < 0 for none); keys
// k < n_visit are visited; q row t sits at position q_offset + t.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Hq, int KV,
    int Tq, int Tk, int D, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, int causal,
    int window, int q_offset, int kv_live, int n_visit, int fp32, float scale,
    void* stream) {
  if (B < 1 || KV < 1 || Hq < KV || Hq % KV || Tq < 1 || Tk < 1 || D < 8 ||
      D > 256 || D % 8)
    return cudaErrorInvalidValue;
  Args a{q,   k,   v,   out, qsb, qsh,    qst,      ksb,     ksh,     kst,
         vsb, vsh, vst, osb, osh, ost,    Hq,       Hq / KV, Tq,      Tk,
         D,   causal, window, q_offset, kv_live, n_visit, 0,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    a.n_qt = (Tq + kFQ - 1) / kFQ;
    const long long blocks = (long long)B * Hq * a.n_qt;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    const size_t smem = f32_smem(D);
    if (D <= 64) return launch(flash_f32_kernel<64>, smem, a, (int)blocks, s);
    if (D <= 128) return launch(flash_f32_kernel<128>, smem, a, (int)blocks, s);
    return launch(flash_f32_kernel<256>, smem, a, (int)blocks, s);
  }
  const Plan pl = plan(D);
  a.n_qt = (Tq + pl.bq - 1) / pl.bq;
  const long long blocks = (long long)B * Hq * a.n_qt;
  if (blocks > 0x7fffffff || pl.stages < 2 || pl.smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  switch ((D + 63) / 64) {
    case 1: return launch_tc<1>(a, B, KV, pl, blocks, s);
    case 2: return launch_tc<2>(a, B, KV, pl, blocks, s);
    case 3: return launch_tc<3>(a, B, KV, pl, blocks, s);
    default: return launch_tc<4>(a, B, KV, pl, blocks, s);
  }
}

// The bf16 body's plan for head_dim D: out[0..3] = query tile, key tile,
// ring stages, dynamic shared bytes.
extern "C" int flash_plan(int D, int* out) {
  if (D < 8 || D > 256 || D % 8) return cudaErrorInvalidValue;
  const Plan p = plan(D);
  out[0] = p.bq;
  out[1] = p.bkv;
  out[2] = p.stages;
  out[3] = p.smem;
  return cudaSuccess;
}
