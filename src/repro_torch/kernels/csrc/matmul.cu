// GEMM for Hopper (sm_90a): C = A @ B or A @ B^T, fp32 accumulation,
// stored in the operands' type (bf16 or fp32).
//
// Replaces the TPU kernel matmul_pallas (repro/kernels/matmul/matmul.py):
// a blocked (M, K) @ (K, N) with K innermost and an fp32 accumulator cast
// at the store.  Where the reference's ops.matmul pads the inputs to tile
// multiples and slices the result, this kernel masks the ragged edges
// itself (TMA fills zeros past the matrix, stores are masked), so no
// operand is ever copied.  B comes row-major as (K, N), or as (N, K) with
// trans_b = 1, which serves the tied unembedding x @ tok^T without copying
// the (vocab, d_model) table.
//
// What bounds it: on the decode path M is the slot count (8, or 9 with the
// checksum row), so every product reads each weight once and does 2 M
// operations per weight element, about 8 per byte against the 295 at which
// the tensor cores start to bind: bound by the weight bytes, and at
// smollm-360m's small matrices (0.6-4.9 MB) by the latency of getting them
// in flight.  Prefill (M = the admitted prompt tokens) is operations
// bound.  The bf16 design:
//
// - Operands swapped.  Every body computes C^T = B^T A^T on the tensor
//   cores with wgmma.mma_async m64nNk16: the weight tile is wgmma's A (64
//   output columns a consumer warpgroup, from shared memory: K-major for
//   trans_b, N-major and so transposed for a (K, N) weight) and the
//   activations are its B (N = the M tile, 8 to 128 rows, K-major).  At
//   decode M the weight fills the MMA's 64 rows and M is the narrow side,
//   so no MMA row is wasted; and since every body issues the same
//   instruction with the same operands in the same roles, a row of C gets
//   the same bits at any M.
// - A ring of stages fed by TMA.  One producer thread keeps every stage of
//   the ring in flight (64 k deep: the weight box and the activation box,
//   128-byte swizzle, one mbarrier per stage for full and one for empty);
//   the consumer warpgroups multiply a stage and release it.  Where TMA
//   cannot describe an operand (a row pitch that is no multiple of 16
//   bytes, a base that is not 16-byte aligned) the producer warpgroup's 128
//   threads fill the same swizzled layout with masked loads instead.
// - The K order is a function of (N, K) alone (plan(), mirrored in
//   kernels/matmul/matmul.py): K is cut into `split` chunks of whole 64-k
//   panels; each chunk sums its k16 steps in order from zero, and the
//   chunks' sums are added in chunk order, p0 + p1 + ....  The skinny body
//   (M <= 64: one consumer warpgroup, the M tile one wgmma N of 8-64) puts
//   the chunks of one 64-column tile on the blocks of a thread-block
//   cluster (at most 8, the portable size), so a small N still fills the
//   card, and block 0 adds its peers' partials in rank order through
//   distributed shared memory, in the same launch, with no atomics.  The
//   wide body (M > 64: a persistent block per SM, two consumer
//   warpgroups, 128 rows x 128 or 64 columns a tile, the columns chosen by
//   rounds over the SMs) runs the same chunks
//   one after the other, each into a fresh accumulator that it adds to a
//   running total in the same order.  Results repeat bit for bit.
// - Epilogue: each consumer warpgroup puts its fp32 tile in shared memory,
//   then stores it row by row as bf16, 16 bytes a thread where the row
//   allows it.  gemm_abft adds the Huang-Abraham column checksums e^T C of
//   every row block of `abft_bm` rows from the same fp32 tile, one thread
//   a column summing the rows in order, before the cast: its C is bitwise
//   gemm's.  The verdict that compares the checksums with (e^T A) B is a
//   plain product outside the kernel, as in the reference
//   (kernels/matmul/ops.py).
//
// fp32 operands take a second kernel body, gemm_f32_kernel, on the CUDA
// cores in full fp32 (no TF32: the tensor cores would round the operands
// to 10 mantissa bits), as the reference's fp32 matmul_pallas keeps fp32.
// Its tiles are BM = 16 rows for M <= 16, else 64, by 64 columns, staged
// 16 deep in K in shared memory; each of 256 threads owns a (BM/16) x 4
// patch of C and adds k = 0, 1, ... K-1 into each output with one fused
// multiply-add per step.  That sequence does not depend on M or on the
// tile, so a row's bits do not depend on M; the checksum epilogue sums
// the fp32 tile's rows in order, so the checksum variant's C is bitwise
// gemm's here too.  Bound: fp32 on the CUDA cores (66.9 TFLOP/s) at large
// M, the weight bytes at decode M; this simple body is far from both.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ plan --
// Mirrored by kernels/matmul/matmul.py: plan(), m_bucket(), k_split().

constexpr int WG = 128;             // threads of a warpgroup
constexpr int PANEL_K = 64;         // k a ring stage: one 128-byte swizzle span of bf16
constexpr int TILE_N = 64;          // weight rows (output columns) a consumer warpgroup
constexpr int SKINNY_MAX_M = 64;    // the skinny body up to here, the wide body beyond
constexpr int MAX_SPLIT = 8;        // K chunks: the portable cluster size
constexpr int SMS = 132;            // the H100's SMs: the splits' waves, the wide grid
constexpr int SKINNY_MAX_STAGES = 8;
constexpr int WIDE_MAX_STAGES = 8;
constexpr int WIDE_BM = 128;        // M rows a wide tile
constexpr int MAX_BUCKET = 16384;   // M buckets stop growing here
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block
constexpr int STG_LD = 68;          // fp32 staging row (64 columns + 4: no bank conflicts)
constexpr int W_BOX_BYTES = TILE_N * PANEL_K * 2;  // 8 KB
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // (56 + 2 x 224) x 128 <= 65,536

struct Plan {
  int body;    // 0: skinny (M <= 64), 1: wide
  int bm;      // M rows a tile
  int bn;      // output columns a tile (64 a consumer warpgroup)
  int split;   // K chunks
  int stages;  // ring stages
  int grid;    // blocks
  int smem;    // dynamic shared memory, bytes
};

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The M bucket a plan is keyed on: 8, 16, 32 or 64 up to 64 rows (the
// skinny body's tile), then M rounded up to the wide tile's 128 rows, at
// most MAX_BUCKET.
inline int m_bucket(int M) {
  if (M > SKINNY_MAX_M) {
    const int b = cdiv(M, WIDE_BM) * WIDE_BM;
    return b < MAX_BUCKET ? b : MAX_BUCKET;
  }
  int b = 8;
  while (b < M) b *= 2;
  return b;
}

// K chunks, from (N, K) alone: the split of the skinny grid (64-column
// tiles x chunks) whose waves over the SMs times the longest
// chunk's 64-k panels are fewest, the fewest chunks among equals; at most
// MAX_SPLIT and the panels.  (The blocking search's choice on the GEMM
// nest, kernels/matmul/ops.py: gemm_search.)
inline int k_split(int N, int K) {
  const int kp = cdiv(K, PANEL_K), nt = cdiv(N, TILE_N);
  int best = 1;
  long long best_t = -1;
  for (int s = 1; s <= MAX_SPLIT && s <= kp; ++s) {
    const long long t = (long long)cdiv((long long)nt * s, SMS) * cdiv(kp, s);
    if (best_t < 0 || t < best_t) {
      best_t = t;
      best = s;
    }
  }
  return best;
}

// The wide body's tile columns: 128 (the two consumer warpgroups split the
// columns, 64 each, over all 128 rows) or 64 (they split the rows, 64 each,
// over the same 64 columns), whichever takes less time as the L2 serves it:
// rounds of tiles over the SMs times the bytes a tile's block loads for
// each 64-k panel (the wide body is bound by L2's rate to the SMs).
inline int wide_bn(int bucket, int N) {
  const long long mt = cdiv(bucket, WIDE_BM);
  const long long t128 = cdiv(cdiv(N, 2 * TILE_N) * mt, SMS) * (2 * W_BOX_BYTES + WIDE_BM * 128);
  const long long t64 = cdiv(cdiv(N, TILE_N) * mt, SMS) * (W_BOX_BYTES + WIDE_BM * 128);
  return t64 < t128 ? TILE_N : 2 * TILE_N;
}

// Rows a wide consumer warpgroup multiplies (wgmma's N) for tile columns bn
inline int wide_rows(int bn) { return bn == TILE_N ? WIDE_BM / 2 : WIDE_BM; }

inline Plan plan(int M, int N, int K) {
  Plan p;
  const int bucket = m_bucket(M), kp = cdiv(K, PANEL_K);
  p.split = k_split(N, K);
  if (M <= SKINNY_MAX_M) {
    p.body = 0;
    p.bm = bucket;
    p.bn = TILE_N;
    int st = cdiv(kp, p.split);
    p.stages = st < 1 ? 1 : (st > SKINNY_MAX_STAGES ? SKINNY_MAX_STAGES : st);
    p.grid = cdiv(N, TILE_N) * p.split;
    p.smem = 1024 + p.stages * (W_BOX_BYTES + p.bm * 128) + p.bm * STG_LD * 4 +
             (p.split > 1 ? p.bm * 256 : 0) + 16 * p.stages;
  } else {
    p.body = 1;
    p.bm = WIDE_BM;
    p.bn = wide_bn(bucket, N);
    const int stage = (p.bn / TILE_N) * W_BOX_BYTES + p.bm * 128;
    const int staging = 2 * wide_rows(p.bn) * STG_LD * 4;
    const int fixed = 1024 + staging + 16 * WIDE_MAX_STAGES;
    const int st = (SMEM_LIMIT - fixed) / stage;
    p.stages = st > WIDE_MAX_STAGES ? WIDE_MAX_STAGES : st;
    const int tiles = cdiv(N, p.bn) * cdiv(bucket, p.bm);
    p.grid = tiles < SMS ? tiles : SMS;
    p.smem = 1024 + p.stages * stage + staging + 16 * p.stages;
  }
  return p;
}

// First 64-k panel of chunk c of `split` over kp panels
__host__ __device__ __forceinline__ int chunk_start(int c, int kp, int split) {
  return (int)((long long)c * kp / split);
}

// ------------------------------------------------------------- bf16 body --

struct Params {
  const bf16* a;   // (M, K)
  const bf16* b;   // (K, N), or (N, K) with trans_b
  bf16* c;         // (M, N)
  float* checks;   // (ceil(M / abft_bm), N) or null
  int M, N, K, kp, split, stages, abft_bm;
  int m_tiles, ntiles;
  int tma_a, tma_b, vec_c, cluster;
  uint32_t stage_bytes;
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Raise the barrier's expected transaction bytes without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// d (64 x N fp32; thread T of warp w holds d[4 j + 2 i + e] = D[16 w + T / 4
// + 8 i, 8 j + 2 (T % 4) + e]) += a (64 x 16) * b (16 x N), both bf16 in
// shared memory through descriptors: a K-major (TA = 0, desc_k128) or
// M-major (TA = 1, desc_b128), b K-major.  N = 8, 16, 32, 64, 128.
template <int N, int TA>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

#define GEMM_F4(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3])
#define GEMM_F8(b) GEMM_F4(b), GEMM_F4(b + 4)
#define GEMM_F16(b) GEMM_F8(b), GEMM_F8(b + 8)
#define GEMM_F32(b) GEMM_F16(b), GEMM_F16(b + 16)
#define GEMM_F64(b) GEMM_F32(b), GEMM_F32(b + 32)

#define GEMM_R4 "%0, %1, %2, %3"
#define GEMM_R8 GEMM_R4 ", %4, %5, %6, %7"
#define GEMM_R16 GEMM_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define GEMM_R32                                                                              \
  GEMM_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define GEMM_R64                                                                              \
  GEMM_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "    \
           "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, " \
           "%63"

#define GEMM_WGMMA_TA(NN, TA, REGS, IA, IB, IP, ...)                                       \
  template <>                                                                                 \
  __device__ __forceinline__ void wgmma<NN, TA>(float (&d)[NN / 2], uint64_t da, uint64_t db) { \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " IP ", 0;\n"                            \
                 "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 {" REGS "}, " IA   \
                 ", " IB ", p, 1, 1, " #TA ", 0;\n}\n"                                         \
                 : __VA_ARGS__                                                                \
                 : "l"(da), "l"(db), "r"(1));                                                 \
  }
#define GEMM_WGMMA(NN, REGS, IA, IB, IP, ...)          \
  GEMM_WGMMA_TA(NN, 0, REGS, IA, IB, IP, __VA_ARGS__) \
  GEMM_WGMMA_TA(NN, 1, REGS, IA, IB, IP, __VA_ARGS__)

GEMM_WGMMA(8, GEMM_R4, "%4", "%5", "%6", GEMM_F4(0))
GEMM_WGMMA(16, GEMM_R8, "%8", "%9", "%10", GEMM_F8(0))
GEMM_WGMMA(32, GEMM_R16, "%16", "%17", "%18", GEMM_F16(0))
GEMM_WGMMA(64, GEMM_R32, "%32", "%33", "%34", GEMM_F32(0))
GEMM_WGMMA(128, GEMM_R64, "%64", "%65", "%66", GEMM_F64(0))

// Shared-memory layout of a block (from a 1024-byte aligned base): the
// ring (each stage the weight boxes, WN x 8 KB, then the activation box,
// BM rows x 128 bytes), the consumers' fp32 staging (WGS x MT x STG_LD,
// MT a consumer's rows), the cluster's partials (skinny with a split: MT /
// 2 x 128 fp32), the barriers (full[s], then empty[s]).
struct Layout {
  uint32_t base, staging, partials, bars;
};

template <int MT, int WGS>
__device__ __forceinline__ Layout layout(const Params& p, uint32_t raw) {
  Layout l;
  l.base = (raw + 1023u) & ~1023u;
  l.staging = l.base + p.stages * p.stage_bytes;
  l.partials = l.staging + WGS * MT * STG_LD * 4;
  l.bars = l.partials + (p.cluster ? MT * 256 : 0);
  return l;
}

// The producer warpgroup: the ring's loads (WN weight boxes of 64 rows, BM
// activation rows) for tiles first, first + step, ... < p.ntiles, chunks
// [c_lo, c_hi) of each.  With both operands on TMA
// one thread issues every load; otherwise the 128 threads fill the masked
// operand(s) element by element into the same swizzled layout.
template <int BM, int WN, int WGS, bool TRANS_B>
__device__ void produce(const CUtensorMap* tm_a, const CUtensorMap* tm_b, const Params& p,
                        const Layout& l, int first, int step, int c_lo, int c_hi) {
  const int tid = threadIdx.x;
  const bool all_tma = p.tma_a && p.tma_b;
  if (all_tma && tid != 0) return;
  const uint32_t tx = (p.tma_b ? WN * W_BOX_BYTES : 0) + (p.tma_a ? BM * 128 : 0);
  const unsigned short* A = reinterpret_cast<const unsigned short*>(p.a);
  const unsigned short* B = reinterpret_cast<const unsigned short*>(p.b);
  int n = 0;
  for (int tile = first; tile < p.ntiles; tile += step) {
    const int m0 = (tile % p.m_tiles) * BM, n0 = (tile / p.m_tiles) * (WN * TILE_N);
    for (int c = c_lo; c < c_hi; ++c) {
      const int k_end = chunk_start(c + 1, p.kp, p.split);
      for (int kq = chunk_start(c, p.kp, p.split); kq < k_end; ++kq, ++n) {
        const int s = n % p.stages, k0 = kq * PANEL_K;
        hopper::mbar_wait<WGS == 1>(l.bars + 8 * (p.stages + s), ((n / p.stages) & 1) ^ 1);
        const uint32_t full = l.bars + 8 * s, ws = l.base + s * p.stage_bytes;
        const uint32_t xs = ws + WN * W_BOX_BYTES;
        if (all_tma) {
          hopper::mbar_expect_tx(full, tx);
        } else if (tid == 0 && tx) {
          mbar_expect_tx_only(full, tx);
        }
        if (tid == 0) {
          if (p.tma_b) {
            if (TRANS_B) {
              tma_load_2d(ws, tm_b, full, k0, n0);
            } else {
#pragma unroll
              for (int w = 0; w < WN; ++w)
                tma_load_2d(ws + w * W_BOX_BYTES, tm_b, full, n0 + w * TILE_N, k0);
            }
          }
          if (p.tma_a) tma_load_2d(xs, tm_a, full, k0, m0);
        }
        if (all_tma) continue;
        if (!p.tma_a) {  // rows m of 64 k
          for (int i = tid; i < BM * PANEL_K; i += WG) {
            const int r = i / PANEL_K, kk = i % PANEL_K, gm = m0 + r, gk = k0 + kk;
            const unsigned short v = (gm < p.M && gk < p.K) ? A[(long long)gm * p.K + gk] : 0;
            st_shared_b16(hopper::swizzle(xs + r * 128 + kk * 2, 7), v);
          }
        }
        if (!p.tma_b) {
          for (int i = tid; i < WN * TILE_N * PANEL_K; i += WG) {
            if (TRANS_B) {  // rows n of 64 k
              const int r = i / PANEL_K, kk = i % PANEL_K, gn = n0 + r, gk = k0 + kk;
              const unsigned short v =
                  (gn < p.N && gk < p.K) ? B[(long long)gn * p.K + gk] : 0;
              st_shared_b16(hopper::swizzle(ws + r * 128 + kk * 2, 7), v);
            } else {  // per warpgroup w: rows k of 64 n
              const int w = i / (TILE_N * PANEL_K), j = i % (TILE_N * PANEL_K);
              const int kr = j / TILE_N, nc = j % TILE_N;
              const int gn = n0 + w * TILE_N + nc, gk = k0 + kr;
              const unsigned short v =
                  (gn < p.N && gk < p.K) ? B[(long long)gk * p.N + gn] : 0;
              st_shared_b16(hopper::swizzle(ws + w * W_BOX_BYTES + kr * 128 + nc * 2, 7), v);
            }
          }
        }
        hopper::fence_async_shared();
        hopper::bar_sync(1, WG);
        if (tid == 0) hopper::mbar_arrive(full);
      }
    }
  }
}

// A consumer warpgroup (cw) on one tile: chunks [c_lo, c_hi), each summed
// from zero into `part` and added to `acc` in chunk order (SPLIT), or the
// one chunk straight into `acc`.  One panel's wgmma group stays in flight
// while the next is issued; a stage is released when its group is done.
// `n` counts the ring's stages.
template <int MT, int WN, int WGS, bool TRANS_B, bool SPLIT>
__device__ __forceinline__ void consume(float (&acc)[MT / 2], float (&part)[MT / 2],
                                        const Params& p, const Layout& l, int cw, int c_lo,
                                        int c_hi, int& n) {
  constexpr bool TRAP = WGS == 1;  // see the kernel
  const int lane = threadIdx.x & 31;
  for (int c = c_lo; c < c_hi; ++c) {
    float(&cur)[MT / 2] = SPLIT ? part : acc;
#pragma unroll
    for (int e = 0; e < MT / 2; ++e) cur[e] = 0.f;
    const int k_end = chunk_start(c + 1, p.kp, p.split);
    int prev = -1;  // the stage of the group still in flight
    for (int kq = chunk_start(c, p.kp, p.split); kq < k_end; ++kq, ++n) {
      const int s = n % p.stages;
      hopper::mbar_wait<TRAP>(l.bars + 8 * s, (n / p.stages) & 1);
      __syncwarp();
      // each consumer its own 64 weight rows (WN = WGS) or its own MT
      // activation rows (WN = 1)
      const uint32_t wa = l.base + s * p.stage_bytes + (WN > 1 ? cw * W_BOX_BYTES : 0);
      const uint32_t xa =
          l.base + s * p.stage_bytes + WN * W_BOX_BYTES + (WN > 1 ? 0 : cw * MT * 128);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL_K / 16; ++kk) {
        const uint64_t da = TRANS_B ? hopper::desc_k128(wa + 32 * kk)
                                    : hopper::desc_b128(wa + 2048 * kk, W_BOX_BYTES);
        wgmma<MT, TRANS_B ? 0 : 1>(cur, da, hopper::desc_k128(xa + 32 * kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(l.bars + 8 * (p.stages + prev));
      }
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(cur);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(l.bars + 8 * (p.stages + prev));
    }
    if (SPLIT) {
#pragma unroll
      for (int e = 0; e < MT / 2; ++e) acc[e] = c == c_lo ? part[e] : __fadd_rn(acc[e], part[e]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// A consumer warpgroup's epilogue for its BM x 64 tile at rows m0, columns
// nb: the fp32 tile through shared memory, stored as bf16 row by row, and
// with checks the column sums of each abft_bm-row block, rows in order.
template <int BM>
__device__ __forceinline__ void epilogue(const float (&acc)[BM / 2], const Params& p,
                                         const Layout& l, unsigned char* raw, uint32_t raw_u32,
                                         int cw, int m0, int nb) {
  const int ct = threadIdx.x - WG * (1 + cw), warp = ct >> 5, lane = ct & 31;
  float* stg = reinterpret_cast<float*>(raw + (l.staging - raw_u32)) + cw * BM * STG_LD;
  hopper::bar_sync(2 + cw, WG);  // the last tile's reads of the staging are done
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        stg[(8 * j + 2 * (lane & 3) + e) * STG_LD + 16 * warp + (lane >> 2) + 8 * i] =
            acc[4 * j + 2 * i + e];
  hopper::bar_sync(2 + cw, WG);
  for (int idx = ct; idx < BM * (TILE_N / 8); idx += WG) {
    const int r = idx / (TILE_N / 8), c8 = (idx % (TILE_N / 8)) * 8;
    const int gm = m0 + r, gn = nb + c8;
    if (gm >= p.M || gn >= p.N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stg + r * STG_LD + c8);
    const float4 hi = *reinterpret_cast<const float4*>(stg + r * STG_LD + c8 + 4);
    bf16* dst = p.c + (long long)gm * p.N + gn;
    if (p.vec_c && gn + 8 <= p.N) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                                                  pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    } else {
      const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      for (int e = 0; e < 8 && gn + e < p.N; ++e) dst[e] = __float2bfloat16(f[e]);
    }
  }
  if (p.checks != nullptr && ct < TILE_N && nb + ct < p.N) {
    for (int rs = 0; rs < BM && m0 + rs < p.M; rs += p.abft_bm) {
      int rows = p.M - m0 - rs;
      if (rows > p.abft_bm) rows = p.abft_bm;
      if (rows > BM - rs) rows = BM - rs;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s = __fadd_rn(s, stg[(rs + r) * STG_LD + ct]);
      p.checks[(long long)((m0 + rs) / p.abft_bm) * p.N + nb + ct] = s;
    }
  }
}

// One kernel for both bodies: a tile of BM rows and WN x 64 columns, WGS
// consumer warpgroups of MT rows x 64 columns each (they split the columns
// when WN = WGS, the rows when WN = 1 < WGS).  p.cluster (skinny with a
// split): block rank r of a cluster of p.split blocks sums chunk r of tile
// blockIdx.x / split, and rank 0 adds the peers' partials in rank order and
// stores.  Otherwise each block walks tiles blockIdx.x, + gridDim.x, ... (M
// tiles fastest, so the blocks at work at one time share their weight
// tiles), every chunk of each.
template <int BM, int WN, int WGS, bool TRANS_B, bool SPLIT>
__global__ void __launch_bounds__((1 + WGS) * WG, WGS == 2 ? 1 : (BM >= 64 ? 2 : 3))
    gemm_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b, const Params p) {
  constexpr int MT = WN < WGS ? BM / WGS : BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const Layout l = layout<MT, WGS>(p, raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    if (p.tma_a) hopper::prefetch_tensor_map(&tm_a);
    if (p.tma_b) hopper::prefetch_tensor_map(&tm_b);
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(l.bars + 8 * s, 1);
      hopper::mbar_init(l.bars + 8 * (p.stages + s), WGS * 4);  // one arrival a warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();
  // The wide body's warpgroups move registers (setmaxnreg): the producer
  // gives up all but PRODUCER_REGS, the consumers take CONSUMER_REGS for the
  // chunk's and the total's accumulators.  Its waits then never trap: with
  // a trap anywhere in the kernel ptxas holds every warpgroup to the launch
  // bound's 168 registers (hopper.cuh, mbar_wait).  The role is warp-uniform
  // to the compiler (a broadcast from lane 0).
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const bool producer = wg == 0;
  const int cw = wg - 1;
  if (WGS == 2) {
    if (producer)
      hopper::setmaxnreg_dec<PRODUCER_REGS>();
    else
      hopper::setmaxnreg_inc<CONSUMER_REGS>();
  }
  float acc[MT / 2], part[MT / 2];

  // (the skinny body alone: in the wide body the roles never meet again,
  // so ptxas can give each role its own registers)
  if constexpr (WGS == 1) {
    if (p.cluster) {
      cg::cluster_group cluster = cg::this_cluster();
      const int rank = (int)cluster.block_rank(), tile = blockIdx.x / p.split;
      if (producer) {
        produce<BM, WN, WGS, TRANS_B>(&tm_a, &tm_b, p, l, tile, p.ntiles, rank, rank + 1);
      } else {
        int n = 0;
        consume<MT, WN, WGS, TRANS_B, false>(acc, part, p, l, cw, rank, rank + 1, n);
      }
      float* peers = reinterpret_cast<float*>(smem_raw + (l.partials - raw));
      const int ct = tid - WG;
      if (!producer && rank != 0) {
#pragma unroll
        for (int e = 0; e < MT / 2; ++e) peers[e * WG + ct] = acc[e];
      }
      cluster.sync();  // every partial is written
      if (!producer && rank == 0) {
        for (int r = 1; r < p.split; ++r) {
          const float* src = cluster.map_shared_rank(peers, r);
#pragma unroll
          for (int e = 0; e < MT / 2; ++e) acc[e] = __fadd_rn(acc[e], src[e * WG + ct]);
        }
      }
      cluster.sync();  // the peers' partials are read
      if (!producer && rank == 0) epilogue<MT>(acc, p, l, smem_raw, raw, cw, 0, tile * TILE_N);
      return;
    }
  }

  if (producer) {
    produce<BM, WN, WGS, TRANS_B>(&tm_a, &tm_b, p, l, blockIdx.x, gridDim.x, 0, p.split);
    return;
  }
  int n = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    consume<MT, WN, WGS, TRANS_B, SPLIT>(acc, part, p, l, cw, 0, p.split, n);
    const int m0 = (tile % p.m_tiles) * BM, n0 = (tile / p.m_tiles) * (WN * TILE_N);
    epilogue<MT>(acc, p, l, smem_raw, raw, cw, m0 + (WN < WGS ? cw * MT : 0),
                 n0 + (WN < WGS ? 0 : cw * TILE_N));
  }
}

// --------------------------------------------------------- tensor maps --
// A map is built on the host per (pointer, dims, pitch, box) and kept, so
// a decode step's calls on the same weights and activation buffers build
// none; the cache is cleared when it holds MAP_CACHE entries.

constexpr size_t MAP_CACHE = 4096;

struct MapKey {
  uintptr_t ptr;
  uint64_t d0, d1, pitch;
  uint32_t b0, b1;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && pitch == o.pitch && b0 == o.b0 &&
           b1 == o.b1;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr;
    for (uint64_t v : {k.d0, k.d1, k.pitch, (uint64_t)k.b0 << 32 | k.b1})
      h = (h ^ v) * 0x100000001b3ull;
    return (size_t)h;
  }
};

std::mutex map_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;

// A 2-D bf16 map of a row-major (d1, d0) matrix with a row pitch of
// `pitch` bytes, box (b1 rows, b0 columns), 128-byte swizzle.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
                       uint64_t pitch, uint32_t b0, uint32_t b1) {
  const MapKey key{reinterpret_cast<uintptr_t>(ptr), d0, d1, pitch, b0, b1};
  std::lock_guard<std::mutex> lock(map_mutex);
  auto it = map_cache.find(key);
  if (it != map_cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const uint64_t dims[2] = {d0, d1}, strides[1] = {pitch};
  const uint32_t box[2] = {b0, b1};
  const cudaError_t err =
      hopper::bf16_tensor_map(map, ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if (map_cache.size() >= MAP_CACHE) map_cache.clear();
  map_cache.emplace(key, *map);
  return cudaSuccess;
}

template <int BM, int WN, int WGS, bool TRANS_B, bool SPLIT>
cudaError_t launch_tc(const CUtensorMap& tm_a, const CUtensorMap& tm_b, const Params& p,
                      const Plan& pl, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};  // a bit a device
  auto kern = gemm_tc_kernel<BM, WN, WGS, TRANS_B, SPLIT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set.load() & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)pl.grid);
  cfg.blockDim = dim3((1 + WGS) * WG);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, tm_a, tm_b, p);
}

template <bool TRANS_B>
cudaError_t launch_bf16(const CUtensorMap& tm_a, const CUtensorMap& tm_b, const Params& p,
                        const Plan& pl, cudaStream_t s) {
  if (pl.body == 0) {
    switch (pl.bm) {
      case 8: return launch_tc<8, 1, 1, TRANS_B, false>(tm_a, tm_b, p, pl, s);
      case 16: return launch_tc<16, 1, 1, TRANS_B, false>(tm_a, tm_b, p, pl, s);
      case 32: return launch_tc<32, 1, 1, TRANS_B, false>(tm_a, tm_b, p, pl, s);
      default: return launch_tc<64, 1, 1, TRANS_B, false>(tm_a, tm_b, p, pl, s);
    }
  }
  if (pl.bn == TILE_N)
    return pl.split > 1 ? launch_tc<WIDE_BM, 1, 2, TRANS_B, true>(tm_a, tm_b, p, pl, s)
                        : launch_tc<WIDE_BM, 1, 2, TRANS_B, false>(tm_a, tm_b, p, pl, s);
  return pl.split > 1 ? launch_tc<WIDE_BM, 2, 2, TRANS_B, true>(tm_a, tm_b, p, pl, s)
                      : launch_tc<WIDE_BM, 2, 2, TRANS_B, false>(tm_a, tm_b, p, pl, s);
}

int run_bf16(const void* a, const void* b, void* c, float* checks, int M, int N, int K,
             int trans_b, cudaStream_t stream) {
  const Plan pl = plan(M, N, K);
  Params p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = static_cast<bf16*>(c);
  p.checks = checks;
  p.M = M; p.N = N; p.K = K;
  p.kp = cdiv(K, PANEL_K);
  p.split = pl.split;
  p.stages = pl.stages;
  p.abft_bm = M <= 16 ? 16 : 64;
  p.m_tiles = cdiv(M, pl.bm);
  p.ntiles = cdiv(N, pl.bn) * p.m_tiles;
  p.cluster = pl.body == 0 && pl.split > 1;
  p.stage_bytes = (uint32_t)(pl.bn / TILE_N * W_BOX_BYTES + pl.bm * 128);
  const uintptr_t ua = reinterpret_cast<uintptr_t>(a), ub = reinterpret_cast<uintptr_t>(b);
  // TMA takes a 16-byte aligned base and a row pitch of a multiple of 16 bytes
  p.tma_a = K > 0 && K % 8 == 0 && ua % 16 == 0;
  p.tma_b = K > 0 && (trans_b ? K : N) % 8 == 0 && ub % 16 == 0;
  p.vec_c = N % 8 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  CUtensorMap tm_a, tm_b;
  memset(&tm_a, 0, sizeof(tm_a));
  memset(&tm_b, 0, sizeof(tm_b));
  cudaError_t err = cudaSuccess;
  if (p.tma_a) err = tensor_map(&tm_a, a, K, M, 2ull * K, PANEL_K, pl.bm);
  if (err == cudaSuccess && p.tma_b)
    err = trans_b ? tensor_map(&tm_b, b, K, N, 2ull * K, PANEL_K, pl.bn)
                  : tensor_map(&tm_b, b, N, K, 2ull * N, TILE_N, PANEL_K);
  if (err != cudaSuccess) return err;
  return trans_b ? launch_bf16<true>(tm_a, tm_b, p, pl, stream)
                 : launch_bf16<false>(tm_a, tm_b, p, pl, stream);
}

// ------------------------------------------------------------- fp32 body --

// fp32 on the CUDA cores: a BM x 64 tile of C per block of 256 threads,
// thread (ty, tx) owning rows ty * TM .. + TM - 1 and columns 4 tx .. + 3
template <int BM, bool TRANS_B, bool ABFT>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, float* __restrict__ checks, int M, int N,
                int K) {
  constexpr int BN = 64, BKF = 16, THREADS = 256, TM = BM / 16;
  __shared__ float As[BKF][BM + 4];  // As[k][m]
  __shared__ float Bs[BKF][BN + 4];  // Bs[k][n]
  __shared__ float Cs[ABFT ? BM : 1][BN + 4];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKF) {
    for (int idx = tid; idx < BM * BKF; idx += THREADS) {
      const int r = idx / BKF, c = idx % BKF;  // neighbouring threads: neighbouring k
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(long long)gr * K + gc] : 0.f;
    }
    for (int idx = tid; idx < BKF * BN; idx += THREADS) {
      int r, c;  // tile row k0 + r, tile column n0 + c
      if (TRANS_B) {
        c = idx / BKF;
        r = idx % BKF;
      } else {
        r = idx / BN;
        c = idx % BN;
      }
      const int gk = k0 + r, gn = n0 + c;
      float val = 0.f;
      if (gk < K && gn < N)
        val = TRANS_B ? B[(long long)gn * K + gk] : B[(long long)gk * N + gn];
      Bs[r][c] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i, gr = m0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j, gc = n0 + c;
      if (ABFT) Cs[r][c] = acc[i][j];
      if (gr < M && gc < N) C[(long long)gr * N + gc] = acc[i][j];
    }
  }
  if (ABFT) {
    __syncthreads();
    if (tid < BN) {
      const int c = tid, gc = n0 + c;
      if (gc < N) {
        const int rows = min(BM, M - m0);
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += Cs[r][c];
        checks[(long long)blockIdx.y * N + gc] = s;
      }
    }
  }
}

template <int BM, bool ABFT>
cudaError_t launch_f32(const float* A, const float* B, float* C, float* checks,
                       int M, int N, int K, bool trans_b, cudaStream_t stream) {
  const dim3 grid((N + 63) / 64, (M + BM - 1) / BM);
  if (trans_b)
    gemm_f32_kernel<BM, true, ABFT><<<grid, 256, 0, stream>>>(A, B, C, checks, M, N, K);
  else
    gemm_f32_kernel<BM, false, ABFT><<<grid, 256, 0, stream>>>(A, B, C, checks, M, N, K);
  return cudaGetLastError();
}

template <bool ABFT>
int gemm_f32(const void* a, const void* b, void* c, float* checks, int M, int N,
             int K, int trans_b, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* Cp = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_f32<16, ABFT>(A, B, Cp, checks, M, N, K, trans_b != 0, s);
  return launch_f32<64, ABFT>(A, B, Cp, checks, M, N, K, trans_b != 0, s);
}

template <bool ABFT>
int run_gemm(const void* a, const void* b, void* c, float* checks, int M, int N,
             int K, int trans_b, int fp32, void* stream) {
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  if (fp32) return gemm_f32<ABFT>(a, b, c, checks, M, N, K, trans_b, stream);
  return run_bf16(a, b, c, checks, M, N, K, trans_b, static_cast<cudaStream_t>(stream));
}

}  // namespace

// A (M, K), B (K, N) or (N, K) when trans_b, C (M, N); all bf16 (fp32 = 0)
// or all fp32 (fp32 = 1), row-major
extern "C" int gemm(const void* a, const void* b, void* c, int M, int N, int K,
                    int trans_b, int fp32, void* stream) {
  return run_gemm<false>(a, b, c, nullptr, M, N, K, trans_b, fp32, stream);
}

// gemm plus checks (ceil(M / BM), N) fp32 row-major, BM = 16 for M <= 16,
// else 64: checks[i, j] = sum of the fp32 C[i*BM : (i+1)*BM, j]
extern "C" int gemm_abft(const void* a, const void* b, void* c, void* checks,
                         int M, int N, int K, int trans_b, int fp32, void* stream) {
  return run_gemm<true>(a, b, c, static_cast<float*>(checks), M, N, K, trans_b, fp32,
                        stream);
}

// The bf16 bodies' plan for (M, N, K): out[0..6] = body (0 skinny, 1 wide),
// M rows a tile, output columns a tile, K chunks, ring stages, blocks,
// dynamic shared memory bytes.  trans_b does not change it.
extern "C" int gemm_plan(int M, int N, int K, int trans_b, int* out) {
  (void)trans_b;
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  const Plan p = plan(M, N, K);
  const int v[7] = {p.body, p.bm, p.bn, p.split, p.stages, p.grid, p.smem};
  memcpy(out, v, sizeof(v));
  return cudaSuccess;
}
