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
// flops per byte, above the card's ~295 ridge.  The design:
//   * bf16: one block of 4 warps per (row, 64-query tile); the query tile
//     and each 64-key K and V tile sit in shared memory (rows padded by 16
//     bytes, ldmatrix reads them without bank conflicts); each warp owns 16
//     queries, computes S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), keeps its running max, normaliser and the fp32 (16, D)
//     accumulator in registers, and feeds P (rounded to bf16) to the P.V
//     product from the S registers, as mma's C and A fragments line up;
//   * fp32: the same walk on the CUDA cores in full fp32 (no TF32), one
//     block of 4 warps per (row, 16-query tile), a warp per query, a lane
//     per key for the scores and per column for P.V;
//   * every sum runs in one fixed order (warp-shuffle butterflies within a
//     row, tiles in order), no atomics: repeat runs are bitwise.
// D is any multiple of 8 up to 256: the accumulator is sized for the
// smallest of 64, 128 and 256 that holds D (three instances per type) and
// the products run over D rounded up to the mma depth of 16 (zero columns).
// This first kernel is simple: loads go through registers into one shared
// buffer and wait for the block; a TMA / wgmma pipeline and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kThreads = 128;

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

// The tiles of BKV keys this block walks: those holding a live key of one
// of its queries when every query has one, else every visited tile
template <int BQ, int BKV>
__device__ __forceinline__ void tile_range(const Args& a, int q0, int& j0, int& j1) {
  int ok = 1;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qp = a.q_offset + q0 + r;
    if (q0 + r < a.Tq && first_live(qp, a) > last_live(qp, a)) ok = 0;
  }
  int k0 = 0, k1 = a.n_visit;
  if (__syncthreads_and(ok)) {
    const int last_q = min(q0 + BQ, a.Tq) - 1;
    k0 = first_live(a.q_offset + q0, a);
    k1 = min(k1, last_live(a.q_offset + last_q, a) + 1);
  }
  j0 = k0 / BKV;
  j1 = k1 > 0 ? (k1 + BKV - 1) / BKV : 0;
}

// ------------------------------------------------------------------ bf16 --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kBQ = 64, kBKV = 64;  // bf16 tiles: 4 warps x 16 queries, 64 keys

__host__ __device__ inline int bf16_ld(int D) { return (D + 15) / 16 * 16 + 8; }

size_t bf16_smem(int D) { return (size_t)(kBQ + 2 * kBKV) * bf16_ld(D) * sizeof(bf16); }

// Copy rows [row0, row0 + ROWS) of a (n_rows, D) bf16 view with row stride
// ld into shared memory (row stride LD), columns up to D rounded to 16,
// zeros past n_rows and past D
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int n_rows, long long ld, int D,
                                          int LD) {
  const int CH = (LD - 8) / 8;  // 16-byte chunks of a padded row
  for (int c = threadIdx.x; c < ROWS * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && cc < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + cc);
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = val;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(const Args a) {
  constexpr int NT = DMAX / 8;  // n8 tiles of the accumulator
  const int D = a.D, DP = (D + 15) / 16 * 16, LD = bf16_ld(D);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (kBQ, LD)
  bf16* ks = qs + kBQ * LD;                  // (kBKV, LD)
  bf16* vs = ks + kBKV * LD;                 // (kBKV, LD)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int qt = a.n_qt - 1 - (int)(blockIdx.x % a.n_qt);  // longest rows first
  const int bh = blockIdx.x / a.n_qt;
  const int b = bh / a.Hq, hq = bh % a.Hq, hk = hq / a.G;
  const int q0 = qt * kBQ;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qsb + hq * a.qsh;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;
  bf16* O = static_cast<bf16*>(a.out) + b * a.osb + hq * a.osh;

  load_rows<kBQ>(qs, Q, q0, a.Tq, a.qst, D, LD);
  int j0, j1;
  tile_range<kBQ, kBKV>(a, q0, j0, j1);  // its barrier publishes the Q tile

  // this lane's two query rows: warp * 16 + g and + 8
  int qp[2];
  float m[2], l[2], o[NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qp[h] = a.q_offset + q0 + warp * 16 + g + h * 8;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int kv0 = j * kBKV;
    __syncthreads();  // the previous tile's reads are done
    load_rows<kBKV>(ks, K, kv0, a.Tk, a.kst, D, LD);
    load_rows<kBKV>(vs, V, kv0, a.Tk, a.vst, D, LD);
    __syncthreads();

    // S = Q K^T for the warp's 16 queries and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4];
      ldsm_x4(aq, qs + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (keys +0..7 | +8..15) x (depth kk | kk + 8): b0, b1 of
        // n8 tile 2 np, then of 2 np + 1
        const int mi = lane >> 3;
        uint32_t bk[4];
        ldsm_x4(bk, ks + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + kk + (mi & 1) * 8);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
      }
    }

    // scale, mask, and the online-softmax update of the two rows
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = kv0 + n * 8 + t2 + (e & 1);
        float x = __fmul_rn(s[n][e], a.scale);
        if (key >= a.n_visit)
          x = -INFINITY;
        else if (!live(qp[h], key, a))
          x = kNegInf;
        s[n][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[n][e] = expf(s[n][e] - m[h]);
        sum[h] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), sum[h]);
    }

    // acc = acc * corr + bf16(P) . V, P from the S registers as A fragments;
    // the product accumulates onto the rescaled accumulator in the tensor
    // cores (a second (16, D) array of sums would not fit in registers)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], corr[e >> 1]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // 16 keys at a time
      uint32_t ap[4];
      ap[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      ap[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      ap[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      ap[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        if (dp * 16 < DP) {
          // matrices (keys +0..7 | +8..15) x (columns +0..7 | +8..15),
          // transposed: b0, b1 of n8 tile 2 dp, then of 2 dp + 1
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (kc * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], ap, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], ap, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + h * 8;
    if (r >= a.Tq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    bf16* orow = O + r * a.ost;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + t2;
      if (c < D) {
        __nv_bfloat162 val = __floats2bfloat162_rn(__fdiv_rn(o[n][h * 2], den),
                                                  __fdiv_rn(o[n][h * 2 + 1], den));
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = val;
      }
    }
  }
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
  tile_range<kFQ, kFKV>(a, q0, j0, j1);

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
// contiguous; Hq = KV * G; D a multiple of 8 up to 256.  Keys k < kv_live
// are live (with the causal and window masks, window < 0 for none); keys
// k < n_visit are visited; q row t sits at position q_offset + t.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Hq, int KV,
    int Tq, int Tk, int D, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, int causal,
    int window, int q_offset, int kv_live, int n_visit, int fp32, float scale,
    void* stream) {
  if (B < 1 || KV < 1 || Hq < KV || Hq % KV || Tq < 1 || Tk < 0 || D < 8 ||
      D > 256 || D % 8)
    return cudaErrorInvalidValue;
  Args a{q,   k,   v,   out, qsb, qsh,    qst,      ksb,     ksh,     kst,
         vsb, vsh, vst, osb, osh, ost,    Hq,       Hq / KV, Tq,      Tk,
         D,   causal, window, q_offset, kv_live, n_visit, 0,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = fp32 ? kFQ : kBQ;
  a.n_qt = (Tq + tile - 1) / tile;
  const long long blocks = (long long)B * Hq * a.n_qt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (fp32) {
    const size_t smem = f32_smem(D);
    if (D <= 64) return launch(flash_f32_kernel<64>, smem, a, (int)blocks, s);
    if (D <= 128) return launch(flash_f32_kernel<128>, smem, a, (int)blocks, s);
    return launch(flash_f32_kernel<256>, smem, a, (int)blocks, s);
  }
  const size_t smem = bf16_smem(D);
  if (D <= 64) return launch(flash_bf16_kernel<64>, smem, a, (int)blocks, s);
  if (D <= 128) return launch(flash_bf16_kernel<128>, smem, a, (int)blocks, s);
  return launch(flash_bf16_kernel<256>, smem, a, (int)blocks, s);
}
