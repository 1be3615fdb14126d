// Ragged flash-decoding for Hopper (sm_90a): single-query GQA decode
// attention over a contiguous KV cache or a paged block pool.
//
// Replaces the TPU kernels flash_decode_pallas and flash_decode_paged_pallas
// (repro/kernels/flash_attention/decode_attention.py).  Both C entry points
// below run ONE kernel body; they differ only in the functor that maps a
// (row b, split j) to the first token row of its K/V tile: b*S + j*bk for
// the contiguous cache (B, S, KV, D), table[b, j] * bs for the pool
// (num_blocks, bs, KV, D).  Because the body and the split order are shared,
// paged output is bitwise equal to contiguous output at bk == block_size.
//
// What bounds it: bytes.  A decode step reads each live K/V row once and
// does 4*G*D flops per key (G = 3 on smollm-360m, 10 on recurrentgemma-2b),
// far below the card's ~295 flops/byte ridge, so the limit is HBM
// bandwidth.  The design:
//   * one thread block per (b, kv_head) walks the live splits
//     j < ceil(len/bk) in order, so each block reads only its row's live
//     keys (ragged lengths cost what they hold, never max_len) and each K/V
//     tile is read once for all G query heads of the group (GQA in-kernel);
//   * the tile is staged in shared memory with 16-byte loads; scores and
//     the P.V product run on CUDA cores in fp32 (G is too small for wgmma);
//   * the online softmax keeps running max / normaliser / fp32 accumulator
//     in shared memory; row reductions use a fixed warp-shuffle butterfly,
//     no atomics, so results are deterministic run to run.
// It under-fills the card at small batch (B*KV blocks: 40 on 132 SMs at
// B=8 for smollm-360m, 8 for recurrentgemma-2b's single KV head); splitting
// KV across blocks with a fixed-order combine is later work.
//
// Sizes and types: every head size D that is a multiple of 8 up to 256 (D
// is a run-time argument: 16 for the -smoke configs, 64, 128, 240 for
// gemma3-12b, 256), groups of up to kMaxG = 16 query heads, and q/K/V all
// bf16 or all fp32 (a template parameter).  Everything the block stages
// is dynamic shared memory: the query and accumulator rows (2*G*D fp32),
// the split's scores (G*bk fp32) and its K and V tiles (bk rows of D).
// Above 48 KB (D = 256 with bk = 64 takes 103 KB in bf16, 169 KB in fp32)
// the launch opts in to the larger carve-out; the wrapper refuses what
// would pass the 227 KB a block may have.
//
// Semantics copied exactly from the reference: lengths clamped to
// [1, max_len] (a length of 0 attends one key); masked scores are -1e30,
// not -inf; p is rounded to V's type before the P.V product; the final
// divide is by max(l, 1e-30); the paged window keeps k_idx >
// len - 1 - window.
//
// In bf16 it is bitwise equal to the plain PyTorch version
// (decode_attention.py), so that the ABFT fingerprint (kernels/abft.py),
// which recomputes sampled rows on the plain version and compares within
// 1e-5 of the output's scale, never flags a clean step.  Summation order
// cannot be matched between this loop and PyTorch's reductions, so every
// sum is made independent of its order instead: the q.k and p.V dot
// products and the split's sum of p accumulate in fp64, where the products
// of bf16 values (16 significant bits) and the few terms add exactly, and
// round once to fp32; exp runs in fp64 and rounds once; the running
// rescales are explicit round-to-nearest fp32 multiplies and adds (no FMA
// contraction), as PyTorch's separate elementwise operations are.  The
// plain version does the same operations, so both round the same exact
// values.  In fp32 the products (48 significant bits) are still exact in
// fp64 but a sum of up to 256 of them is not: the kernel and the plain
// version round fp64 sums taken in other orders (relative error near
// 1e-16), so an fp32 score or output may differ by an ulp.  Kernel and
// plain version then agree within 1e-6 of the output's scale, well inside
// the 1e-5 the ABFT fingerprint allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
// p rounded to V's type before the P.V product (a no-op in fp32)
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// K rows are padded by 16 bytes to spread shared-memory banks
template <typename T>
__host__ __device__ constexpr int key_pad() { return 16 / sizeof(T); }

// bytes of dynamic shared memory: the K and V tiles in T (rows of 16-byte
// multiples, so every 16-byte store is aligned), then m/l/corr (3 kMaxG),
// the q and acc rows (2 G D) and the scores (G bk) in fp32
template <typename T>
size_t smem_bytes(int G, int D, int bk) {
  return (size_t)(3 * kMaxG + 2 * G * D + G * bk) * 4 +
         (size_t)bk * (2 * D + key_pad<T>()) * sizeof(T);
}

template <typename T, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, Rows rows, int KV, int G, int D, int bk,
              int max_len, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const int KS = D + key_pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                 // (bk, KS)
  T* vs = ks + bk * KS;                               // (bk, D)
  float* m_run = reinterpret_cast<float*>(vs + bk * D);  // (kMaxG,)
  float* l_run = m_run + kMaxG;                       // (kMaxG,)
  float* corr = l_run + kMaxG;                        // (kMaxG,)
  float* qs = corr + kMaxG;                           // (G, D)
  float* acc = qs + G * D;                            // (G, D)
  float* ps = acc + G * D;                            // (G, bk)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int len = min(max(lengths[b], 1), max_len);
  const long long qbase = ((long long)b * KV + h) * G * D;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f32(q[qbase + i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  const int CH = D / VEC;  // 16-byte chunks per key row
  const int n_live = (len + bk - 1) / bk;
  for (int j = 0; j < n_live; ++j) {
    const long long r0 = rows(b, j);
    for (int c = tid; c < bk * CH; c += kThreads) {
      const int t = c / CH, dc = (c % CH) * VEC;
      const long long off = ((r0 + t) * KV + h) * D + dc;
      *reinterpret_cast<uint4*>(ks + t * KS + dc) =
          *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(vs + t * D + dc) =
          *reinterpret_cast<const uint4*>(v + off);
    }
    __syncthreads();

    // scores s[g, t] = fp32(q_g . k_t) * scale, masked to -1e30
    for (int i = tid; i < G * bk; i += kThreads) {
      const int g = i / bk, t = i % bk;
      const float* qg = qs + g * D;
      const T* kt = ks + t * KS;
      double dot = 0.0;
      for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dot += (double)qg[d0 + e] * (double)to_f32(kt[d0 + e]);
      }
      const float s = __fmul_rn((float)dot, scale);
      const int kidx = j * bk + t;
      bool live = kidx < len;
      if (window >= 0) live = live && (kidx > len - 1 - window);
      ps[i] = live ? s : kNegInf;
    }
    __syncthreads();

    // online-softmax update, one warp per query head of the group
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < bk; t += 32) mx = fmaxf(mx, ps[g * bk + t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[g], mx);
      double sum = 0.0;
      for (int t = lane; t < bk; t += 32) {
        const float p = (float)exp((double)__fsub_rn(ps[g * bk + t], m_new));
        ps[g * bk + t] = p;
        sum += (double)p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = (float)exp((double)__fsub_rn(m_run[g], m_new));
        corr[g] = c;
        l_run[g] = __fadd_rn(__fmul_rn(l_run[g], c), (float)sum);
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, :] = acc * corr + fp32(round_to_T(p[g, :]) . V)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      double pv = 0.0;
      for (int t = 0; t < bk; ++t)
        pv += (double)round_to(ps[g * bk + t], vs) * (double)to_f32(vs[t * D + d]);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], corr[g]), (float)pv);
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads)
    store(out + qbase + i, __fdiv_rn(acc[i], fmaxf(l_run[i / D], 1e-30f)));
}

template <typename T, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, Rows rows, int B, int KV,
                   int G, int D, int bk, int max_len, int window, float scale,
                   cudaStream_t stream) {
  if (B < 1 || KV < 1 || G < 1 || G > kMaxG || bk < 1 || D < 8 || D > kMaxD ||
      D % 8)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(G, D, bk);
  auto kern = decode_kernel<T, Rows>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), rows, KV, G, D, bk,
      max_len, window, scale);
  return cudaGetLastError();
}

template <class Rows>
cudaError_t dispatch(int fp32, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, Rows rows, int B, int KV,
                     int G, int D, int bk, int max_len, int window, float scale,
                     cudaStream_t stream) {
  if (fp32)
    return launch<float>(q, k, v, lengths, out, rows, B, KV, G, D, bk, max_len,
                         window, scale, stream);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, rows, B, KV, G, D, bk,
                               max_len, window, scale, stream);
}

}  // namespace

// q (B, KV, G, D), k/v (B, S, KV, D), all bf16 (fp32 = 0) or all fp32
// (fp32 = 1), lengths (B,) int32 -> out (B, KV, G, D) in q's type
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int B, int S,
                            int KV, int G, int D, int bk, int fp32, float scale,
                            void* stream) {
  if (bk < 1 || S % bk) return cudaErrorInvalidValue;
  return dispatch(fp32, q, k, v, lengths, out, ContigRows{S, bk}, B, KV, G, D,
                  bk, S, -1, scale, static_cast<cudaStream_t>(stream));
}

// q (B, KV, G, D), pools (num_blocks, bs, KV, D) of q's type, tables
// (B, n_blk) and lengths (B,) int32 -> out (B, KV, G, D); window < 0 means
// none
extern "C" int flash_decode_paged(const void* q, const void* kpool,
                                  const void* vpool, const void* tables,
                                  const void* lengths, void* out, int B,
                                  int n_blk, int bs, int KV, int G, int D,
                                  int window, int fp32, float scale,
                                  void* stream) {
  PagedRows rows{static_cast<const int*>(tables), n_blk, bs};
  return dispatch(fp32, q, kpool, vpool, lengths, out, rows, B, KV, G, D, bs,
                  n_blk * bs, window, scale, static_cast<cudaStream_t>(stream));
}
