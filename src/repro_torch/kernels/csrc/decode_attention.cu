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
// Head sizes 64, 128 and 256, groups of up to kMaxG = 16 query heads.  The
// query and accumulator rows (2*G*D fp32, 32 KB at G = 16, D = 256) are
// static shared memory; the K/V tile is dynamic and above 48 KB (D = 256
// with bk = 64 takes 66 KB) the launch opts in to the larger carve-out.
//
// Semantics copied exactly from the reference: lengths clamped to
// [1, max_len] (a length of 0 attends one key); masked scores are -1e30,
// not -inf; p is rounded to bf16 (V's type) before the P.V product; the
// final divide is by max(l, 1e-30); the paged window keeps k_idx >
// len - 1 - window.
//
// Bitwise equal to the plain PyTorch version (decode_attention.py), so
// that the ABFT fingerprint (kernels/abft.py), which recomputes sampled
// rows on the plain version and compares within 1e-5 of the output's
// scale, never flags a clean step.  Summation order cannot be matched
// between this loop and PyTorch's reductions, so every sum is made
// independent of its order instead: the q.k and p.V dot products and the
// split's sum of p accumulate in fp64, where the products of bf16 values
// (16 significant bits) and the few terms add exactly, and round once to
// fp32; exp runs in fp64 and rounds once; the running rescales are
// explicit round-to-nearest fp32 multiplies and adds (no FMA contraction),
// as PyTorch's separate elementwise operations are.  The plain version
// does the same operations, so both round the same exact values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;

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

template <int D>
__host__ __device__ constexpr int key_stride() { return D + 8; }  // spreads banks

template <int D>
size_t smem_bytes(int G, int bk) {
  return (size_t)bk * key_stride<D>() * 2 + (size_t)bk * D * 2 + (size_t)G * bk * 4;
}

template <int D, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out,
              Rows rows, int KV, int G, int bk, int max_len, int window,
              float scale) {
  constexpr int KS = key_stride<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // (bk, KS)
  __nv_bfloat16* vs = ks + bk * KS;                             // (bk, D)
  float* ps = reinterpret_cast<float*>(vs + bk * D);            // (G, bk)
  __shared__ float qs[kMaxG * D];
  __shared__ float acc[kMaxG * D];
  __shared__ float m_run[kMaxG], l_run[kMaxG], corr[kMaxG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int len = min(max(lengths[b], 1), max_len);
  const long long qbase = ((long long)b * KV + h) * G * D;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = __bfloat162float(q[qbase + i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  constexpr int CH = D / 8;  // 16-byte chunks per key row
  const int n_live = (len + bk - 1) / bk;
  for (int j = 0; j < n_live; ++j) {
    const long long r0 = rows(b, j);
    for (int c = tid; c < bk * CH; c += kThreads) {
      const int t = c / CH, dc = (c % CH) * 8;
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
      double dot = 0.0;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        dot += (double)qs[g * D + d] * (double)__bfloat162float(ks[t * KS + d]);
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

    // acc[g, :] = acc * corr + fp32(bf16(p[g, :]) . V)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      double pv = 0.0;
      for (int t = 0; t < bk; ++t)
        pv += (double)__bfloat162float(__float2bfloat16(ps[g * bk + t])) *
              (double)__bfloat162float(vs[t * D + d]);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], corr[g]), (float)pv);
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads)
    out[qbase + i] = __float2bfloat16(__fdiv_rn(acc[i], fmaxf(l_run[i / D], 1e-30f)));
}

template <int D, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, Rows rows, int B, int KV,
                   int G, int bk, int max_len, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(G, bk);
  auto kern = decode_kernel<D, Rows>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), rows, KV, G, bk, max_len, window, scale);
  return cudaGetLastError();
}

template <class Rows>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, Rows rows, int B, int KV,
                     int G, int bk, int max_len, int window, float scale,
                     cudaStream_t stream) {
  if (B < 1 || KV < 1 || G < 1 || G > kMaxG || bk < 1) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, lengths, out, rows, B, KV, G, bk, max_len,
                        window, scale, stream);
    case 128:
      return launch<128>(q, k, v, lengths, out, rows, B, KV, G, bk, max_len,
                         window, scale, stream);
    case 256:
      return launch<256>(q, k, v, lengths, out, rows, B, KV, G, bk, max_len,
                         window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV, G, D), k/v (B, S, KV, D) bf16, lengths (B,) int32 -> out (B, KV, G, D)
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int B, int S,
                            int KV, int G, int D, int bk, float scale,
                            void* stream) {
  if (bk < 1 || S % bk) return cudaErrorInvalidValue;
  return dispatch(D, q, k, v, lengths, out, ContigRows{S, bk}, B, KV, G, bk, S,
                  -1, scale, static_cast<cudaStream_t>(stream));
}

// q (B, KV, G, D), pools (num_blocks, bs, KV, D) bf16, tables (B, n_blk) and
// lengths (B,) int32 -> out (B, KV, G, D); window < 0 means none
extern "C" int flash_decode_paged(const void* q, const void* kpool,
                                  const void* vpool, const void* tables,
                                  const void* lengths, void* out, int B,
                                  int n_blk, int bs, int KV, int G, int D,
                                  int window, float scale, void* stream) {
  PagedRows rows{static_cast<const int*>(tables), n_blk, bs};
  return dispatch(D, q, kpool, vpool, lengths, out, rows, B, KV, G, bs,
                  n_blk * bs, window, scale, static_cast<cudaStream_t>(stream));
}
