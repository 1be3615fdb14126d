// Tiled bf16 GEMM for Hopper (sm_90a): C = A @ B or A @ B^T, fp32
// accumulation, bf16 store.
//
// Replaces the TPU kernel matmul_pallas (repro/kernels/matmul/matmul.py):
// a blocked (M, K) @ (K, N) with K innermost and an fp32 accumulator cast
// at the store.  Where the reference's ops.matmul pads the inputs to tile
// multiples and slices the result, this kernel masks the ragged edges
// itself: out-of-range loads read zeros and out-of-range stores are
// skipped, so no operand is ever copied.  B comes row-major as (K, N), or
// as (N, K) with trans_b = 1, which serves the tied unembedding x @ tok^T
// without copying the (vocab, d_model) table.
//
// What bounds it: on the decode path M is the slot count (8), so every
// product is a skinny GEMM that reads each weight once and does 2*M flops
// per weight element -- bytes bound, by the weights.  Prefill (M = the
// admitted prompt tokens) is operations bound.  The design: each block
// stages a BM x 32 tile of A and a 32 x BN tile of B in shared memory with
// 16-byte loads where the row is aligned, and four warps multiply them on
// the tensor cores through WMMA 16x16x16 bf16 fragments with fp32
// accumulators.  Skinny M (<= 16) takes a 16 x 64 block tile so no MMA row
// work is wasted; larger M takes 64 x 64.  No split-K: every output is
// summed by one block in a fixed order, so results are deterministic.
// Fixed tiles, no TMA/wgmma pipeline and one block per 64 output columns
// leave a skinny GEMM well short of HBM bandwidth; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BK = 32;
constexpr int PAD = 8;

// Copy a ROWS x COLS tile at (row0, col0) of a row-major (nrows, ncols)
// matrix with leading dimension ld into shared memory (row stride LDS),
// zero-filling everything outside the matrix.
template <int ROWS, int COLS, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int col0, int nrows, int ncols,
                                          int ld, bool vec_ok) {
  constexpr int CH = COLS / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const int gr = row0 + r, gc = col0 + cc;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) {
      const bf16* p = src + (long long)gr * ld + gc;
      if (vec_ok && gc + 8 <= ncols) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned short tmp[8];
        const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int e = 0; e < 8; ++e) tmp[e] = (gc + e < ncols) ? ps[e] : 0;
        memcpy(&val, tmp, sizeof(val));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + cc) = val;
  }
}

template <int BM, int BN, int WM, int WN, bool TRANS_B>
__global__ void __launch_bounds__(WM * WN * 32)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            bf16* __restrict__ C, int M, int N, int K, bool vec_a, bool vec_b) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int FM = BM / (16 * WM), FN = BN / (16 * WN);
  constexpr int LDA = BK + PAD;
  constexpr int LDB = TRANS_B ? BK + PAD : BN + PAD;
  constexpr int LDC = BN + 4;
  using BLayout =
      typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;

  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[(TRANS_B ? BN : BK) * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, BK, LDA, THREADS>(As, A, m0, k0, M, K, K, vec_a);
    if (TRANS_B)  // B is (N, K): tile rows are output columns
      load_tile<BN, BK, LDB, THREADS>(Bs, B, n0, k0, N, K, K, vec_b);
    else          // B is (K, N)
      load_tile<BK, BN, LDB, THREADS>(Bs, B, k0, n0, K, N, N, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * FM * 16 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = wn * FN * 16 + j * 16;
        wmma::load_matrix_sync(b[j], TRANS_B ? Bs + n * LDB + kk : Bs + kk * LDB + n,
                               LDB);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * LDC + wn * FN * 16 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) C[(long long)gr * N + gc] = __float2bfloat16(Cs[r * LDC + c]);
  }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const bf16* A, const bf16* B, bf16* C, int M, int N, int K,
                   bool trans_b, bool vec_a, bool vec_b, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (trans_b)
    gemm_kernel<BM, BN, WM, WN, true>
        <<<grid, WM * WN * 32, 0, stream>>>(A, B, C, M, N, K, vec_a, vec_b);
  else
    gemm_kernel<BM, BN, WM, WN, false>
        <<<grid, WM * WN * 32, 0, stream>>>(A, B, C, M, N, K, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// A (M, K), B (K, N) or (N, K) when trans_b, C (M, N); all bf16 row-major
extern "C" int gemm_bf16(const void* a, const void* b, void* c, int M, int N,
                         int K, int trans_b, void* stream) {
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bool vec_a = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b =
      (trans_b ? K : N) % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    return launch<16, 64, 1, 4>(A, B, static_cast<bf16*>(c), M, N, K, trans_b != 0,
                                vec_a, vec_b, s);
  return launch<64, 64, 2, 2>(A, B, static_cast<bf16*>(c), M, N, K, trans_b != 0,
                              vec_a, vec_b, s);
}
