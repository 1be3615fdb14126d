// Diagonal linear recurrence (the RG-LRU scan) for Hopper (sm_90a).
//
// Replaces the TPU kernel linear_scan_pallas (repro/kernels/linear_scan/
// linear_scan.py, body _diag_kernel).  Per batch row b and channel d:
//
//   h_t[d] = a_t[d] * h_{t-1}[d] + x_t[d],   out[b, t, d] = h_t[d]
//
// with h_{-1} = h0[b, d]; the final h goes to hT[b, d].
//
// What bounds it: bytes.  Each step reads a and x and writes out, 12 bytes
// per element against 2 operations, far below the card's ridge; the state
// is read and written once.  But the recurrence is a chain of T dependent
// steps per channel, so a call is also bounded below by T times one step's
// latency.  The design is the one the reference's own note names (one
// thread per channel):
//   * one thread per (b, d), 64 channels per block, channels contiguous
//     across a warp, so every step's loads of a and x and its store of
//     out are 128-byte coalesced rows;
//   * h stays in a register for all T;
//   * a and x are read kU = 16 steps at a time, and the next chunk's 32
//     loads are issued before this chunk's dependent chain, so a step
//     waits for a memory round trip once per chunk, not once per step;
//   * each step is one round-to-nearest fp32 multiply and one add with no
//     FMA contraction (__fmul_rn, __fadd_rn), the two separate operations
//     of the plain PyTorch version (h = a * h, then h = h + x), so the two
//     are bitwise equal.
// A thread owns its channel's state alone, so the state may be updated in
// place (h0 == hT: each thread reads its element before the first step
// and writes it after the last); no atomics, one order, the same bits run
// to run.  At one prefill row it fills D / 64 blocks (40 at D = 2560).
//
// Layout: a and x are (B, T, D) with their own (b, t) strides in elements
// and the D axis contiguous; out is (B, T, D) contiguous; h0 and hT are
// (B, D) with their own row strides.  All fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kU = 16;

__global__ void __launch_bounds__(kThreads) linear_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ x, const float* h0,
    float* __restrict__ out, float* hT, int T, int D, long long a_sb,
    long long a_st, long long x_sb, long long x_st, long long h0_sb,
    long long hT_sb) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int b = blockIdx.y;
  const float* ap = a + (long long)b * a_sb + d;
  const float* xp = x + (long long)b * x_sb + d;
  float* op = out + (long long)b * T * D + d;
  float h = h0[(long long)b * h0_sb + d];

  float ca[kU], cx[kU];
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    ca[i] = i < T ? __ldg(ap + i * a_st) : 0.f;
    cx[i] = i < T ? __ldg(xp + i * x_st) : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += kU) {
    // the next chunk's loads go out before this chunk's chain
    float na[kU], nx[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const long long t = t0 + kU + i;
      na[i] = t < T ? __ldg(ap + t * a_st) : 0.f;
      nx[i] = t < T ? __ldg(xp + t * x_st) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int t = t0 + i;
      if (t < T) {
        h = __fadd_rn(__fmul_rn(ca[i], h), cx[i]);
        op[(long long)t * D] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      ca[i] = na[i];
      cx[i] = nx[i];
    }
  }
  hT[(long long)b * hT_sb + d] = h;
}

}  // namespace

// a, x (B, T, D) strided fp32 (last axis contiguous), h0 (B, D) -> out
// (B, T, D) contiguous, hT (B, D); hT may be h0 itself
extern "C" int linear_scan_fp32(const void* a, const void* x, const void* h0,
                                void* out, void* hT, int B, int T, int D,
                                long long a_sb, long long a_st, long long x_sb,
                                long long x_st, long long h0_sb,
                                long long hT_sb, void* stream) {
  if (B < 1 || B > 65535 || T < 0 || D < 1) return cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  linear_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(out),
      static_cast<float*>(hT), T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb);
  return cudaGetLastError();
}
