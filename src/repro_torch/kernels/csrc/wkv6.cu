// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel wkv6_pallas (repro/kernels/linear_scan/
// linear_scan.py, body _wkv_kernel).  Per (batch row b, head h), with the
// state S of shape (D, D) (key index i, value index j):
//
//   o_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]
//
// What bounds it: the recurrence is sequential in T, so a call is a chain
// of T dependent steps.  Over a whole call the card's limit is bytes (the
// streams and the state, read and written once) or fp32 CUDA-core
// operations (7 per (i, j) per step), whichever is larger; at decode
// (T = 1) it is the state's bytes.  The design is the simple one that is
// right, as the RWKV project's own CUDA kernel is shaped:
//   * one thread block per (b, h), D = 64 threads, thread j owning the
//     value column S[:, j] in 64 fp32 registers for the whole call, so the
//     state crosses device memory once in and once out;
//   * each step stages r_t, k_t and w_t (64 values each) in shared memory,
//     double buffered so one __syncthreads() per step suffices, and the
//     next step's values are loaded into registers before this step's
//     arithmetic, so the global-memory latency overlaps it;
//   * thread j then walks i = 0..63 in fixed order, so the output sum has
//     one order and the result is the same run to run; no atomics.  A
//     block owns its (b, h) state alone, so the state may be updated in
//     place (s0 == sT): each thread reads its column before the first
//     step and writes it after the last.
// It fills B*H of the card's 132 SMs (32 at one prefill row of 32 heads)
// and each step is a chain of 64 dependent adds: tens of times slower than
// the bound at prefill.  A chunked-parallel form on tensor cores is later
// work.
//
// Layout: r, k, v, w and o share one set of strides (sb, sh, st) for their
// (B, H, T) axes, in elements, with the D axis contiguous, so the caller's
// (B, T, H, D) activations are read in place through a (B, H, T, D) view.
// u is (H, D) and s0, sT are (B, H, D, D), contiguous.  All fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;

__global__ void __launch_bounds__(kD) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ o,
    float* sT, int H, int T, long long sb, long long sh, long long st) {
  __shared__ __align__(16) float rs[2][kD];
  __shared__ __align__(16) float ks[2][kD];
  __shared__ __align__(16) float ws[2][kD];
  __shared__ __align__(16) float us[kD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;
  const long long base = (long long)b * sb + (long long)h * sh + j;
  const long long sbase = (long long)bh * kD * kD + j;

  float s[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) s[i] = s0[sbase + i * kD];
  us[j] = u[h * kD + j];

  float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
  if (T > 0) {
    rn = r[base];
    kn = k[base];
    wn = w[base];
    vn = v[base];
  }
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    rs[p][j] = rn;
    ks[p][j] = kn;
    ws[p][j] = wn;
    const float vj = vn;
    if (t + 1 < T) {
      const long long nxt = base + (long long)(t + 1) * st;
      rn = r[nxt];
      kn = k[nxt];
      wn = w[nxt];
      vn = v[nxt];
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const float kv = ks[p][i] * vj;
      acc += rs[p][i] * (s[i] + us[i] * kv);
      s[i] = ws[p][i] * s[i] + kv;
    }
    o[base + (long long)t * st] = acc;
  }
#pragma unroll
  for (int i = 0; i < kD; ++i) sT[sbase + i * kD] = s[i];
}

}  // namespace

// r, k, v, w, o: (B, H, T, 64) fp32 at strides (sb, sh, st, 1); u (H, 64);
// s0, sT (B, H, 64, 64) contiguous, and sT may be s0 (in-place update).
extern "C" int wkv6_fp32(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* o,
                         void* sT, int B, int H, int T, long long sb,
                         long long sh, long long st, void* stream) {
  if (B < 1 || H < 1 || T < 0) return cudaErrorInvalidValue;
  wkv6_kernel<<<B * H, kD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), H, T, sb, sh, st);
  return cudaGetLastError();
}
