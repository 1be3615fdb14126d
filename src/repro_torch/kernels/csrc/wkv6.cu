// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel wkv6_pallas (repro/kernels/linear_scan/
// linear_scan.py, body _wkv_kernel).  Per (batch row b, head h), with the
// state S of shape (DK, DV) (key index i, value index j):
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
//   * one thread block per (b, h), DV threads, thread j owning the value
//     column S[:, j] in DK fp32 registers for the whole call, so the state
//     crosses device memory once in and once out;
//   * each step stages r_t, k_t and w_t (DK values each) in shared memory,
//     double buffered so one __syncthreads() per step suffices; the values
//     of step t + 2 are requested during step t and wait in registers, so
//     a load has two steps' arithmetic to land in (with one step of
//     headroom the compiler sank the loads into the arithmetic and their
//     latency showed);
//   * thread j then walks i = 0..DK-1 in fixed order, so the output sum has
//     one order and the result is the same run to run; no atomics.  A
//     block owns its (b, h) state alone, so the state may be updated in
//     place (s0 == sT): each thread reads its column before the first
//     step and writes it after the last.
// It fills B*H of the card's 132 SMs (32 at one prefill row of 32 heads)
// and each step is a chain of DK dependent adds: tens of times slower than
// the bound at prefill.  A chunked-parallel form on tensor cores is later
// work.
//
// Head sizes: DK and DV each 16, 32 or 64, independently (template
// instances; RWKV-6 itself has 64 and 64, its -smoke config 16 and 16).
// Layout: r, k and w share one set of strides (sb, sh, st) for their
// (B, H, T) axes, in elements, v and o another (vsb, vsh, vst), each with
// the head axis contiguous, so the caller's (B, T, H, D) activations are
// read in place through (B, H, T, D) views.  u is (H, DK) and s0, sT are
// (B, H, DK, DV), contiguous.  All fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int DK, int DV>
__global__ void __launch_bounds__(DV) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ o,
    float* sT, int H, int T, long long sb, long long sh, long long st,
    long long vsb, long long vsh, long long vst) {
  constexpr int KPT = (DK + DV - 1) / DV;  // key-axis values each thread stages
  constexpr bool kEven = KPT * DV == DK;    // every thread stages KPT of them
  __shared__ __align__(16) float rs[2][DK];
  __shared__ __align__(16) float ks[2][DK];
  __shared__ __align__(16) float ws[2][DK];
  __shared__ __align__(16) float us[DK];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long vbase = (long long)b * vsb + (long long)h * vsh + j;
  const long long sbase = (long long)bh * DK * DV + j;

  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = s0[sbase + i * DV];
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int i = j + e * DV;
    if (kEven || i < DK) us[i] = u[h * DK + i];
  }

  // operands of step t (rn, ...) and t + 1 (rm, ...) in registers; step
  // t + 2 is requested during step t, so each load has two steps to land
  float rn[KPT], kn[KPT], wn[KPT], rm[KPT], km[KPT], wm[KPT], vn = 0.f, vm = 0.f;
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int i = j + e * DV;
    const bool ok = kEven || i < DK;
    rn[e] = ok && T > 0 ? r[base + i] : 0.f;
    kn[e] = ok && T > 0 ? k[base + i] : 0.f;
    wn[e] = ok && T > 0 ? w[base + i] : 0.f;
    rm[e] = ok && T > 1 ? r[base + st + i] : 0.f;
    km[e] = ok && T > 1 ? k[base + st + i] : 0.f;
    wm[e] = ok && T > 1 ? w[base + st + i] : 0.f;
  }
  if (T > 0) vn = v[vbase];
  if (T > 1) vm = v[vbase + vst];
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int i = j + e * DV;
      if (kEven || i < DK) {
        rs[p][i] = rn[e];
        ks[p][i] = kn[e];
        ws[p][i] = wn[e];
      }
      rn[e] = rm[e];
      kn[e] = km[e];
      wn[e] = wm[e];
    }
    const float vj = vn;
    vn = vm;
    if (t + 2 < T) {
      const long long nxt = base + (long long)(t + 2) * st;
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        const int i = j + e * DV;
        if (kEven || i < DK) {
          rm[e] = r[nxt + i];
          km[e] = k[nxt + i];
          wm[e] = w[nxt + i];
        }
      }
      vm = v[vbase + (long long)(t + 2) * vst];
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DK; ++i) {
      const float kv = ks[p][i] * vj;
      acc += rs[p][i] * (s[i] + us[i] * kv);
      s[i] = ws[p][i] * s[i] + kv;
    }
    o[vbase + (long long)t * vst] = acc;
  }
#pragma unroll
  for (int i = 0; i < DK; ++i) sT[sbase + i * DV] = s[i];
}

template <int DK, int DV>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* sT, int B,
                   int H, int T, long long sb, long long sh, long long st,
                   long long vsb, long long vsh, long long vst,
                   cudaStream_t stream) {
  wkv6_kernel<DK, DV><<<B * H, DV, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), H, T, sb, sh, st, vsb,
      vsh, vst);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_dv(int DV, const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0, void* o,
                      void* sT, int B, int H, int T, long long sb, long long sh,
                      long long st, long long vsb, long long vsh, long long vst,
                      cudaStream_t stream) {
  switch (DV) {
    case 16:
      return launch<DK, 16>(r, k, v, w, u, s0, o, sT, B, H, T, sb, sh, st, vsb,
                            vsh, vst, stream);
    case 32:
      return launch<DK, 32>(r, k, v, w, u, s0, o, sT, B, H, T, sb, sh, st, vsb,
                            vsh, vst, stream);
    case 64:
      return launch<DK, 64>(r, k, v, w, u, s0, o, sT, B, H, T, sb, sh, st, vsb,
                            vsh, vst, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, w: (B, H, T, DK) fp32 at strides (sb, sh, st, 1); v, o: (B, H, T, DV)
// at (vsb, vsh, vst, 1); u (H, DK); s0, sT (B, H, DK, DV) contiguous, and sT
// may be s0 (in-place update).  DK and DV each 16, 32 or 64.
extern "C" int wkv6_fp32(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* o,
                         void* sT, int B, int H, int T, int DK, int DV,
                         long long sb, long long sh, long long st,
                         long long vsb, long long vsh, long long vst,
                         void* stream) {
  if (B < 1 || H < 1 || T < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DK) {
    case 16:
      return launch_dv<16>(DV, r, k, v, w, u, s0, o, sT, B, H, T, sb, sh, st,
                           vsb, vsh, vst, s);
    case 32:
      return launch_dv<32>(DV, r, k, v, w, u, s0, o, sT, B, H, T, sb, sh, st,
                           vsb, vsh, vst, s);
    case 64:
      return launch_dv<64>(DV, r, k, v, w, u, s0, o, sT, B, H, T, sb, sh, st,
                           vsb, vsh, vst, s);
    default:
      return cudaErrorInvalidValue;
  }
}
