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
// is read and written once.  The recurrence is also a chain of T dependent
// steps per channel (one rounded multiply, one rounded add: ~8 cycles a
// step, ~9 us for 2048 steps), which is below the byte bound at one
// prefill row (63 MB, ~19 us) only if the card keeps several MB in flight
// while the chains run.  Each step is __fmul_rn then __fadd_rn, the two
// operations of the plain PyTorch version (h = a * h, then h = h + x), in
// step order, one thread per channel, so the two are bitwise equal at
// every shape; no atomics, one order, the same bits run to run.  Two
// bodies, picked inside (scan_plan, mirrored by linear_scan.scan_plan):
//
//   * the step body, T <= kStepMaxT (decode): one thread per 4 channels
//     (16-byte loads and stores where every operand allows them, else one
//     channel), 128 threads a block, a row of blocks per batch row (no
//     index division); a thread issues the loads of all its T steps and
//     its state at once, so a call costs one memory round trip, and a
//     one-step call runs an instance compiled for one step;
//   * the ring body, T > kStepMaxT (prefill): one warp per (row, 32
//     channels), so one 2048 x 2560 row fills 80 blocks.  The warp keeps a
//     96 KB ring in shared memory: stages of 128 steps of a and x (32 KB)
//     beyond T = 64, else one of 64, filled ahead of the chain: by TMA (a
//     3-D box of 32 channels x the stage's steps x 1 row, zeros outside the
//     tensor, one elected lane) where the operands' base and strides are
//     16-byte multiples, else by 4-byte cp.async from every lane
//     (zero-filled past the edges).  A stage is refilled as soon as the
//     chain has left it, so ~8 MB is in flight over the card.  On the card
//     a stage costs a fixed time beyond its bytes, so rows of more than 64
//     steps run faster on 128-step stages, and a row of up to 64 steps on
//     one box of 64, not a mostly empty one of 128 (PERF.md, section 6).
//
// A thread owns its channels' state alone, so the state may be updated in
// place (h0 == hT: each thread reads its elements before the first step
// and writes them after the last).
//
// Layout: a and x are (B, T, D) with their own (b, t) strides in elements
// and the D axis contiguous; out is (B, T, D) contiguous; h0 and hT are
// (B, D) with their own row strides.  All fp32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kStepMaxT = 8;     // the step body up to here
constexpr int kStepThreads = 128;
constexpr int kCT = 32;          // channels a ring block (one 128-byte row a step)
constexpr int kLongT = 65;       // stages of 128 steps from here, one of 64 below
constexpr int kRingBytes = 6 * 2 * 64 * kCT * 4;  // 96 KB: 6 stages of 64 steps, 3 of 128

__host__ __device__ constexpr int stage_bytes(int steps) { return 2 * steps * kCT * 4; }

enum Body { kStep4 = 0, kStep1 = 1, kRingTma = 2, kRingCopy = 3 };

struct Plan {
  int body, grid_x, grid_y, threads, steps, stages, smem;
};

__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

// ------------------------------------------------------------ step body --

template <int V>
__device__ __forceinline__ void load(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// TMAX = 1 for one step (decode), else kStepMaxT (T steps, T <= TMAX)
template <int V, int TMAX>
__global__ void __launch_bounds__(kStepThreads) linear_scan_step_kernel(
    const float* __restrict__ a, const float* __restrict__ x, const float* h0,
    float* __restrict__ out, float* hT, int T, int D, long long a_sb,
    long long a_st, long long x_sb, long long x_st, long long h0_sb,
    long long hT_sb) {
  const int b = blockIdx.y;
  const int d = (blockIdx.x * kStepThreads + threadIdx.x) * V;
  if (d >= D) return;
  float h[V], av[TMAX][V], xv[TMAX][V];
  const float* pa = a + b * a_sb + d;
  const float* px = x + b * x_sb + d;
  float* po = out + ((long long)b * T) * D + d;
  load<V>(h, h0 + b * h0_sb + d);
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if (t < T) {
      load<V>(av[t], pa + t * a_st);
      load<V>(xv[t], px + t * x_st);
    }
  }
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if (t < T) {
#pragma unroll
      for (int e = 0; e < V; ++e) h[e] = step(av[t][e], h[e], xv[t][e]);
      store<V>(po + (long long)t * D, h);
    }
  }
  store<V>(hT + b * hT_sb + d, h);
}

template <int V>
cudaError_t launch_step(const Plan& p, const float* a, const float* x, const float* h0,
                        float* out, float* hT, int T, int D, long long a_sb, long long a_st,
                        long long x_sb, long long x_st, long long h0_sb, long long hT_sb,
                        cudaStream_t s) {
  const dim3 grid(p.grid_x, p.grid_y);
  if (T == 1)
    linear_scan_step_kernel<V, 1><<<grid, p.threads, 0, s>>>(
        a, x, h0, out, hT, T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb);
  else
    linear_scan_step_kernel<V, kStepMaxT><<<grid, p.threads, 0, s>>>(
        a, x, h0, out, hT, T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb);
  return cudaGetLastError();
}

// ------------------------------------------------------------ ring body --

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// the barrier's phase completes when all of this thread's earlier
// cp.async have landed (counted against the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

template <bool TMA, int kS>
__global__ void __launch_bounds__(32) linear_scan_ring_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
    const float* __restrict__ a, const float* __restrict__ x, const float* h0,
    float* __restrict__ out, float* hT, int T, int D, int slots, long long a_sb,
    long long a_st, long long x_sb, long long x_st, long long h0_sb, long long hT_sb) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [slot][a, x][kS][kCT]
  constexpr int kStageBytes = stage_bytes(kS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + slots * kStageBytes);
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * kCT, d = d0 + lane, b = blockIdx.y;
  const bool live = d < D;
  const int nst = (T + kS - 1) / kS;

  if (lane == 0) {
    for (int i = 0; i < slots; ++i) hopper::mbar_init(hopper::smem_u32(&full[i]), TMA ? 1 : 32);
    hopper::fence_mbar_init();
    if (TMA) {
      hopper::prefetch_tensor_map(&map_a);
      hopper::prefetch_tensor_map(&map_x);
    }
  }
  __syncwarp();

  const float* pa = a + (long long)b * a_sb + d;
  const float* px = x + (long long)b * x_sb + d;
  auto issue = [&](int st) {
    const int slot = st % slots;
    float* sa = ring + slot * (2 * kS * kCT);
    float* sx = sa + kS * kCT;
    const uint32_t bar = hopper::smem_u32(&full[slot]);
    if (TMA) {
      if (lane == 0) {
        hopper::mbar_expect_tx(bar, kStageBytes);
        hopper::tma_load_3d(hopper::smem_u32(sa), &map_a, bar, d0, st * kS, b);
        hopper::tma_load_3d(hopper::smem_u32(sx), &map_x, bar, d0, st * kS, b);
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < kS; ++i) {
        const long long t = (long long)st * kS + i;
        const bool ok = live && t < T;
        cp_async4(hopper::smem_u32(sa + i * kCT + lane), ok ? pa + t * a_st : a, ok);
        cp_async4(hopper::smem_u32(sx + i * kCT + lane), ok ? px + t * x_st : x, ok);
      }
      cp_async_arrive(bar);
    }
  };
  for (int st = 0; st < slots && st < nst; ++st) issue(st);

  float h = live ? h0[(long long)b * h0_sb + d] : 0.f;
  // out's address advances by one row a step for every lane, live or not
  // (no branch in the chain); only live lanes store
  float* op = out + (long long)b * T * D + d;
  for (int st = 0; st < nst; ++st) {
    const int slot = st % slots;
    hopper::mbar_wait(hopper::smem_u32(&full[slot]), (st / slots) & 1);
    const float* sa = ring + slot * (2 * kS * kCT) + lane;
    const float* sx = sa + kS * kCT;
    const int n = min(kS, T - st * kS);
    if (n == kS) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        h = step(sa[i * kCT], h, sx[i * kCT]);
        if (live) op[0] = h;
        op += D;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        h = step(sa[i * kCT], h, sx[i * kCT]);
        if (live) op[0] = h;
        op += D;
      }
    }
    // every lane has read the stage (each step's value fed its store)
    __syncwarp();
    if (st + slots < nst) {
      hopper::fence_async_shared();
      issue(st + slots);
    }
  }
  if (live) hT[(long long)b * hT_sb + d] = h;
}

// ------------------------------------------------------------------ host --

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the stride of an axis of n elements, 0 when the kernel never steps along it
long long live_stride(long long s, long long n) { return n > 1 ? s : 0; }

bool vec4(long long s) { return (s & 3) == 0; }

Plan scan_plan(int B, int T, int D, bool step_vec, bool ring_tma) {
  Plan p{};
  if (T <= kStepMaxT) {
    const int v = step_vec ? 4 : 1;
    p.body = step_vec ? kStep4 : kStep1;
    p.grid_x = (D / v + kStepThreads - 1) / kStepThreads;
    p.grid_y = B;
    p.threads = kStepThreads;
    return p;
  }
  p.body = ring_tma ? kRingTma : kRingCopy;
  p.grid_x = (D + kCT - 1) / kCT;
  p.grid_y = B;
  p.threads = 32;
  p.steps = T >= kLongT ? 128 : 64;
  const int nst = (T + p.steps - 1) / p.steps, most = kRingBytes / stage_bytes(p.steps);
  p.stages = nst < most ? nst : most;
  p.smem = p.stages * stage_bytes(p.steps) + 8 * p.stages;
  return p;
}

// the operands as the plan sees them: 16-byte vectors for the step body
// (every pointer and stride a multiple of 16 bytes, D of 4), TMA for the
// ring body (a's and x's bases and strides; a box may reach past D and T)
void eligibility(const void* a, const void* x, const void* h0, const void* out,
                 const void* hT, int B, int T, int D, long long a_sb, long long a_st,
                 long long x_sb, long long x_st, long long h0_sb, long long hT_sb,
                 bool* step_vec, bool* ring_tma) {
  const long long sa_b = live_stride(a_sb, B), sa_t = live_stride(a_st, T);
  const long long sx_b = live_stride(x_sb, B), sx_t = live_stride(x_st, T);
  const bool streams = aligned16(a) && aligned16(x) && vec4(sa_b) && vec4(sa_t) &&
                       vec4(sx_b) && vec4(sx_t);
  *step_vec = streams && D % 4 == 0 && aligned16(h0) && aligned16(hT) && aligned16(out) &&
              vec4(live_stride(h0_sb, B)) && vec4(live_stride(hT_sb, B));
  // a broadcast axis (stride 0 over several elements) has no tensor map
  *ring_tma = streams && sa_t > 0 && sx_t > 0 && (B == 1 || (sa_b > 0 && sx_b > 0));
}

// A 3-D fp32 tensor map over (D, T, B) with the given element strides of
// T and B (each a multiple of 4, or 0 where the axis has one element) and
// a box of kCT channels x `steps` steps x 1 row.
cudaError_t stream_map(CUtensorMap* map, const void* ptr, int B, int T, int D, long long s_b,
                       long long s_t, int steps) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long pitch_t = s_t ? s_t * 4 : ((long long)D * 4 + 15) / 16 * 16;
  const long long pitch_b = s_b ? s_b * 4 : pitch_t * T;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch_t, (cuuint64_t)pitch_b};
  const cuuint32_t box[3] = {kCT, (cuuint32_t)steps, 1}, elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool TMA, int kS>
cudaError_t launch_ring(const Plan& p, const void* a, const void* x, const void* h0, void* out,
                        void* hT, int B, int T, int D, long long a_sb, long long a_st,
                        long long x_sb, long long x_st, long long h0_sb, long long hT_sb,
                        cudaStream_t stream) {
  CUtensorMap ma, mx;
  memset(&ma, 0, sizeof(ma));
  memset(&mx, 0, sizeof(mx));
  if (TMA) {
    cudaError_t err =
        stream_map(&ma, a, B, T, D, live_stride(a_sb, B), live_stride(a_st, T), kS);
    if (err == cudaSuccess)
      err = stream_map(&mx, x, B, T, D, live_stride(x_sb, B), live_stride(x_st, T), kS);
    if (err != cudaSuccess) return err;
  }
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_scan_ring_kernel<TMA, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes + 8 * (kRingBytes / stage_bytes(kS)));
    if (err != cudaSuccess) return err;
    attr = true;
  }
  linear_scan_ring_kernel<TMA, kS><<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      ma, mx, static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(out), static_cast<float*>(hT), T, D,
      p.stages, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb);
  return cudaGetLastError();
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
  bool step_vec, ring_tma;
  eligibility(a, x, h0, out, hT, B, T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb, &step_vec,
              &ring_tma);
  const Plan p = scan_plan(B, T, D, step_vec, ring_tma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fx = static_cast<const float*>(x);
  const float* fh = static_cast<const float*>(h0);
  float* fo = static_cast<float*>(out);
  float* ft = static_cast<float*>(hT);
  switch (p.body) {
    case kStep4:
      return launch_step<4>(p, fa, fx, fh, fo, ft, T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb,
                            s);
    case kStep1:
      return launch_step<1>(p, fa, fx, fh, fo, ft, T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb,
                            s);
#define SCAN_RING(TMA, S)                                                                  \
  return launch_ring<TMA, S>(p, a, x, h0, out, hT, B, T, D, a_sb, a_st, x_sb, x_st, h0_sb, \
                             hT_sb, s)
    case kRingTma:
      if (p.steps == 128) SCAN_RING(true, 128);
      SCAN_RING(true, 64);
    default:
      if (p.steps == 128) SCAN_RING(false, 128);
      SCAN_RING(false, 64);
#undef SCAN_RING
  }
}

// The plan linear_scan_fp32 takes for these operands: body, grid (x, y),
// threads a block, steps a ring stage, ring stages and dynamic shared
// memory (7 ints).
extern "C" int linear_scan_plan(const void* a, const void* x, const void* h0, const void* out,
                                const void* hT, int B, int T, int D, long long a_sb,
                                long long a_st, long long x_sb, long long x_st,
                                long long h0_sb, long long hT_sb, int* result) {
  if (B < 1 || B > 65535 || T < 0 || D < 1) return cudaErrorInvalidValue;
  bool step_vec, ring_tma;
  eligibility(a, x, h0, out, hT, B, T, D, a_sb, a_st, x_sb, x_st, h0_sb, hT_sb, &step_vec,
              &ring_tma);
  const Plan p = scan_plan(B, T, D, step_vec, ring_tma);
  const int v[7] = {p.body, p.grid_x, p.grid_y, p.threads, p.steps, p.stages, p.smem};
  memcpy(result, v, sizeof(v));
  return cudaSuccess;
}
