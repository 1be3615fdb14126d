// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel wkv6_pallas (repro/kernels/linear_scan/
// linear_scan.py, body _wkv_kernel).  Per (batch row b, head h), with the
// state S of shape (DK, DV) (key index i, value index j):
//
//   o_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]
//
// What bounds it: over a whole call, bytes (the streams and the state,
// read and written once) or fp32 CUDA-core operations (7 per (i, j) per
// step), whichever is larger; at decode (T = 1) the state's bytes.  The
// recurrence is sequential in T, but the columns S[:, j] evolve apart, and
// inside a column the only serial dependency is each element's own update
// (one FMA a step).  So:
//   * a block owns 16 value columns of one (b, h), 32 below kChunk steps
//     (decode) where DV allows: a grid of (DV / cols, H, B) blocks (128 at
//     one prefill row of 32 heads of 64, 512 at 8 decode rows; on the
//     card, 16-column blocks at decode, which read 64-byte halves of the
//     state's 128-byte lines, were slower: PERF.md, section 6);
//   * thread (g, q) of the block's DK x cols / 8 threads holds the state
//     elements of key rows 2g, 2g+1 and value columns 4q..4q+3 in
//     registers for the whole call; they cross device memory once each
//     way, as 16-byte loads and stores where the operands allow it;
//   * r, k, w (DK each) and the block's values of v reach shared
//     memory a chunk of up to kChunk steps at a time, through a ring of
//     kStages chunks filled by cp.async (16 bytes where the operands'
//     bases and strides allow it, else 4) ahead of use;
//   * each step a thread adds its two rows' terms of every output column
//     (row 2g first) and writes that partial to shared memory; once per
//     chunk the block adds each output's DK / 2 partials as a pairwise
//     tree ((p0 + p1) + (p2 + p3)) + ..., off the chain of updates;
//   * a one-step call (decode) reads its operands straight into registers
//     beside the state, with no ring.
// What holds it at prefill is shared memory: each element and step moves
// about 9 bytes through it (the r, k, w and v reads, the partial and its
// reduction), against 4 fp32 operations.
// The order of every sum is fixed by DK alone: an output's bits do not
// depend on B, H, DV or the grid, so a row called alone equals the same
// row in a batch, and a repeat call gives the same bits; no atomics.  A
// block owns its state elements alone, so the state may be updated in
// place (s0 == sT): each thread reads its elements before the first step
// and writes them after the last.
//
// Per element and step: kv = k v (rounded), term = fma(u, kv, S),
// partial = r term (row 2g) or fma(r, term, partial) (row 2g+1),
// S = fma(w, S, kv).
//
// Head sizes: DK and DV each 16, 32 or 64, independently (template
// instances on DK; RWKV-6 itself has 64 and 64, its -smoke config 16 and
// 16).  Layout: r, k and w share one set of strides (sb, sh, st) for their
// (B, H, T) axes, in elements, v and o another (vsb, vsh, vst), each with
// the head axis contiguous, so the caller's (B, T, H, D) activations are
// read in place through (B, H, T, D) views.  u is (H, DK) and s0, sT are
// (B, H, DK, DV), contiguous.  All fp32.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kCols = 16;    // value columns a block, T >= kChunk
constexpr int kShortCols = 32;  // value columns a block below kChunk steps (128-byte lines)
constexpr int kQuad = 4;     // value columns a thread (one 16-byte vector)
constexpr int kRows = 2;     // key rows a thread
constexpr int kChunk = 16;   // steps a ring stage at most
constexpr int kStages = 4;   // ring stages

struct Plan {
  int vec, unroll, cols, grid, threads, chunk, smem;
};

__host__ __device__ constexpr int threads_of(int dk, int cols) {
  return dk / kRows * (cols / kQuad);
}
// floats a step takes in a ring stage (r, k, w rows and the block's values)
__host__ __device__ constexpr int row_floats(int dk, int cols) { return 3 * dk + cols; }
// floats a step takes in the partial buffer (one padding row of cols)
__host__ __device__ constexpr int part_floats(int dk, int cols) {
  return (dk / kRows + 1) * cols;
}

Plan wkv_plan(int B, int H, int T, int DK, int DV, bool vec) {
  Plan p{};
  p.vec = vec ? 4 : 1;
  p.unroll = T >= kChunk ? 4 : 1;
  p.cols = T >= kChunk || DV < kShortCols ? kCols : kShortCols;
  p.grid = B * H * (DV / p.cols);
  p.threads = threads_of(DK, p.cols);
  p.chunk = T < 1 ? 1 : (T < kChunk ? T : kChunk);
  p.smem = 4 * p.chunk * (kStages * row_floats(DK, p.cols) + part_floats(DK, p.cols));
  return p;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int V>
__device__ __forceinline__ void load4(float (&s)[kQuad], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    s[0] = q.x, s[1] = q.y, s[2] = q.z, s[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < kQuad; ++e) s[e] = p[e];
  }
}

template <int V>
__device__ __forceinline__ void store4(float* p, const float (&s)[kQuad]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kQuad; ++e) p[e] = s[e];
  }
}

// One step of one thread: its two key rows' terms of its four value
// columns into p (row 2g first), and its state updated.
__device__ __forceinline__ void step_math(const float (&rs)[kRows], const float (&ks)[kRows],
                                          const float (&ws)[kRows], const float (&vs)[kQuad],
                                          const float (&ur)[kRows], float (&s)[kRows][kQuad],
                                          float (&p)[kQuad]) {
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int e = 0; e < kQuad; ++e) {
      const float kv = __fmul_rn(ks[rr], vs[e]);
      const float term = __fmaf_rn(ur[rr], kv, s[rr][e]);
      p[e] = rr == 0 ? __fmul_rn(rs[rr], term) : __fmaf_rn(rs[rr], term, p[e]);
      s[rr][e] = __fmaf_rn(ws[rr], s[rr][e], kv);
    }
  }
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// N values (a power of two) added in place as a pairwise tree: (x0 + x1),
// (x2 + x3), ..., then pairs of those, and so on.
template <int N, typename X>
__device__ __forceinline__ X tree(X (&x)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) x[i] = add(x[i], x[i + w]);
  }
  return x[0];
}

// An output's G partials (COLS floats apart; X = float, or float4 for four
// neighbouring outputs) added as one pairwise tree over g: one order,
// fixed by G = DK / 2.  The subtrees of 8 leaves are summed first and
// then joined, which is the same tree in fewer registers.
template <int G, int COLS, typename X>
__device__ __forceinline__ X tree_sum(const float* p) {
  constexpr int kLeaves = 8;  // G >= 8: DK >= 16
  X sub[G / kLeaves];
#pragma unroll
  for (int b = 0; b < G / kLeaves; ++b) {
    X x[kLeaves];
#pragma unroll
    for (int i = 0; i < kLeaves; ++i)
      x[i] = *reinterpret_cast<const X*>(p + (b * kLeaves + i) * COLS);
    sub[b] = tree<kLeaves>(x);
  }
  return tree<G / kLeaves>(sub);
}

// U steps of one thread: the operands of all U steps are read from the
// ring first, then the steps run in order (only the state carries from one
// to the next), then the U partials go to the partial buffer.
template <int DK, int COLS, int U>
__device__ __forceinline__ void run_steps(const float* row, float* part, int i0, int q,
                                          const float (&ur)[kRows], float (&s)[kRows][kQuad]) {
  constexpr int RF = row_floats(DK, COLS), PF = part_floats(DK, COLS);
  float2 rv[U], kk[U], ww[U];
  float4 vq[U];
#pragma unroll
  for (int x = 0; x < U; ++x) {
    const float* rw = row + x * RF;
    rv[x] = *reinterpret_cast<const float2*>(rw + i0);
    kk[x] = *reinterpret_cast<const float2*>(rw + DK + i0);
    ww[x] = *reinterpret_cast<const float2*>(rw + 2 * DK + i0);
    vq[x] = *reinterpret_cast<const float4*>(rw + 3 * DK + q * kQuad);
  }
#pragma unroll
  for (int x = 0; x < U; ++x) {
    const float rs[kRows] = {rv[x].x, rv[x].y}, ks[kRows] = {kk[x].x, kk[x].y};
    const float ws[kRows] = {ww[x].x, ww[x].y};
    const float vs[kQuad] = {vq[x].x, vq[x].y, vq[x].z, vq[x].w};
    float p[kQuad];
    step_math(rs, ks, ws, vs, ur, s, p);
    *reinterpret_cast<float4*>(part + x * PF) = make_float4(p[0], p[1], p[2], p[3]);
  }
}

// U = 4 steps at a time where a ring stage holds kChunk steps (T >= 16),
// else one; COLS value columns a block (kCols, or kShortCols for U = 1
// where DV allows: whole 128-byte lines of the state).  The one-step
// instances are held to 64 registers a thread so that 1024 threads share
// an SM (decode's 512 blocks of 256 threads in one wave).
template <int DK, int V, int U, int COLS>
__global__ void __launch_bounds__(DK * COLS / 8, U == 1 ? 8192 / (DK * COLS) : 1) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ o,
    float* sT, int H, int T, int DV, int C, long long sb, long long sh, long long st,
    long long vsb, long long vsh, long long vst) {
  constexpr int NT = threads_of(DK, COLS);
  constexpr int G = DK / kRows;         // partials an output adds
  constexpr int RF = row_floats(DK, COLS);
  constexpr int PF = part_floats(DK, COLS);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // [kStages][C][r DK | k DK | w DK | v COLS]
  float* part = smem + kStages * C * RF;  // [C][G + 1][COLS]

  const int tid = threadIdx.x;
  const int q = tid % (COLS / kQuad), g = tid / (COLS / kQuad);
  const int cb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int i0 = g * kRows, j0 = cb * COLS + q * kQuad;
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long vbase = (long long)b * vsb + (long long)h * vsh + cb * COLS;
  const long long sbase = (long long)bh * DK * DV + j0;

  // the state's loads go out first; the ring's prologue overlaps them
  float s[kRows][kQuad];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) load4<V>(s[rr], s0 + sbase + (long long)(i0 + rr) * DV);
  float ur[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) ur[rr] = u[h * DK + i0 + rr];
  float* my_part = part + g * COLS + q * kQuad;

  if (U == 1 && T == 1) {
    // one step (decode): the operands straight to registers beside the
    // state, one memory round trip, no ring
    float rs[kRows], ks[kRows], ws[kRows], vs[kQuad], p[kQuad];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      rs[rr] = r[base + i0 + rr];
      ks[rr] = k[base + i0 + rr];
      ws[rr] = w[base + i0 + rr];
    }
    load4<V>(vs, v + vbase + q * kQuad);
    step_math(rs, ks, ws, vs, ur, s, p);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) store4<V>(sT + sbase + (long long)(i0 + rr) * DV, s[rr]);
    *reinterpret_cast<float4*>(my_part) = make_float4(p[0], p[1], p[2], p[3]);
    __syncthreads();
    if (tid < COLS) o[vbase + tid] = tree_sum<G, COLS, float>(part + tid);
    return;
  }

  // A step's copies: F vectors of V floats (the r, k and w rows, then the
  // block's values).  With 16-byte vectors, thread tid copies vector tid % P
  // (P = F rounded up to a power of two; threads past F copy nothing) of
  // steps tid / P, tid / P + NT / P, ...: one source and one destination a
  // thread, advanced a step at a time.  4-byte copies take the vectors in
  // flat order.
  constexpr int KV = DK / V, CV = COLS / V, F = 3 * KV + CV;
  constexpr int P = F <= 16 ? 16 : (F <= 32 ? 32 : (F <= 64 ? 64 : 256));
  const float* my_src = v;
  long long my_stride = 0;
  int my_off = 0;
  const int my_f = tid % P;
  if (my_f < 3 * KV) {
    const int which = my_f / KV, i = (my_f - which * KV) * V;
    my_src = (which == 0 ? r : (which == 1 ? k : w)) + base + i;
    my_stride = st;
    my_off = which * DK + i;
  } else if (my_f < F) {
    const int j = (my_f - 3 * KV) * V;
    my_src = v + vbase + j;
    my_stride = vst;
    my_off = 3 * DK + j;
  }
  const int nch = (T + C - 1) / C;
  auto load_chunk = [&](int c) {
    float* slot = ring + (c % kStages) * C * RF;
    const int t0 = c * C, n = min(C, T - t0);
    if constexpr (V == 4 && P <= NT) {
      if (my_f < F) {
        for (int t = tid / P; t < n; t += NT / P)
          cp_async(static_cast<uint32_t>(__cvta_generic_to_shared(slot + t * RF + my_off)),
                   my_src + (t0 + t) * my_stride, 16);
      }
    } else {
      for (int e = tid; e < n * F; e += NT) {
        const int t = e / F, f = e - t * F;
        const long long tg = t0 + t;
        const float* src;
        int off;
        if (f < 3 * KV) {
          const int which = f / KV, i = (f - which * KV) * V;
          src = (which == 0 ? r : (which == 1 ? k : w)) + base + tg * st + i;
          off = which * DK + i;
        } else {
          const int j = (f - 3 * KV) * V;
          src = v + vbase + tg * vst + j;
          off = 3 * DK + j;
        }
        cp_async(static_cast<uint32_t>(__cvta_generic_to_shared(slot + t * RF + off)), src,
                 4 * V);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) load_chunk(c);
    cp_async_commit();
  }

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();               // everyone's have; the slot refilled below is free
    if (c + kStages - 1 < nch) load_chunk(c + kStages - 1);
    cp_async_commit();
    const float* slot = ring + (c % kStages) * C * RF;
    const int n = min(C, T - c * C);
    int t = 0;
    if constexpr (U > 1) {
      for (; t + U <= n; t += U)
        run_steps<DK, COLS, U>(slot + t * RF, my_part + t * PF, i0, q, ur, s);
    }
    for (; t < n; ++t) run_steps<DK, COLS, 1>(slot + t * RF, my_part + t * PF, i0, q, ur, s);
    if (c == nch - 1) {  // the state is final: its stores overlap the last reduction
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        store4<V>(sT + sbase + (long long)(i0 + rr) * DV, s[rr]);
    }
    __syncthreads();
    // each output adds its partials in tree_sum's order, four neighbouring
    // columns a thread (16-byte reads of the partials)
    for (int e = tid; e < n * (COLS / 4); e += NT) {
      const int t = e / (COLS / 4), j = (e - t * (COLS / 4)) * 4;
      const float4 sum = tree_sum<G, COLS, float4>(part + t * PF + j);
      float* po = o + vbase + ((long long)c * C + t) * vst + j;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(po) = sum;
      } else {
        po[0] = sum.x, po[1] = sum.y, po[2] = sum.z, po[3] = sum.w;
      }
    }
  }
  cp_async_wait<0>();
  if (nch == 0) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) store4<V>(sT + sbase + (long long)(i0 + rr) * DV, s[rr]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte copies and state vectors: every pointer a multiple of 16 bytes
// and every stride of 4 elements (the wrapper passes 0 for an axis of one
// element: the kernel never steps along it)
bool vec_ok(const void* r, const void* k, const void* v, const void* w, const void* s0,
            const void* o, const void* sT, long long sb, long long sh, long long st,
            long long vsb, long long vsh, long long vst) {
  const bool ptrs = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                    aligned16(s0) && aligned16(o) && aligned16(sT);
  return ptrs && ((sb | sh | st | vsb | vsh | vst) & 3) == 0;
}

template <int DK, int V, int U, int COLS>
cudaError_t launch(const Plan& p, const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* sT, int H, int T, int DV,
                   long long sb, long long sh, long long st, long long vsb, long long vsh,
                   long long vst, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<DK, V, U, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * kChunk * (kStages * row_floats(DK, COLS) + part_floats(DK, COLS)));
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int ncb = DV / COLS;
  wkv6_kernel<DK, V, U, COLS><<<dim3(ncb, H, p.grid / (ncb * H)), p.threads, p.smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), H, T, DV, p.chunk, sb, sh, st, vsb,
      vsh, vst);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_body(const Plan& p, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* o, void* sT, int H,
                        int T, int DV, long long sb, long long sh, long long st, long long vsb,
                        long long vsh, long long vst, cudaStream_t stream) {
#define WKV_LAUNCH(V, U, COLS)                                                              \
  return launch<DK, V, U, COLS>(p, r, k, v, w, u, s0, o, sT, H, T, DV, sb, sh, st, vsb, vsh, \
                                vst, stream)
#define WKV_BODIES(V)                                           \
  if (p.unroll == 4) WKV_LAUNCH(V, 4, kCols);                   \
  if (p.cols == kShortCols) WKV_LAUNCH(V, 1, kShortCols);     \
  WKV_LAUNCH(V, 1, kCols)
  if (p.vec == 4) {
    WKV_BODIES(4);
  }
  WKV_BODIES(1);
#undef WKV_BODIES
#undef WKV_LAUNCH
}

bool sizes_ok(int B, int H, int T, int DK, int DV) {
  const bool head = (DK == 16 || DK == 32 || DK == 64) && (DV == 16 || DV == 32 || DV == 64);
  return head && B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T >= 0;
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
  if (!sizes_ok(B, H, T, DK, DV)) return cudaErrorInvalidValue;
  const Plan p =
      wkv_plan(B, H, T, DK, DV, vec_ok(r, k, v, w, s0, o, sT, sb, sh, st, vsb, vsh, vst));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DK) {
    case 16:
      return launch_body<16>(p, r, k, v, w, u, s0, o, sT, H, T, DV, sb, sh, st, vsb, vsh, vst, s);
    case 32:
      return launch_body<32>(p, r, k, v, w, u, s0, o, sT, H, T, DV, sb, sh, st, vsb, vsh, vst, s);
    default:
      return launch_body<64>(p, r, k, v, w, u, s0, o, sT, H, T, DV, sb, sh, st, vsb, vsh, vst, s);
  }
}

// The plan wkv6_fp32 takes for these operands: vector width (4 or 1),
// steps a thread runs at once (4 or 1), value columns a block, blocks,
// threads a block, steps a ring stage and dynamic shared memory (7 ints).
extern "C" int wkv6_plan(const void* r, const void* k, const void* v, const void* w,
                         const void* s0, const void* o, const void* sT, int B, int H, int T,
                         int DK, int DV, long long sb, long long sh, long long st,
                         long long vsb, long long vsh, long long vst, int* result) {
  if (!sizes_ok(B, H, T, DK, DV)) return cudaErrorInvalidValue;
  const Plan p =
      wkv_plan(B, H, T, DK, DV, vec_ok(r, k, v, w, s0, o, sT, sb, sh, st, vsb, vsh, vst));
  const int out[7] = {p.vec, p.unroll, p.cols, p.grid, p.threads, p.chunk, p.smem};
  memcpy(result, out, sizeof(out));
  return cudaSuccess;
}
