// Direct conv2d for Hopper (sm_90a) as an implicit GEMM: NHWC input, HWIO
// filter, fp32 accumulation, output in the operands' type (bf16 or fp32);
// valid, stride 1.
//
// Replaces the TPU kernel conv2d_pallas (repro/kernels/conv2d/conv2d.py),
// the paper's Algorithm-1 CONV nest.  The TPU kernel holds a whole image
// of bc channels in VMEM and accumulates (Ho*Wo, bk) in fp32 across a
// sequential C grid axis.  A Hopper block has 227 KB of shared memory, so
// this kernel tiles the output pixels as well: one block per (nb images x
// bx x by output pixels, bk output channels), the reduction over C inside
// the block.  The tile comes from the paper's blocking search on the
// H100 as hw.hopper_levels() and hw.hopper_array() describe it
// (kernels/conv2d/ops.py).
//
// What bounds it: every 3x3 and 5x5 layer of the paper's CNNs does 300-2000
// operations per byte of input, filter and output, so it is bound by
// operations (989 TFLOP/s bf16 on the tensor cores); the 1x1 layers and
// vgg16/conv1 (C = 3) by bytes (3.35 TB/s).  The design feeds the tensor
// cores at their own rate and keeps loads out of the threads' way:
//
// - Warp roles.  Three warpgroups: one producer thread issues TMA loads
//   into a ring of 2-4 stages, each stage one bc-channel step: the haloed
//   input tile (nb x (bx+FX-1) x (by+FY-1) pixels x bc) and the filter
//   slice (FX x FY x bc x bk), signalled by an mbarrier per stage (full)
//   and released by the consumers through another (empty).  Two consumer
//   warpgroups hold the 128 x bk fp32 output tile in registers (rows 0-63
//   and 64-127 of the block's pixels) and run wgmma.mma_async m64nNk16
//   (N = bk up to 128, 64 beyond).
// - B (the filter) from shared memory through a wgmma descriptor: TMA
//   writes each 64-column panel of the HWIO rows with the 128-byte
//   swizzle, N-major, which bf16 wgmma reads transposed.
// - A (the input window shifted by (fx, fy)) from registers: its rows are
//   pixels whose addresses are not a uniform stride apart, so each lane
//   finds its own pixel row with ldmatrix (the swizzle's XOR applied) and
//   no im2col copy is made.  A tap's bc / 16 fragments load together and
//   its wgmmas go out behind one fence as one group: each group waits on
//   its ldmatrix and on the group before it, so a group per 16 channels
//   left the tensor cores idle (measured: PERF.md).  Up to 128 columns two
//   fragment sets alternate, so the next tap's load overlaps this tap's
//   group.
// - Edges: TMA fills zeros past H, W, C, K and B; stores are masked per
//   thread.  C and K that are not multiples of 8 (a row stride TMA cannot
//   describe) are padded by the wrapper.
// - The reduction runs in one fixed order (C steps, fx, fy, 16-channel
//   steps) inside one block, no split across blocks and no atomics, so
//   results repeat bit for bit.  The fp32 sums are cast once, at the store.
//
// fp32 operands take a second body, conv2d_f32_kernel, on the CUDA cores in
// full fp32 (no TF32, which would round the operands to 10 mantissa bits):
// one block per (image, bx x by pixels, bk channels), 8 warps, each holding
// up to two 32 x 32 output tiles; a lane owns 4 pixels x 8 output channels
// and adds one fused multiply-add per input channel (C steps, fx, fy,
// channels).  Its loads go through registers into one padded shared buffer
// between two __syncthreads.  Its tiles are fitted to the budget in 4-byte
// words (ConvTiles.smem_bytes).  Bound: fp32 operations on the CUDA cores
// (66.9 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- bf16 body --

constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int WG_THREADS = 128;
constexpr int TC_THREADS = (1 + CONSUMERS) * WG_THREADS;
constexpr int ROWS = 64 * CONSUMERS;       // output pixels per block
constexpr int PANEL = 64;                  // output channels per B panel
constexpr int MAX_STAGES = 4;

struct TcParams {
  bf16* out;       // (B, Ho, Wo, K)
  int B, C, K, FX, FY, Ho, Wo;
  int nb, bx, by, bc;
  int IH, IW;      // haloed input tile
  int tiles_w, npt, nkt, ntiles;
  int stages;
  uint32_t in_bytes, panel_bytes, stage_bytes, tx_bytes;
};

// One tap (KS steps of 16 channels): this lane's A rows of every step into
// a[0..KS), one fence, then each step's wgmma (one m64nNk16 over all NP
// panels up to 128 columns, one m64n64k16 per panel beyond), committed as
// one group; afterwards at most this group is in flight (D = 2: `prev`,
// the previous tap's A, is free again) or none (D = 1).
template <int NP, int KS, int D>
__device__ __forceinline__ void mma_tap(float (&acc)[NP * 32], uint32_t (&a)[KS][4],
                                        uint32_t (&prev)[KS][4], uint32_t a_addr,
                                        uint32_t w_addr, uint32_t panel_bytes, uint32_t mask) {
#pragma unroll
  for (int k = 0; k < KS; ++k) hopper::ldsm_x4(a[k], hopper::swizzle(a_addr + 32 * k, mask));
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint32_t w = w_addr + k * 16 * 128;
    if constexpr (NP <= 2) {
      hopper::wgmma_rs<PANEL * NP>(acc, a[k], hopper::desc_b128(w, panel_bytes));
    } else {
#pragma unroll
      for (int q = 0; q < NP; ++q)
        hopper::wgmma_rs<PANEL>(*reinterpret_cast<float(*)[32]>(acc + 32 * q), a[k],
                                hopper::desc_b128(w + q * panel_bytes, panel_bytes));
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<D - 1>();
#pragma unroll
  for (int k = 0; k < KS; ++k) hopper::fence_regs(prev[k]);
}

// Tile `tile` of the grid (output channels fastest, so the blocks at work
// at one time share their input tiles): its first image, row, column and
// output channel.
struct Tile {
  int b0, h0, w0, k0;
};

__device__ __forceinline__ Tile tile_at(const TcParams& p, int tile, int bk) {
  const int kt = tile % p.nkt, rest = tile / p.nkt;
  const int pt = rest % p.npt, bt = rest / p.npt;
  return {bt * p.nb, (pt / p.tiles_w) * p.bx, (pt % p.tiles_w) * p.by, kt * bk};
}

template <int NP, int KS>
__global__ void __launch_bounds__(TC_THREADS, 1)
    conv2d_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, const TcParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + p.stages * p.stage_bytes;  // full[s], then empty[s]
  const int tid = threadIdx.x;
  const int nchunks = (p.C + p.bc - 1) / p.bc;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (p.stages + s), CONSUMERS * 4);  // one arrival per warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ...; the ring's load
  // counter n runs on across tiles, so the next tile's first steps load
  // while this tile's last ones and its stores run.
  if (tid < WG_THREADS) {  // producer warpgroup: one thread issues every load
    if (tid == 0) {
      hopper::prefetch_tensor_map(&tm_x);
      hopper::prefetch_tensor_map(&tm_w);
      int n = 0;
      for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
        const Tile t = tile_at(p, tile, PANEL * NP);
        for (int c = 0; c < nchunks; ++c, ++n) {
          const int s = n % p.stages;
          hopper::mbar_wait(bars + 8 * (p.stages + s), ((n / p.stages) & 1) ^ 1);
          const uint32_t full = bars + 8 * s, in_s = base + s * p.stage_bytes;
          hopper::mbar_expect_tx(full, p.tx_bytes);
          hopper::tma_load_4d(in_s, &tm_x, full, c * p.bc, t.w0, t.h0, t.b0);
#pragma unroll
          for (int q = 0; q < NP; ++q)
            hopper::tma_load_3d(in_s + p.in_bytes + q * p.panel_bytes, &tm_w, full,
                                t.k0 + q * PANEL, c * p.bc, 0);
        }
      }
      // the tail: wait until the consumers have released every stage
      for (int i = 0; i < p.stages; ++i, ++n)
        hopper::mbar_wait(bars + 8 * (p.stages + n % p.stages), ((n / p.stages) & 1) ^ 1);
    }
    return;
  }

  // consumers: warp cw (0-7) holds rows 16 cw .. 16 cw + 15 of the tile
  const int cw = (tid - WG_THREADS) >> 5, lane = tid & 31;
  const int npix = p.nb * p.bx * p.by;
  int r = 16 * cw + (lane & 15);
  if (r >= npix) r = 0;  // padding rows: any valid address, never stored
  const int row0 = ((r / (p.bx * p.by)) * p.IH + (r / p.by) % p.bx) * p.IW + r % p.by;
  const uint32_t rb = 2 * p.bc, mask = (p.bc >> 3) - 1, lane_col = 16 * (lane >> 4);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bool pair = (p.K & 1) == 0;

  // D = 2 A buffers (the next tap's fragments load while this tap's group
  // runs) up to 128 columns; one where 192 or 256 accumulators fill the
  // registers
  constexpr int D = NP <= 2 ? 2 : 1;
  float acc[NP * 32];
  uint32_t a0[KS][4], a1[KS][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[k][e] = a1[k][e] = 0u;
  int n = 0, step = 0, pending = -1;  // pending: a consumed stage not yet released
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const Tile t = tile_at(p, tile, PANEL * NP);
#pragma unroll
    for (int e = 0; e < NP * 32; ++e) acc[e] = 0.f;
    for (int c = 0; c < nchunks; ++c, ++n) {
      const int s = n % p.stages;
      hopper::mbar_wait(bars + 8 * s, (n / p.stages) & 1);
      __syncwarp();  // ldmatrix and wgmma need the warp converged
      const uint32_t in_s = base + s * p.stage_bytes, w_s = in_s + p.in_bytes;
      for (int fx = 0; fx < p.FX; ++fx) {
        for (int fy = 0; fy < p.FY; ++fy) {
          const uint32_t row = row0 + fx * p.IW + fy;
          const uint32_t w_tap = w_s + (fx * p.FY + fy) * p.bc * 128;
          const uint32_t a_addr = in_s + row * rb + lane_col;
          if (D == 1)
            mma_tap<NP, KS, D>(acc, a0, a0, a_addr, w_tap, p.panel_bytes, mask);
          else if (!(step & 1))
            mma_tap<NP, KS, D>(acc, a0, a1, a_addr, w_tap, p.panel_bytes, mask);
          else
            mma_tap<NP, KS, D>(acc, a1, a0, a_addr, w_tap, p.panel_bytes, mask);
          ++step;
          // only this group is in flight: the previous stage is consumed
          if (pending >= 0) {
            if (lane == 0) hopper::mbar_arrive(bars + 8 * (p.stages + pending));
            __syncwarp();
            pending = -1;
          }
        }
      }
      pending = s;
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      hopper::fence_regs(a0[k]);
      hopper::fence_regs(a1[k]);
    }
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(bars + 8 * (p.stages + pending));
    __syncwarp();
    pending = -1;

    // accumulator (wgmma m64nN): lane holds rows 16 warp + lane/4 (+ 8)
    // and, in each 8-column group 8 q + j, columns 64 q + 8 j + 2 (lane % 4)
    // (+ 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = 16 * cw + g + 8 * i;
      if (rr >= npix) continue;
      const int b = t.b0 + rr / (p.bx * p.by), h = t.h0 + (rr / p.by) % p.bx;
      const int w = t.w0 + rr % p.by;
      if (b >= p.B || h >= p.Ho || w >= p.Wo) continue;
      bf16* orow = p.out + (((long long)b * p.Ho + h) * p.Wo + w) * p.K;
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = t.k0 + q * PANEL + 8 * j + t2;
          const float v0 = acc[32 * q + 4 * j + 2 * i], v1 = acc[32 * q + 4 * j + 2 * i + 1];
          if (pair && k + 1 < p.K) {
            *reinterpret_cast<__nv_bfloat162*>(orow + k) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (k < p.K) orow[k] = __float2bfloat16(v0);
            if (k + 1 < p.K) orow[k + 1] = __float2bfloat16(v1);
          }
        }
    }
  }
}

template <int NP, int KS>
cudaError_t launch_tc(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const TcParams& p,
                      unsigned blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv2d_tc_kernel<NP, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv2d_tc_kernel<NP, KS><<<blocks, TC_THREADS, smem, stream>>>(tm_x, tm_w, p);
  return cudaGetLastError();
}

// KS = bc / 16 steps a tap.  Four panels of 64-channel steps are refused:
// 128 accumulators and 16 A registers a thread leave too few registers,
// and ptxas would serialise the wgmmas (ConvTiles.data_regs).
template <int NP>
cudaError_t launch_np(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const TcParams& p,
                      unsigned blocks, size_t smem, cudaStream_t stream) {
  switch (p.bc) {
    case 16: return launch_tc<NP, 1>(tm_x, tm_w, p, blocks, smem, stream);
    case 32: return launch_tc<NP, 2>(tm_x, tm_w, p, blocks, smem, stream);
    default:
      if constexpr (NP == 4) return cudaErrorInvalidValue;
      else return launch_tc<NP, 4>(tm_x, tm_w, p, blocks, smem, stream);
  }
}

cudaError_t launch_bf16(const void* x, const void* w, void* out, int B, int H, int W, int Cx,
                        int C, int Kw, int K, int FX, int FY, int nb, int bx, int by, int bc,
                        int bk, int stages, cudaStream_t stream) {
  const int np = bk / PANEL;
  if (B < 1 || C < 1 || K < 1 || FX < 1 || FY < 1 || H < FX || W < FY || nb < 1 || bx < 1 ||
      by < 1 || nb * bx * by > ROWS || (bc != 16 && bc != 32 && bc != 64) || bk % PANEL ||
      np < 1 || np > 4 || stages < 2 || stages > MAX_STAGES || Cx % 8 || Kw % 8 || Cx < C ||
      Kw < K || FX * FY > 256 || by + FY - 1 > 256 || bx + FX - 1 > 256 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  TcParams p;
  p.out = static_cast<bf16*>(out);
  p.B = B; p.C = C; p.K = K; p.FX = FX; p.FY = FY;
  p.Ho = H - FX + 1; p.Wo = W - FY + 1;
  p.nb = nb; p.bx = bx; p.by = by; p.bc = bc;
  p.IH = bx + FX - 1; p.IW = by + FY - 1;
  p.tiles_w = (p.Wo + by - 1) / by;
  const long long npt = (long long)((p.Ho + bx - 1) / bx) * p.tiles_w;
  const long long nbt = (B + nb - 1) / nb;
  p.nkt = (K + bk - 1) / bk;
  const long long tiles = npt * nbt * p.nkt;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.npt = (int)npt;
  p.ntiles = (int)tiles;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);  // one resident block an SM
  p.stages = stages;
  const long long in_box = 2LL * nb * p.IH * p.IW * bc;
  p.in_bytes = (uint32_t)((in_box + 1023) / 1024 * 1024);
  p.panel_bytes = (uint32_t)(FX * FY * bc * 128);
  p.stage_bytes = p.in_bytes + np * p.panel_bytes;
  p.tx_bytes = (uint32_t)in_box + np * p.panel_bytes;
  const size_t smem = (size_t)stages * p.stage_bytes + 1024 + 16 * stages;
  if (smem > 232448) return cudaErrorInvalidValue;

  // x as (Cx, W, H, B), box (bc, IW, IH, nb), swizzled over bc * 2 bytes;
  // w as (Kw, C, FX FY), box (64, bc, FX FY), 128-byte swizzle
  CUtensorMap tm_x, tm_w;
  const uint64_t xd[4] = {(uint64_t)Cx, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xs[3] = {2ull * Cx, 2ull * Cx * W, 2ull * Cx * W * H};
  const uint32_t xb[4] = {(uint32_t)bc, (uint32_t)p.IW, (uint32_t)p.IH, (uint32_t)nb};
  const CUtensorMapSwizzle sw = bc == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : bc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_128B;
  err = hopper::bf16_tensor_map(&tm_x, x, 4, xd, xs, xb, sw);
  if (err != cudaSuccess) return err;
  const uint64_t wd[3] = {(uint64_t)Kw, (uint64_t)C, (uint64_t)(FX * FY)};
  const uint64_t ws[2] = {2ull * Kw, 2ull * Kw * C};
  const uint32_t wb[3] = {(uint32_t)PANEL, (uint32_t)bc, (uint32_t)(FX * FY)};
  err = hopper::bf16_tensor_map(&tm_w, w, 3, wd, ws, wb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;

  switch (np) {
    case 1: return launch_np<1>(tm_x, tm_w, p, blocks, smem, stream);
    case 2: return launch_np<2>(tm_x, tm_w, p, blocks, smem, stream);
    case 3: return launch_np<3>(tm_x, tm_w, p, blocks, smem, stream);
    default: return launch_np<4>(tm_x, tm_w, p, blocks, smem, stream);
  }
}

// ------------------------------------------------------------- fp32 body --

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WT = 32;            // warp tile: 32 pixels x 32 output channels
constexpr int TILES_PER_WARP = 2; // so a block's output tile is <= 16 warp tiles
constexpr int PAD = 8;            // padding of each shared-memory row, in elements

struct F32Params {
  const float* x;  // (B, H, W, C)
  const float* w;  // (FX, FY, C, K)
  float* out;      // (B, Ho, Wo, K)
  int H, W, C, K, FX, FY, Ho, Wo;
  int bx, by, bc, bk;
  int tiles_w;     // pixel tiles along W
  bool vec_x, vec_w;
};

// 4 fp32 from src (zeros past n_valid) as one 16-byte value
__device__ __forceinline__ float4 load4(const float* src, bool vec, int n_valid) {
  if (vec && n_valid >= 4) return *reinterpret_cast<const float4*>(src);
  float4 v;
  v.x = n_valid > 0 ? src[0] : 0.f;
  v.y = n_valid > 1 ? src[1] : 0.f;
  v.z = n_valid > 2 ? src[2] : 0.f;
  v.w = n_valid > 3 ? src[3] : 0.f;
  return v;
}

// The same tile and staging as conv2d_kernel, fp32 on the CUDA cores: in
// each 32 x 32 warp tile lane l owns pixels 4 (l / 4) .. + 3 and output
// channels 8 (l % 4) .. + 7
__global__ void __launch_bounds__(THREADS, 2) conv2d_f32_kernel(const F32Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IH = p.bx + p.FX - 1, IW = p.by + p.FY - 1;
  const int cs = p.bc + PAD;
  const int bkp = (p.bk + WT - 1) / WT * WT;
  const int ks = bkp + PAD;
  float* in_s = reinterpret_cast<float*>(smem_raw);
  float* w_s = in_s + IH * IW * cs;

  const int h0 = (blockIdx.x / p.tiles_w) * p.bx, w0 = (blockIdx.x % p.tiles_w) * p.by;
  const int k0 = blockIdx.y * p.bk;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lp = lane >> 2, lc = lane & 3;
  const int npix = p.bx * p.by;
  const int nt = bkp / WT;
  const int units = (npix + WT - 1) / WT * nt;

  int pix[TILES_PER_WARP][4];
  float acc[TILES_PER_WARP][4][8];
#pragma unroll
  for (int s = 0; s < TILES_PER_WARP; ++s) {
    const int um = (warp + WARPS * s) / nt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = um * WT + lp * 4 + i;
      if (r >= npix) r = 0;  // padding rows: any valid address, never stored
      pix[s][i] = (r / p.by) * IW + r % p.by;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[s][i][e] = 0.f;
    }
  }

  const float* xb = p.x + (long long)b * p.H * p.W * p.C;
  const int cch = p.bc / 4, kch = bkp / 4;
  for (int c0 = 0; c0 < p.C; c0 += p.bc) {
    __syncthreads();  // the previous step's reads are done
    for (int idx = threadIdx.x; idx < IH * IW * cch; idx += THREADS) {
      const int px = idx / cch, cc = (idx % cch) * 4;
      const int hh = h0 + px / IW, ww = w0 + px % IW, c = c0 + cc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh < p.H && ww < p.W && c < p.C)
        v = load4(xb + ((long long)hh * p.W + ww) * p.C + c, p.vec_x, p.C - c);
      *reinterpret_cast<float4*>(in_s + px * cs + cc) = v;
    }
    for (int idx = threadIdx.x; idx < p.FX * p.FY * p.bc * kch; idx += THREADS) {
      const int row = idx / kch, kk = (idx % kch) * 4;
      const int f = row / p.bc, c = c0 + row % p.bc, k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < p.C && kk < p.bk && k < p.K)
        v = load4(p.w + ((long long)f * p.C + c) * p.K + k, p.vec_w,
                  min(p.K - k, p.bk - kk));
      *reinterpret_cast<float4*>(w_s + row * ks + kk) = v;
    }
    __syncthreads();

    for (int fx = 0; fx < p.FX; ++fx) {
      for (int fy = 0; fy < p.FY; ++fy) {
        const int shift = fx * IW + fy;
        const float* wf = w_s + (fx * p.FY + fy) * p.bc * ks;
        for (int c = 0; c < p.bc; ++c) {
#pragma unroll
          for (int s = 0; s < TILES_PER_WARP; ++s) {
            const int u = warp + WARPS * s;
            if (u >= units) continue;
            const float* wr = wf + c * ks + (u % nt) * WT + lc * 8;
            float a[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = in_s[(pix[s][i] + shift) * cs + c];
#pragma unroll
            for (int e = 0; e < 8; ++e) bv[e] = wr[e];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[s][i][e] = fmaf(a[i], bv[e], acc[s][i][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < TILES_PER_WARP; ++s) {
    const int u = warp + WARPS * s;
    if (u >= units) continue;
    const int um = u / nt, n0 = (u % nt) * WT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = um * WT + lp * 4 + i;
      const int h = h0 + r / p.by, ww = w0 + r % p.by;
      if (r >= npix || h >= p.Ho || ww >= p.Wo) continue;
      float* orow = p.out + (((long long)b * p.Ho + h) * p.Wo + ww) * p.K;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kl = n0 + lc * 8 + e, k = k0 + kl;
        if (kl < p.bk && k < p.K) orow[k] = acc[s][i][e];
      }
    }
  }
}


cudaError_t launch_f32(const void* x, const void* w, void* out, int B, int H, int W, int C,
                       int K, int FX, int FY, int bx, int by, int bc, int bk,
                       cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || FX < 1 || FY < 1 || H < FX || W < FY || bx < 1 ||
      by < 1 || bc < 16 || bk < 16 || bc % 16 || bk % 16)
    return cudaErrorInvalidValue;
  const int bkp = (bk + WT - 1) / WT * WT;
  if ((long long)((bx * by + WT - 1) / WT) * (bkp / WT) > WARPS * TILES_PER_WARP)
    return cudaErrorInvalidValue;
  F32Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  p.H = H; p.W = W; p.C = C; p.K = K; p.FX = FX; p.FY = FY;
  p.Ho = H - FX + 1; p.Wo = W - FY + 1;
  p.bx = bx; p.by = by; p.bc = bc; p.bk = bk;
  p.tiles_w = (p.Wo + by - 1) / by;
  p.vec_x = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long smem = 4LL * ((long long)(bx + FX - 1) * (by + FY - 1) * (bc + PAD) +
                                (long long)FX * FY * bc * (bkp + PAD));
  if (smem > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.Ho + bx - 1) / bx) * p.tiles_w;
  if (tiles > 0x7fffffff || (K + bk - 1) / bk > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (K + bk - 1) / bk, B);
  conv2d_f32_kernel<<<grid, THREADS, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16: x (B, H, W, Cx) of which the first C channels are read, w (FX, FY,
// C, Kw) of which the first K columns are read, out (B, H-FX+1, W-FY+1, K),
// contiguous; Cx and Kw multiples of 8, x and w 16-byte aligned.  Tile: nb
// images x bx x by pixels (at most 128), bc in {16, 32, 64}, bk a multiple
// of 64 up to 256, 2-4 stages; shared memory above 227 KB is refused.
extern "C" int conv2d_bf16(const void* x, const void* w, void* out, int B, int H, int W,
                           int Cx, int C, int Kw, int K, int FX, int FY, int nb, int bx, int by,
                           int bc, int bk, int stages, void* stream) {
  return launch_bf16(x, w, out, B, H, W, Cx, C, Kw, K, FX, FY, nb, bx, by, bc, bk, stages,
                     static_cast<cudaStream_t>(stream));
}

// fp32: x (B, H, W, C), w (FX, FY, C, K), out (B, H-FX+1, W-FY+1, K),
// contiguous.  Tile (bx, by, bc, bk): bc and bk multiples of 16, at most 16
// warp tiles of 32 x 32 per block; shared memory above 227 KB is refused.
extern "C" int conv2d_f32(const void* x, const void* w, void* out, int B, int H, int W, int C,
                          int K, int FX, int FY, int bx, int by, int bc, int bk, void* stream) {
  return launch_f32(x, w, out, B, H, W, C, K, FX, FY, bx, by, bc, bk,
                    static_cast<cudaStream_t>(stream));
}
