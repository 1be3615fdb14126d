// Direct conv2d for Hopper (sm_90a) as an implicit GEMM: NHWC input, HWIO
// filter, fp32 accumulation, output in the operands' type (bf16 or fp32);
// valid, stride 1.
//
// Replaces the TPU kernel conv2d_pallas (repro/kernels/conv2d/conv2d.py),
// the paper's Algorithm-1 CONV nest.  The TPU kernel holds a whole image
// of bc channels in VMEM and accumulates (Ho*Wo, bk) in fp32 across a
// sequential C grid axis.  A Hopper block has 227 KB of shared memory (a
// VGG-16 image of 64 channels is 6.5 MB), so this kernel also tiles the
// output pixels: one block per (image, bx x by output pixel tile, bk output
// channels), grid (pixel tiles, K / bk, B).  The tile (bx, by, bc, bk) is
// the level-0 tile of the paper's blocking search on the H100's (shared
// memory, HBM) hierarchy (kernels/conv2d/ops.py).
//
// One block: for each bc-channel step of C it stages the haloed input tile
// (bx+FX-1) x (by+FY-1) x bc and the filter slice FX x FY x bc x bk in
// shared memory (zeros outside the image, past C and past K), then for each
// (fx, fy) of the filter and each 16 channels it multiplies on the tensor
// cores: an M x N x 16 product with M = the tile's pixels and N = bk.  The
// A operand is the input tile shifted by (fx, fy): every row is one pixel,
// read by ldmatrix from its own shared-memory address, so no im2col copy
// is made.  The B operand is read transposed from the (c, k) filter rows.
// mma.sync m16n8k16 bf16 with fp32 accumulators in registers; 8 warps,
// each holding up to two 32 x 32 output tiles.  Pixel rows past the tile
// and output channels past bk or K are computed on zeros and not stored.
// The reduction runs in one fixed order (C steps, fx, fy, 16-channel
// steps) inside one block: results repeat bit for bit.  The fp32 sums are
// cast to bf16 once, at the store.
//
// What bounds it: the paper's CNN layers do 100-1000 operations per byte of
// input, filter and output, so on this card they are bound by operations
// (989 TFLOP/s bf16).  This first kernel is simple: loads go through
// registers into one shared buffer and wait for the block (two blocks per
// SM overlap one's loads with the other's math), and mma.sync from
// ldmatrix is bounded by shared-memory reads well below the wgmma peak.
// A TMA / wgmma pipeline is later work.
//
// fp32 operands take a second body, conv2d_f32_kernel, with the same grid,
// tile, staging and warp tiles, on the CUDA cores in full fp32 (no TF32,
// which would round the operands to 10 mantissa bits): in each 32 x 32
// warp tile a lane owns 4 pixels x 8 output channels and adds one fused
// multiply-add per input channel, in the bf16 body's order (C steps, fx,
// fy, channels).  Its shared memory holds 4-byte words, so its tiles are
// fitted to the budget in 4-byte words (ConvTiles.smem_bytes).  Bound:
// fp32 operations on the CUDA cores (66.9 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WT = 32;            // warp tile: 32 pixels x 32 output channels
constexpr int TILES_PER_WARP = 2; // so a block's output tile is <= 16 warp tiles
constexpr int PAD = 8;            // padding of each shared-memory row, in elements

template <typename T>
struct Params {
  const T* x;      // (B, H, W, C)
  const T* w;      // (FX, FY, C, K)
  T* out;          // (B, Ho, Wo, K)
  int H, W, C, K, FX, FY, Ho, Wo;
  int bx, by, bc, bk;
  int tiles_w;     // pixel tiles along W
  bool vec_x, vec_w;
};

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

// 8 bf16 from src (zeros where valid[e] is false) as one 16-byte value
__device__ __forceinline__ uint4 load8(const bf16* src, bool vec, int n_valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec && n_valid >= 8) return *reinterpret_cast<const uint4*>(src);
  unsigned short t[8];
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = e < n_valid ? s[e] : 0;
  memcpy(&v, t, sizeof(v));
  return v;
}

__global__ void __launch_bounds__(THREADS, 2) conv2d_kernel(const Params<bf16> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IH = p.bx + p.FX - 1, IW = p.by + p.FY - 1;
  const int cs = p.bc + PAD;                   // input: one row per pixel
  const int bkp = (p.bk + WT - 1) / WT * WT;   // bk in whole warp tiles
  const int ks = bkp + PAD;                    // filter: one row per (fx, fy, c)
  bf16* in_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* w_s = in_s + IH * IW * cs;

  const int h0 = (blockIdx.x / p.tiles_w) * p.bx, w0 = (blockIdx.x % p.tiles_w) * p.by;
  const int k0 = blockIdx.y * p.bk;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npix = p.bx * p.by;
  const int nt = bkp / WT;
  const int units = (npix + WT - 1) / WT * nt;

  // shared-memory pixel of this lane's A row in each 16-row half of each of
  // the warp's tiles (ldmatrix: lane -> row lane % 16, channels 8 * (lane / 16))
  int pix[TILES_PER_WARP][2];
  float acc[TILES_PER_WARP][2][4][4];
#pragma unroll
  for (int s = 0; s < TILES_PER_WARP; ++s) {
    const int um = (warp + WARPS * s) / nt;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      int r = um * WT + mi * 16 + (lane & 15);
      if (r >= npix) r = 0;  // padding rows: any valid address, never stored
      pix[s][mi] = (r / p.by) * IW + r % p.by;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][mi][n][e] = 0.f;
    }
  }

  const bf16* xb = p.x + (long long)b * p.H * p.W * p.C;
  const int cch = p.bc / 8, kch = bkp / 8;
  for (int c0 = 0; c0 < p.C; c0 += p.bc) {
    __syncthreads();  // the previous step's reads are done
    for (int idx = threadIdx.x; idx < IH * IW * cch; idx += THREADS) {
      const int px = idx / cch, cc = (idx % cch) * 8;
      const int hh = h0 + px / IW, ww = w0 + px % IW, c = c0 + cc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hh < p.H && ww < p.W && c < p.C)
        v = load8(xb + ((long long)hh * p.W + ww) * p.C + c, p.vec_x, p.C - c);
      *reinterpret_cast<uint4*>(in_s + px * cs + cc) = v;
    }
    for (int idx = threadIdx.x; idx < p.FX * p.FY * p.bc * kch; idx += THREADS) {
      const int row = idx / kch, kk = (idx % kch) * 8;
      const int f = row / p.bc, c = c0 + row % p.bc, k = k0 + kk;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < p.C && kk < p.bk && k < p.K)
        v = load8(p.w + ((long long)f * p.C + c) * p.K + k, p.vec_w,
                  min(p.K - k, p.bk - kk));
      *reinterpret_cast<uint4*>(w_s + row * ks + kk) = v;
    }
    __syncthreads();

    for (int fx = 0; fx < p.FX; ++fx) {
      for (int fy = 0; fy < p.FY; ++fy) {
        const int shift = fx * IW + fy;
        const bf16* wf = w_s + (fx * p.FY + fy) * p.bc * ks;
        for (int kk = 0; kk < p.bc; kk += 16) {
#pragma unroll
          for (int s = 0; s < TILES_PER_WARP; ++s) {
            const int u = warp + WARPS * s;
            if (u >= units) continue;
            const int n0 = (u % nt) * WT;
            uint32_t a[2][4], bq[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              ldsm_x4(a[mi], in_s + (pix[s][mi] + shift) * cs + kk + (lane >> 4) * 8);
            // lane -> filter row kk + lane % 16, columns n0 + 16 nj + 8 (lane / 16):
            // bq[nj] = {b0, b1} of n8 tile 2 nj, then of n8 tile 2 nj + 1
#pragma unroll
            for (int nj = 0; nj < 2; ++nj)
              ldsm_x4_trans(bq[nj], wf + (kk + (lane & 15)) * ks + n0 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int n = 0; n < 4; ++n)
                mma_bf16(acc[s][mi][n], a[mi], bq[n >> 1][(n & 1) * 2],
                         bq[n >> 1][(n & 1) * 2 + 1]);
          }
        }
      }
    }
  }

  // accumulator (m16n8): lane holds rows lane/4 and lane/4 + 8, columns
  // 2 (lane % 4) and 2 (lane % 4) + 1
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int s = 0; s < TILES_PER_WARP; ++s) {
    const int u = warp + WARPS * s;
    if (u >= units) continue;
    const int um = u / nt, n0 = (u % nt) * WT;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = um * WT + mi * 16 + g + half * 8;
        const int h = h0 + r / p.by, ww = w0 + r % p.by;
        if (r >= npix || h >= p.Ho || ww >= p.Wo) continue;
        bf16* orow = p.out + (((long long)b * p.Ho + h) * p.Wo + ww) * p.K;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int kl = n0 + n * 8 + t2, k = k0 + kl;
          if (kl < p.bk && k < p.K) orow[k] = __float2bfloat16(acc[s][mi][n][half * 2]);
          if (kl + 1 < p.bk && k + 1 < p.K)
            orow[k + 1] = __float2bfloat16(acc[s][mi][n][half * 2 + 1]);
        }
      }
  }
}

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
__global__ void __launch_bounds__(THREADS, 2) conv2d_f32_kernel(const Params<float> p) {
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

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int B, int H, int W,
                   int C, int K, int FX, int FY, int bx, int by, int bc, int bk,
                   cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || FX < 1 || FY < 1 || H < FX || W < FY || bx < 1 ||
      by < 1 || bc < 16 || bk < 16 || bc % 16 || bk % 16)
    return cudaErrorInvalidValue;
  const int bkp = (bk + WT - 1) / WT * WT;
  if ((long long)((bx * by + WT - 1) / WT) * (bkp / WT) > WARPS * TILES_PER_WARP)
    return cudaErrorInvalidValue;
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.out = static_cast<T*>(out);
  p.H = H; p.W = W; p.C = C; p.K = K; p.FX = FX; p.FY = FY;
  p.Ho = H - FX + 1; p.Wo = W - FY + 1;
  p.bx = bx; p.by = by; p.bc = bc; p.bk = bk;
  p.tiles_w = (p.Wo + by - 1) / by;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  p.vec_x = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = K % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long smem =
      (long long)sizeof(T) * ((long long)(bx + FX - 1) * (by + FY - 1) * (bc + PAD) +
                              (long long)FX * FY * bc * (bkp + PAD));
  if (smem > 0x7fffffff) return cudaErrorInvalidValue;
  void (*kern)(Params<T>);
  if constexpr (sizeof(T) == 4)
    kern = conv2d_f32_kernel;
  else
    kern = conv2d_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.Ho + bx - 1) / bx) * p.tiles_w;
  if (tiles > 0x7fffffff || (K + bk - 1) / bk > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (K + bk - 1) / bk, B);
  kern<<<grid, THREADS, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), w (FX, FY, C, K), out (B, H-FX+1, W-FY+1, K): all bf16
// (fp32 = 0) or all fp32 (fp32 = 1), contiguous.  Tile (bx, by, bc, bk): bc
// and bk multiples of 16, at most 16 warp tiles of 32 x 32 per block; shared
// memory above 227 KB is refused.
extern "C" int conv2d(const void* x, const void* w, void* out, int B, int H,
                      int W, int C, int K, int FX, int FY, int bx, int by,
                      int bc, int bk, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch<float>(x, w, out, B, H, W, C, K, FX, FY, bx, by, bc, bk, s);
  return launch<bf16>(x, w, out, B, H, W, C, K, FX, FY, bx, by, bc, bk, s);
}
