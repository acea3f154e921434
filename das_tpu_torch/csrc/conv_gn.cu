// Fused 3x3 conv + GroupNorm + relu, hand-written for Hopper (sm_90a). Built
// by das_tpu_torch/ops/conv_gn.py with nvcc into a shared library with a
// plain C interface and called through ctypes.
//
// Replaces: das_tpu/ops/pallas_convgn.py::conv_gn_relu (the TPU kernel K2).
// Same function: NHWC x, HWIO (3,3,Cin,Cout) weight, no bias; the conv is
// 3x3 'same' with zero padding, accumulated in f32 from x's type; GroupNorm
// over G contiguous channel groups takes its statistics from the f32
// accumulator (mean = E[y], var = E[y^2] - E[y]^2, both in f32, then
// 1/sqrt(var + eps)); the affine a = gamma * rstd, b = beta - mean * a is
// applied in f32 as y * a + b, then relu, then the result is rounded to x's
// type.
//
// What bounds it on an H100: the conv. At the serving shapes (Cin = 256,
// Cout = 256 or 64) it is 2*9*256*Cout FLOP per output pixel against ~1 KB
// of compulsory traffic (x read, output written), far above the card's ~295
// bf16 tensor-core operations per byte; so it is bound by operations, and the
// tensor cores must do the product. The GroupNorm is a few operations per
// element.
//
// Design: the TPU kernel held one whole padded image and its f32 accumulator
// in VMEM (~72 MB at the stride-4 level). An H100 block has 227 KB of shared
// memory, so the statistics need a reduction across blocks, in three
// launches on one stream:
//   1. conv: an implicit GEMM, pixels x (9 taps x Cin) x Cout; the epilogue
//      writes y (f32) to a workspace and the block's per-(image, group)
//      partial sums of y and y^2 to its own slot of a partials buffer: no
//      atomics, so runs repeat bit for bit.
//   2. stats: one block per (image, group) sums the slots in a fixed tree
//      order and writes mean and rstd.
//   3. apply: elementwise relu(y * a + b), rounded to x's type; a thread
//      reads 16 bytes of y and writes its 4 channels (8 bytes of bf16):
//      neighbouring threads cover whole lines both ways. A variant with 8
//      channels a thread (two 16-byte loads 32 bytes apart between
//      neighbours, one 16-byte store) measured slower, 0.124 against 0.109
//      ms at the stride-4 level on an NVIDIA H100 80GB HBM3 at 700 W.
// The f32 workspace round trip stays: at the stride-4 level it moves 189 MB
// out, 189 MB in and 94 MB of bf16 out, ~0.14 ms at 3.35 TB/s, less than the
// 0.22 ms that a second conv pass would take at the tensor cores' peak; at
// the two coarsest levels the workspace fits the 50 MB L2.
//
// The bf16 conv pass (Cin and Cout multiples of 8, 16-byte aligned bases)
// is built from what Hopper added:
//   * wgmma: two consumer warpgroups, each 64 pixels x all BN <= 256 output
//     channels of the block (m64n256k16 or m64n64k16, bf16 operands read
//     from shared memory through descriptors, f32 accumulators in
//     registers, 128 a thread at BN = 256).
//   * A block owns 128 pixels, an 8 x 16 patch of ONE image, so the weights
//     are read once per 128 pixels. Per 64-channel slice of a tap it
//     fetches a 16 KB x tile and a 32 KB weight tile for 4.2 MFLOP: 87 FLOP
//     per byte from L2; at the stride-4 level of a B=4 640x1152 request
//     1,440 blocks read 1.7 GB of weights and 0.85 GB of x through L2 for
//     217 GFLOP. (A cluster of two blocks sharing each weight tile by TMA
//     multicast would halve the weight traffic again; not done here.)
//   * TMA: one producer warp keeps a ring of 4 stages full. The x tile is a
//     box of a 4-D map over (N, H, W, Cin) at the tap's shifted
//     coordinates; what lies outside the image, negative coordinates too,
//     arrives as zeros, which is the conv's padding and also covers the
//     ragged last patch and a Cin that is no multiple of 64. The weight
//     tile is 64 x BN of a 3-D map over (9, Cin, Cout). Both land in the
//     128-byte swizzle that the wgmma descriptors read (x: K-major; the
//     weight: MN-major, 64-channel column chunks 8 KB apart). Each stage
//     has a "full" mbarrier that the TMA completes with its byte count and
//     an "empty" one that the two warpgroups release when the wgmma group
//     that read the stage has retired.
//   * The epilogue pairs neighbouring lanes by shuffle so that each thread
//     stores 16 bytes of consecutive channels of y, and reduces the
//     per-channel sums from the accumulator registers in a fixed order
//     (lanes by shuffle, then the 8 warps through shared memory).
// f32 runs true FMAs (64 pixels x 128 channels per block), and bf16 shapes
// that 16-byte loads cannot take run WMMA (mma.sync) on tiles filled element
// by element (64 pixels x BN).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output pixels per block, all in one image
constexpr int BK = 32;        // input channels per slice
constexpr int THREADS = 256;  // eight warps
constexpr int KK = 9;         // 3 x 3 taps
constexpr int BN_F32 = 128;   // output channels per block, f32 kernel

// The flat input pixel each tap reads for every pixel of the tile, or -1
// (zero padding, or past the image's last pixel).
__device__ __forceinline__ void tap_rows(int (&rows)[KK][BM], int n, int m0,
                                         int H, int W) {
  for (int e = threadIdx.x; e < KK * BM; e += blockDim.x) {
    const int k = e / BM, i = e % BM;
    const int m = m0 + i;
    int idx = -1;
    if (m < H * W) {
      const int py = m / W, px = m - (m / W) * W;
      const int yy = py + k / 3 - 1, xx = px + k % 3 - 1;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) idx = (n * H + yy) * W + xx;
    }
    rows[k][i] = idx;
  }
}

// The block's partial sums of y and y^2 over its pixels, per group, from
// the per-channel block sums t1, t2 of channels [n0, n0 + bn); groups that
// miss the block's channels get 0. One slot per block; called by the
// block's first nthreads threads.
__device__ __forceinline__ void write_group_partials(
    const float* t1, const float* t2, float2* part, size_t slot, int n0,
    int bn, int Cout, int G, int nthreads) {
  const int cg = Cout / G;
  for (int g = threadIdx.x; g < G; g += nthreads) {
    const int lo = max(g * cg, n0);
    const int hi = min(min((g + 1) * cg, n0 + bn), Cout);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lo; c < hi; ++c) {
      s1 += t1[c - n0];
      s2 += t2[c - n0];
    }
    part[slot * G + g] = make_float2(s1, s2);
  }
}

// Two f32 values as packed bf16, a first.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int FM, int FN, int LDA, int LDB>
__device__ __forceinline__ void mma_slice(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[FM][FN],
    const __nv_bfloat16* As, const __nv_bfloat16* Bs, int row0, int col0) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a[FM];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      wmma::load_matrix_sync(a[i], As + (row0 + i * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, Bs + kk * LDB + col0 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

// bf16 conv pass for shapes that 16-byte loads cannot take: 64 pixels x BN
// output channels per block, WM x WN warps, tiles filled element by element.
template <int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
conv_gn_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ weight,
                    float* __restrict__ ws, float2* __restrict__ part,
                    int H, int W, int Cin, int Cout, int G, int tiles) {
  static_assert(WM * WN == THREADS / 32, "eight warps");
  constexpr int FM = BM / 16 / WM;        // 16-row fragments per warp
  constexpr int FN = BN / 16 / WN;        // 16-column fragments per warp
  constexpr int LDA = BK + 8, LDB = BN + 8;
  __shared__ int rows[KK][BM];
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  __shared__ float chs[2][WM][BN];
  __shared__ float tot[2][BN];

  const int HW = H * W;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int m0 = tile * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;

  tap_rows(rows, n, m0, H, W);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nsl = (Cin + BK - 1) / BK;
  const int iters = KK * nsl;
  for (int it = 0; it < iters; ++it) {
    const int k = it / nsl, c0 = (it % nsl) * BK;
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int p = e / BK, c = e % BK, ci = c0 + c;
      const int idx = rows[k][p];
      As[p * LDA + c] = (idx >= 0 && ci < Cin) ? x[(size_t)idx * Cin + ci]
                                               : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kr = e / BN, o = e % BN;
      const int cw = c0 + kr, co = n0 + o;
      Bs[kr * LDB + o] = (cw < Cin && co < Cout)
                             ? weight[((size_t)k * Cin + cw) * Cout + co]
                             : __float2bfloat16(0.f);
    }
    __syncthreads();
    mma_slice<FM, FN, LDA, LDB>(acc, As, Bs, wm * FM * 16, wn * FN * 16);
    __syncthreads();
  }

  // epilogue: y (f32) to the workspace; per-channel sums of y and y^2
  float* cs = Cs[warp];
  const int col = lane % 16;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    const int cl = wn * FN * 16 + j * 16 + col;   // block-local channel
    const int co = n0 + cl;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int r = lane / 16; r < 16; r += 2) {
        const int m = m0 + wm * FM * 16 + i * 16 + r;
        if (m < HW && co < Cout) {
          const float v = cs[r * 16 + col];
          ws[((size_t)n * HW + m) * Cout + co] = v;
          s1 += v;
          s2 += v * v;
        }
      }
      __syncwarp();
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 16);
    if (lane < 16) {
      chs[0][wm][cl] = s1;
      chs[1][wm][cl] = s2;
    }
  }
  __syncthreads();
  for (int c = tid; c < BN; c += THREADS) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int r = 0; r < WM; ++r) {
      t1 += chs[0][r][c];
      t2 += chs[1][r][c];
    }
    tot[0][c] = t1;
    tot[1][c] = t2;
  }
  __syncthreads();
  write_group_partials(tot[0], tot[1], part,
                       ((size_t)n * tiles + tile) * gridDim.y + blockIdx.y,
                       n0, BN, Cout, G, THREADS);
}

// ---- the bf16 conv pass on wgmma, fed by TMA ------------------------------

constexpr int TH = 8, TW = 16;           // the block's patch: 128 pixels
constexpr int TK = 64;                   // input channels per slice: 128 bytes
constexpr int STAGES = 4;
constexpr int A_BYTES = TH * TW * TK * 2;               // 16 KB
constexpr int WG_THREADS = CONSUMERS + 32;              // and the producer warp

constexpr int wgmma_smem_bytes(int bn) {
  // 1 KB to align the ring, the ring, the barriers, chs[2][8][bn], tot[2][bn]
  return 1024 + STAGES * (A_BYTES + TK * bn * 2) + 2 * STAGES * 8 +
         (2 * 8 + 2) * bn * 4;
}

// One block: the 8 x 16 patch (h0.., w0..) of image n x output channels
// [n0, n0 + BN). Warps 0-7 are the two consumer warpgroups, warp 8 the
// producer.
template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv_gn_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     float* __restrict__ ws, float2* __restrict__ part, int H,
                     int W, int Cin, int Cout, int G, int tiles_w, int tiles) {
  constexpr int B_BYTES = TK * BN * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  float* chs = reinterpret_cast<float*>(bars + 2 * STAGES);   // [2][8][BN]
  float* tot = chs + 2 * 8 * BN;                              // [2][BN]
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(bars), empty = full + STAGES * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int nsl = (Cin + TK - 1) / TK;
  const int iters = KK * nsl;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);    // the producer's arrive with the bytes
      mbar_init(empty + s * 8, 2);   // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + s * 8, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s * 8, STAGE);
        const int k = it / nsl, c0 = (it % nsl) * TK;
        const uint32_t a = ring + s * STAGE, b = a + A_BYTES;
        tma_load_4d(a, &xmap, full + s * 8, c0, w0 + k % 3 - 1,
                    h0 + k / 3 - 1, n);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load_3d(b + q * (TK * 128), &wmap, full + s * 8, n0 + q * 64,
                      c0, k);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + s * 8, (it / STAGES) & 1);
    const uint32_t a = ring + s * STAGE + wg * (64 * 128);
    const uint32_t b = ring + s * STAGE + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < TK / 16; ++j)
      // x: rows of 128 bytes, 8-row groups 1 KB apart, 32 bytes per k step;
      // weight: 64-column chunks 8 KB apart, 8-row groups 1 KB apart, 16
      // rows (2 KB) per k step
      Wgmma<BN>::mma(d, wgmma_desc(a + j * 32, 16, 1024),
                     wgmma_desc(b + j * 2048, TK * 128, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (it > 0) {
      // the group before this one has retired: its stage is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (tid % 128 == 0) mbar_arrive(empty + ((it - 1) % STAGES) * 8);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");

  // epilogue. Thread (warp, lane) holds, for each 8-column group j, the
  // columns 8j + 2q, + 1 (q = lane % 4) of the pixels (th, r8) in d[4j],
  // d[4j + 1] and (th, r8 + 8) in d[4j + 2], d[4j + 3], with th = the warp
  // and r8 = lane / 4.
  const int q = lane % 4, r8 = lane / 4;
  const int h = h0 + warp, wa = w0 + r8, wb = wa + 8;
  const bool oka = h < H && wa < W, okb = h < H && wb < W;
  const bool odd = q & 1;
  // an even lane stores its first pixel's four columns, an odd lane its
  // second pixel's: 16 bytes each
  float* row = ws + ((size_t)(n * H + h) * W + (odd ? wb : wa)) * Cout + n0 +
               2 * (q & 2);
  const bool store = odd ? okb : oka;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float d0 = d[4 * j], d1 = d[4 * j + 1], d2 = d[4 * j + 2],
                d3 = d[4 * j + 3];
    float s1a = (oka ? d0 : 0.f) + (okb ? d2 : 0.f);
    float s1b = (oka ? d1 : 0.f) + (okb ? d3 : 0.f);
    float s2a = (oka ? d0 * d0 : 0.f) + (okb ? d2 * d2 : 0.f);
    float s2b = (oka ? d1 * d1 : 0.f) + (okb ? d3 * d3 : 0.f);
#pragma unroll
    for (int m = 4; m < 32; m *= 2) {
      s1a += __shfl_xor_sync(0xffffffffu, s1a, m);
      s1b += __shfl_xor_sync(0xffffffffu, s1b, m);
      s2a += __shfl_xor_sync(0xffffffffu, s2a, m);
      s2b += __shfl_xor_sync(0xffffffffu, s2b, m);
    }
    if (r8 == 0) {
      const int c = 8 * j + 2 * q;
      chs[warp * BN + c] = s1a;
      chs[warp * BN + c + 1] = s1b;
      chs[(8 + warp) * BN + c] = s2a;
      chs[(8 + warp) * BN + c + 1] = s2b;
    }
    const float e0 = __shfl_xor_sync(0xffffffffu, odd ? d0 : d2, 1);
    const float e1 = __shfl_xor_sync(0xffffffffu, odd ? d1 : d3, 1);
    if (store && n0 + 8 * j < Cout)
      *reinterpret_cast<float4*>(row + 8 * j) =
          odd ? make_float4(e0, e1, d2, d3) : make_float4(d0, d1, e0, e1);
  }
  bar_consumers();
  for (int c = tid; c < BN; c += CONSUMERS) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      t1 += chs[r * BN + c];
      t2 += chs[(8 + r) * BN + c];
    }
    tot[c] = t1;
    tot[BN + c] = t2;
  }
  bar_consumers();
  write_group_partials(tot, tot + BN, part,
                       ((size_t)n * tiles + tile) * gridDim.y + blockIdx.y,
                       n0, BN, Cout, G, CONSUMERS);
}

// f32 conv pass: 64 pixels x 128 channels per block; each thread a 4 x 8
// register tile of FMAs, so fp32 inputs keep full fp32 products.
__global__ void __launch_bounds__(THREADS)
conv_gn_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ weight, float* __restrict__ ws,
                   float2* __restrict__ part, int H, int W, int Cin, int Cout,
                   int G, int tiles) {
  constexpr int BN = BN_F32;
  __shared__ int rows[KK][BM];
  __shared__ __align__(16) float As[BK][BM + 4];   // transposed x tile
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float tot[2][BN];

  const int HW = H * W;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int m0 = tile * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // channels tx, tx+16, ..., tx+112
  const int ty = tid / 16;   // pixels 4*ty .. 4*ty+3

  tap_rows(rows, n, m0, H, W);
  __syncthreads();

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < KK; ++k) {
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int p = e / BK, c = e % BK, ci = c0 + c;
        const int idx = rows[k][p];
        As[c][p] = (idx >= 0 && ci < Cin) ? x[(size_t)idx * Cin + ci] : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kr = e / BN, o = e % BN;
        const int cw = c0 + kr, co = n0 + o;
        Bs[kr][o] = (cw < Cin && co < Cout)
                        ? weight[((size_t)k * Cin + cw) * Cout + co]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kr = 0; kr < BK; ++kr) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kr][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kr][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= HW) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co < Cout) {
        const float v = acc[i][j];
        ws[((size_t)n * HW + m) * Cout + co] = v;
        s1[j] += v;
        s2[j] += v * v;
      }
    }
  }
  // sum the 16 pixel rows of threads through Bs, free after the last slice
  float* r1 = &Bs[0][0];        // [16][BN]
  float* r2 = &Bs[16][0];       // [16][BN]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r1[ty * BN + tx + 16 * j] = s1[j];
    r2[ty * BN + tx + 16 * j] = s2[j];
  }
  __syncthreads();
  {
    const int c = tid % BN;
    const float* r = tid < BN ? r1 : r2;
    float t = 0.f;
    for (int q = 0; q < 16; ++q) t += r[q * BN + c];
    tot[tid / BN][c] = t;
  }
  __syncthreads();
  write_group_partials(tot[0], tot[1], part,
                       ((size_t)n * tiles + tile) * gridDim.y + blockIdx.y,
                       n0, BN, Cout, G, THREADS);
}

// mean and rstd of one (image, group) from its slots, in a fixed order.
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const float2* __restrict__ part, float2* __restrict__ stats,
                int G, int slots, float inv_cnt, float eps) {
  __shared__ float r1[THREADS], r2[THREADS];
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  const int tid = threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  for (int p = tid; p < slots; p += THREADS) {
    const float2 v = part[((size_t)n * slots + p) * G + g];
    s1 += v.x;
    s2 += v.y;
  }
  r1[tid] = s1;
  r2[tid] = s2;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h /= 2) {
    if (tid < h) {
      r1[tid] += r1[tid + h];
      r2[tid] += r2[tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    // E[y] and E[y^2] - E[y]^2 as the TPU kernel forms them, unfused
    const float mean = __fmul_rn(r1[0], inv_cnt);
    const float var = __fsub_rn(__fmul_rn(r2[0], inv_cnt),
                                __fmul_rn(mean, mean));
    stats[blockIdx.x] = make_float2(mean, 1.f / sqrtf(__fadd_rn(var, eps)));
  }
}

__device__ __forceinline__ float gn_relu(float y, float2 st, float gamma,
                                         float beta) {
  const float a = __fmul_rn(gamma, st.y);
  const float b = __fsub_rn(beta, __fmul_rn(st.x, a));
  return fmaxf(__fadd_rn(__fmul_rn(y, a), b), 0.f);
}

__device__ __forceinline__ void store4(float* out, size_t e,
                                       const float (&v)[4]) {
  *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t e,
                                       const float (&v)[4]) {
  *reinterpret_cast<uint2*>(out + e) =
      make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ void store1(float* out, size_t e, float v) {
  out[e] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* out, size_t e, float v) {
  out[e] = __float2bfloat16_rn(v);
}

// relu(y * a + b) for 4 consecutive channels per thread (4 | Cout).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply4_kernel(const float* __restrict__ ws,
                 const float2* __restrict__ stats,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out,
                 size_t total, size_t HWC, int Cout, int G) {
  const size_t e = ((size_t)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e >= total) return;
  const int n = (int)(e / HWC), c0 = (int)(e % Cout);
  const int cg = Cout / G;
  const float4 y = *reinterpret_cast<const float4*>(ws + e);
  const float yv[4] = {y.x, y.y, y.z, y.w};
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + q;
    v[q] = gn_relu(yv[q], stats[n * G + c / cg], gamma[c], beta[c]);
  }
  store4(out, e, v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply1_kernel(const float* __restrict__ ws,
                 const float2* __restrict__ stats,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out,
                 size_t total, size_t HWC, int Cout, int G) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int n = (int)(e / HWC), c = (int)(e % Cout);
  store1(out, e, gn_relu(ws[e], stats[n * G + c / (Cout / G)], gamma[c],
                         beta[c]));
}

// Which conv pass a call takes: the wgmma pass for bf16 with Cin and Cout
// multiples of 8 and 16-byte aligned bases (what TMA's maps need), else the
// element-wise tiles.
bool takes_wgmma(int Cin, int Cout, int is_bf16, int aligned) {
  return is_bf16 && aligned && Cin % 8 == 0 && Cout % 8 == 0;
}

int block_n(int Cout, int is_bf16) {
  return is_bf16 ? (Cout <= 64 ? 64 : 256) : BN_F32;
}

template <typename T>
void launch_apply(const float* ws, const float2* stats, const float* gamma,
                  const float* beta, void* out, size_t total, size_t HWC,
                  int Cout, int G, cudaStream_t s) {
  if (Cout % 4 == 0) {
    const size_t blocks = (total / 4 + THREADS - 1) / THREADS;
    gn_apply4_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
        ws, stats, gamma, beta, static_cast<T*>(out), total, HWC, Cout, G);
  } else {
    const size_t blocks = (total + THREADS - 1) / THREADS;
    gn_apply1_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
        ws, stats, gamma, beta, static_cast<T*>(out), total, HWC, Cout, G);
  }
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* weight, float* ws,
                         float2* part, int N, int H, int W, int Cin, int Cout,
                         int G, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                            (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xb[4] = {TK, TW, TH, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, KK};
  const cuuint64_t wst[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t wb[3] = {64, TK, 1};
  if (!bf16_map(&xmap, x, 4, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&wmap, weight, 3, wd, wst, wb, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem_bytes(BN);
  // above 48 KB a kernel has to be allowed its shared memory; the
  // attribute belongs to the current device, so it is set at every launch
  const cudaError_t allowed = cudaFuncSetAttribute(
      conv_gn_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (allowed != cudaSuccess) return allowed;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid((unsigned)(N * tiles_w * tiles_h),
                  (unsigned)((Cout + BN - 1) / BN));
  conv_gn_wgmma_kernel<BN><<<grid, WG_THREADS, smem, s>>>(
      xmap, wmap, ws, part, H, W, Cin, Cout, G, tiles_w, tiles_w * tiles_h);
  return cudaGetLastError();
}

}  // namespace

// Slots of the partials buffer per image: (pixel tiles) x (column blocks).
// The caller allocates N * slots * G float2 for it. aligned: x's and the
// weight's base addresses are multiples of 16.
extern "C" int conv_gn_relu_slots(int H, int W, int Cin, int Cout,
                                  int is_bf16, int aligned) {
  const int bn = block_n(Cout, is_bf16);
  const int tiles = takes_wgmma(Cin, Cout, is_bf16, aligned)
                        ? ((H + TH - 1) / TH) * ((W + TW - 1) / TW)
                        : (H * W + BM - 1) / BM;
  return tiles * ((Cout + bn - 1) / bn);
}

// x (N,H,W,Cin), weight (9,Cin,Cout) in x's type (f32: is_bf16 = 0, bf16:
// is_bf16 = 1); gamma, beta (Cout,) f32; out (N,H,W,Cout) in x's type;
// scratch: ws (N,H,W,Cout) f32, part (N, slots, G) float2, stats (N, G)
// float2. All contiguous; G divides Cout. Returns cudaGetLastError() after
// the first launch that fails, or after the last.
extern "C" int conv_gn_relu_forward(const void* x, const void* weight,
                                    const void* gamma, const void* beta,
                                    void* out, void* ws, void* part,
                                    void* stats, int N, int H, int W,
                                    int Cin, int Cout, int G, float eps,
                                    int is_bf16, void* stream) {
  const size_t HW = (size_t)H * W;
  if (N == 0 || HW == 0 || Cout == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int aligned = ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(weight)) % 16) == 0;
  const bool wgmma = takes_wgmma(Cin, Cout, is_bf16, aligned);
  const int slots = conv_gn_relu_slots(H, W, Cin, Cout, is_bf16, aligned);
  float* wsf = static_cast<float*>(ws);
  float2* pt = static_cast<float2*>(part);
  cudaError_t err;
  const int tiles = (int)((HW + BM - 1) / BM);
  const int bn = block_n(Cout, is_bf16);
  const dim3 grid((unsigned)(N * tiles), (unsigned)((Cout + bn - 1) / bn));
  if (wgmma) {
    err = bn == 64 ? launch_wgmma<64>(x, weight, wsf, pt, N, H, W, Cin, Cout,
                                      G, s)
                   : launch_wgmma<256>(x, weight, wsf, pt, N, H, W, Cin, Cout,
                                       G, s);
  } else if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(weight);
    if (bn == 64)
      conv_gn_bf16_kernel<64, 4, 2><<<grid, THREADS, 0, s>>>(
          xb, wb, wsf, pt, H, W, Cin, Cout, G, tiles);
    else
      conv_gn_bf16_kernel<256, 2, 4><<<grid, THREADS, 0, s>>>(
          xb, wb, wsf, pt, H, W, Cin, Cout, G, tiles);
    err = cudaGetLastError();
  } else {
    conv_gn_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(weight), wsf,
        pt, H, W, Cin, Cout, G, tiles);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const double cnt = (double)HW * (Cout / G);
  float2* st = static_cast<float2*>(stats);
  gn_stats_kernel<<<(unsigned)(N * G), THREADS, 0, s>>>(
      pt, st, G, slots, (float)(1.0 / cnt), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)N * HW * Cout;
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  if (is_bf16)
    launch_apply<__nv_bfloat16>(wsf, st, gm, bt, out, total, HW * Cout, Cout,
                                G, s);
  else
    launch_apply<float>(wsf, st, gm, bt, out, total, HW * Cout, Cout, G, s);
  return (int)cudaGetLastError();
}
