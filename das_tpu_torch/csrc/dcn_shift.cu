// DCNv2 by the clamped-offset shift expansion, hand-written for Hopper
// (sm_90a). Built by das_tpu_torch/ops/dcn_shift.py with nvcc into a shared
// library with a plain C interface and called through ctypes.
//
// Replaces: das_tpu/ops/pallas_dcn.py::deform_conv_shift_pallas (the TPU
// kernel K1). Same function: NHWC, K=3, pad 1, stride 1, one deform group.
// Per tap k the (dy, dx) offset is clamped to [-r, r]; the tap value is the
// hat-weighted sum of the zero-padded input over the (2r+2)^2 integer window,
// summed in x's type; it is scaled by the mask m_k in x's type and
// contracted with W_k (Cin x Cout). The nine contractions accumulate in f32;
// the sum is cast to x's type and the bias is added in x's type.
//
// The backward (below the forward passes) has a lane pass and, for bf16
// with 64 | Cin, a tiled pass: a patch-staged tap kernel beside the lane
// pass's dx kernel; see there.
//
// Only the 2x2 corners around the clamped point have a nonzero hat weight,
// so the kernels read those four, in window order, and round as the plain
// version does: each hat weight, product and partial sum to x's type, with
// no fused multiply-add. The f32 and the element-wise bf16 kernels add in
// f32 and round, as PyTorch does; the wgmma pass adds in packed bf16
// (add.rn.bf16x2), which rounds once where PyTorch rounds twice (to f32,
// then to bf16), so an element of its tap tile can differ from the plain
// version's by one bf16 step where the f32 sum is a tie. Otherwise only the
// order of the f32 sums differs.
//
// What bounds it on an H100: the contraction. At the serving shapes
// (Cin = Cout = 256) it is 2*9*256*256 = 1.18 MFLOP per output pixel against
// about 1.1 KB of compulsory traffic (x, offsets, mask, output), some 1000
// operations per byte, far above the card's ~295 bf16 tensor-core operations
// per byte. So the kernel is bound by operations, and the tensor cores must
// do the product. Next to it stands the tap tile: ~20 CUDA-core operations
// per element of a (pixels x 9 x Cin) tile, as long on the CUDA cores as the
// product on the tensor cores unless it is packed two to an instruction and
// overlapped with the product.
//
// The bf16 pass on wgmma (64 | Cin, 64 | Cout, 16-byte aligned bases):
//   * A block owns an 8 x 16 patch of output pixels of ONE image x BN output
//     channels (256; 128 where a level has too few patches to fill the
//     card). With the offset clamped, every corner of every tap of those
//     pixels lies in rows -(r+1)..+(r+2) around the patch: PH x PW =
//     (8+2r+3) x (16+2r+3) pixels (13 x 21 at r=1). The TPU kernel kept a
//     4-row band of full width with all channels in VMEM; here one
//     64-channel slice of the halo'd patch (35 KB at r=1) is staged in shared
//     memory by ONE TMA box of a 4-D map over (N, H, W, Cin); what lies
//     outside the image arrives as zeros, which is the zero padding. Global
//     reads of x fall from 36x (four corners of nine taps, from L1/L2) to
//     ~2.1x. Loop order: channel slice outside, tap inside; the next slice's
//     patch is in flight while this one is used (two buffers).
//   * Per (pixel, tap), once per block: the patch-local byte offset of the
//     top-left corner, the four hat weights rounded to bf16 and the mask, 16
//     bytes, 18 KB in all, reused by every channel slice.
//   * The product: two consumer warpgroups of 64 pixels each issue
//     m64nBNk16 wgmma with f32 accumulators in registers (128 a thread at
//     BN = 256). B is W_k's 64 x BN slice, brought by TMA from a 3-D map
//     over (9, Cin, Cout) into a ring (3 stages at r=1, 2 at r=2) in the
//     128-byte swizzle, MN-major, 64-column chunks 8 KB apart, with a "full"
//     and an "empty" mbarrier a stage.
//   * The A operand, the 128 x 64 tap tile, is built by the consumer threads
//     themselves, each warpgroup its own 64 rows, into shared memory in the
//     128-byte swizzle the descriptor expects (16-byte chunk index XOR row
//     mod 8), in one of two buffers: a thread reads 16 bytes (8 channels) of
//     each of the four corners, eight threads a pixel (so a warp reads four
//     whole 128-byte pixels and no two threads share a bank whatever the
//     offsets; the metadata that holds their addresses is loaded one tap
//     ahead), multiplies and adds in packed bf16 and stores 16 bytes; then
//     fence.proxy.async, a warpgroup barrier, wgmma.fence and the four
//     wgmma of the slice. wgmma is asynchronous: while tap t multiplies, the
//     same threads build tap t+1; they wait only for tap t-1 to retire,
//     which frees its A buffer and its W stage.
//   * Two producer warps: one keeps the W ring full, one the patch buffers.
//     A barrier that never completes traps instead of hanging.
//   * Epilogue: the f32 sums go, rounded to bf16, through shared memory (the
//     W ring is free by then) and leave as whole rows, 16 bytes a lane, with
//     the bias added in bf16 on the way.
// Shared memory at r=1, BN=256: W ring 3 x 32 KB, A 2 x 16 KB, patch
// 2 x 34.1 KB, metadata 18 KB, barriers: 215.4 KB of 227. At r=2 the patch
// is 15 x 23 (43.1 KB a buffer) and the ring has 2 stages: 201.3 KB.
//
// Other shapes: f32 runs true FMAs (64 pixels x 128 channels a block, a
// 4 x 8 register tile a thread, tap tile built from global memory), and bf16
// shapes that the wgmma pass does not take run WMMA (mma.sync) on 64 pixels
// x 256 channels a block, tiles filled with 16-byte loads (8 | Cin, 8 | Cout)
// or element by element.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output pixels per block
constexpr int BK = 32;        // input channels per slice
constexpr int THREADS = 256;  // eight warps
constexpr int KK = 9;         // 3 x 3 taps
constexpr int BN_BF16 = 256;  // output channels per block, bf16 kernel
constexpr int BN_F32 = 128;   // output channels per block, f32 kernel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to T's precision (the plain version's elementwise ops
// compute in f32 and store in T).
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Along one axis, the displacement of tap place kp's sample from its output
// pixel: the offset clamped to [-r, r], plus kp - 1. Every kernel takes the
// displacement and the hat weights from these two, which round as the plain
// version does.
__device__ __forceinline__ float shifted(float o, float r, int kp) {
  return __fadd_rn(fminf(fmaxf(o, -r), r), (float)(kp - 1));
}
// The hat weight max(0, 1 - |t|) of a pixel at t = i - d from the sample.
__device__ __forceinline__ float hat_w(float t) {
  return fmaxf(0.f, 1.f - fabsf(t));
}

// Element e of 8 bf16 values held in a 16-byte load, as f32.
__device__ __forceinline__ float bf16_lane(const uint4& q, int e) {
  const uint32_t w = e < 2 ? q.x : e < 4 ? q.y : e < 6 ? q.z : q.w;
  return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
}

// Two f32 values (already of bf16 precision) as packed bf16, a first.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Bilinear corners of one tap for every pixel of the block.
struct TapMeta {
  int idx[4][BM];   // flat input pixel (n*H + y)*W + x, or -1 outside
  float w[4][BM];   // hat weight of the corner, rounded to T
  float m[BM];      // modulation mask of the tap
};

template <typename T>
__device__ __forceinline__ void build_meta(TapMeta& meta, const float* offset,
                                           const T* mask, int m0, int P,
                                           int H, int W, int k, float r) {
  const int i = threadIdx.x;
  if (i >= BM) return;
  const int gp = m0 + i;
  if (gp >= P) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      meta.idx[j][i] = -1;
      meta.w[j][i] = 0.f;
    }
    meta.m[i] = 0.f;
    return;
  }
  const int HW = H * W;
  const int n = gp / HW;
  const int rem = gp - n * HW;
  const int py = rem / W;
  const int px = rem - py * W;
  const int kh = k / 3, kw = k % 3;
  const float oy = offset[(size_t)gp * (2 * KK) + 2 * k];
  const float ox = offset[(size_t)gp * (2 * KK) + 2 * k + 1];
  // clamped displacement of the tap from the output pixel
  const float dy = shifted(oy, r, kh);
  const float dx = shifted(ox, r, kw);
  const float fy = floorf(dy), fx = floorf(dx);
  // hat weights as the plain version writes them: max(0, 1 - |i - d|)
  float wy[2], wx[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    wy[a] = hat_w(__fsub_rn(fy + (float)a, dy));
    wx[a] = hat_w(__fsub_rn(fx + (float)a, dx));
  }
  const int y0 = py + (int)fy, x0 = px + (int)fx;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int yy = y0 + a, xx = x0 + b;
      const bool inb = yy >= 0 && yy < H && xx >= 0 && xx < W;
      meta.idx[2 * a + b][i] = inb ? (n * H + yy) * W + xx : -1;
      meta.w[2 * a + b][i] = inb ? rnd<T>(__fmul_rn(wy[a], wx[b])) : 0.f;
    }
  }
  meta.m[i] = to_f(mask[(size_t)gp * KK + k]);
}

// Modulated tap value from the four corner values of one channel: window
// order, each product and partial sum rounded to T, then times the mask.
template <typename T>
__device__ __forceinline__ float modulated_tap(const TapMeta& meta, int p,
                                               const float (&xv)[4]) {
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (meta.idx[j][p] >= 0)
      v = rnd<T>(__fadd_rn(v, rnd<T>(__fmul_rn(xv[j], meta.w[j][p]))));
  return rnd<T>(__fmul_rn(v, meta.m[p]));
}

// Modulated tap value of pixel p (block-local) at input channel ci.
template <typename T>
__device__ __forceinline__ float tap_value(const TapMeta& meta, const T* x,
                                           int p, int ci, int Cin) {
  float xv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = meta.idx[j][p];
    xv[j] = idx >= 0 ? to_f(x[(size_t)idx * Cin + ci]) : 0.f;
  }
  return modulated_tap<T>(meta, p, xv);
}

__global__ void __launch_bounds__(THREADS)
dcn_shift_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ offset,
                      const __nv_bfloat16* __restrict__ mask,
                      const __nv_bfloat16* __restrict__ weight,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      int N, int H, int W, int Cin, int Cout, float r,
                      bool vec) {
  constexpr int BN = BN_BF16;
  __shared__ TapMeta meta;
  __shared__ __align__(128) __nv_bfloat16 As[BM][BK + 8];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][BN + 8];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int P = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4;   // 2 warp rows of 32 pixels
  const int wn = warp % 4;   // 4 warp columns of 64 channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < KK; ++k) {
    build_meta(meta, offset, mask, m0, P, H, W, k, r);
    __syncthreads();
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      if (vec) {
        // W_k slice: 32 rows x 256 channels, 8 channels per 16-byte load
        uint4 wv[BK * BN / 8 / THREADS];
#pragma unroll
        for (int t = 0; t < BK * BN / 8 / THREADS; ++t) {
          const int e = tid + t * THREADS;
          const int kk = e / (BN / 8), o = (e % (BN / 8)) * 8;
          const int ci = c0 + kk, co = n0 + o;
          wv[t] = (ci < Cin && co < Cout)
                      ? __ldg(reinterpret_cast<const uint4*>(
                            weight + ((size_t)k * Cin + ci) * Cout + co))
                      : make_uint4(0, 0, 0, 0);
        }
        // tap tile: thread -> (pixel, 8 channels); the 4 corners' loads
        // are independent, so they are in flight together
        const int p = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
        const int ci = c0 + c;
        uint4 q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = meta.idx[j][p];
          q[j] = (idx >= 0 && ci < Cin)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           x + (size_t)idx * Cin + ci))
                     : make_uint4(0, 0, 0, 0);
        }
        float tv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float xv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = bf16_lane(q[j], e);
          tv[e] = modulated_tap<__nv_bfloat16>(meta, p, xv);
        }
        *reinterpret_cast<uint4*>(&As[p][c]) =
            make_uint4(pack_bf16x2(tv[0], tv[1]), pack_bf16x2(tv[2], tv[3]),
                       pack_bf16x2(tv[4], tv[5]), pack_bf16x2(tv[6], tv[7]));
#pragma unroll
        for (int t = 0; t < BK * BN / 8 / THREADS; ++t) {
          const int e = tid + t * THREADS;
          *reinterpret_cast<uint4*>(&Bs[e / (BN / 8)][(e % (BN / 8)) * 8]) =
              wv[t];
        }
      } else {
        for (int e = tid; e < BM * BK; e += THREADS) {
          const int p = e / BK, c = e % BK, ci = c0 + c;
          const float v = ci < Cin ? tap_value(meta, x, p, ci, Cin) : 0.f;
          As[p][c] = __float2bfloat16_rn(v);
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
          const int kk = e / BN, o = e % BN;
          const int ci = c0 + kk, co = n0 + o;
          Bs[kk][o] = (ci < Cin && co < Cout)
                          ? weight[((size_t)k * Cin + ci) * Cout + co]
                          : __float2bfloat16(0.f);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], BK + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, &Bs[kk][wn * 64 + j * 16], BN + 8);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: f32 sum -> bf16, then + bias in bf16
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int gp = m0 + wm * 32 + i * 16 + e / 16;
        const int co = n0 + wn * 64 + j * 16 + e % 16;
        if (gp < P && co < Cout) {
          __nv_bfloat16 v = __float2bfloat16_rn(cs[e]);
          if (bias != nullptr)
            v = __float2bfloat16_rn(__bfloat162float(v) +
                                    __bfloat162float(bias[co]));
          out[(size_t)gp * Cout + co] = v;
        }
      }
      __syncwarp();
    }
  }
}

// ---- the bf16 pass on wgmma: W by TMA, x's patch by TMA, A built here ------

constexpr int TH = 8, TW = 16;           // the block's patch: 128 pixels
constexpr int TK = 64;                   // input channels per slice: 128 bytes
constexpr int A_BYTES = TH * TW * TK * 2;               // 16 KB
constexpr int META_BYTES = KK * TH * TW * 16;           // 18 KB
constexpr int WG_THREADS = CONSUMERS + 64;   // two consumer warpgroups and
                                             // two producer warps

__host__ __device__ constexpr int patch_h(int r) { return TH + 2 * r + 3; }
__host__ __device__ constexpr int patch_w(int r) { return TW + 2 * r + 3; }
__host__ __device__ constexpr int patch_bytes(int r) {
  return patch_h(r) * patch_w(r) * TK * 2;
}
__host__ __device__ constexpr int w_stages(int r) { return r == 1 ? 3 : 2; }
constexpr int wgmma_smem_bytes(int r, int bn) {
  // 1 KB to align, the W ring, two A tiles, two patch slices, the metadata,
  // the barriers (full and empty per W stage and per patch buffer)
  return 1024 + w_stages(r) * TK * bn * 2 + 2 * A_BYTES +
         2 * patch_bytes(r) + META_BYTES + (2 * w_stages(r) + 4) * 8;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Two channels of the modulated tap from the four corners' values: window
// order, each product and partial sum rounded to bf16 (packed, never fused),
// then times the mask. The sum starts from +0 as the plain version's does.
// tap_sum2 is the same before the mask (the tap tile T of the backward).
__device__ __forceinline__ uint32_t tap_sum2(uint32_t x00, uint32_t x01,
                                             uint32_t x10, uint32_t x11,
                                             __nv_bfloat162 w00,
                                             __nv_bfloat162 w01,
                                             __nv_bfloat162 w10,
                                             __nv_bfloat162 w11) {
  __nv_bfloat162 v = __hadd2_rn(as_bf162(0u), __hmul2_rn(as_bf162(x00), w00));
  v = __hadd2_rn(v, __hmul2_rn(as_bf162(x01), w01));
  v = __hadd2_rn(v, __hmul2_rn(as_bf162(x10), w10));
  v = __hadd2_rn(v, __hmul2_rn(as_bf162(x11), w11));
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t mul2(uint32_t v, __nv_bfloat162 m) {
  const __nv_bfloat162 p = __hmul2_rn(as_bf162(v), m);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t tap2(uint32_t x00, uint32_t x01,
                                         uint32_t x10, uint32_t x11,
                                         __nv_bfloat162 w00,
                                         __nv_bfloat162 w01,
                                         __nv_bfloat162 w10,
                                         __nv_bfloat162 w11,
                                         __nv_bfloat162 m) {
  return mul2(tap_sum2(x00, x01, x10, x11, w00, w01, w10, w11), m);
}

// One block: the 8 x 16 patch (h0.., w0..) of image n x output channels
// [n0, n0 + BN). Warps 0-7 are the two consumer warpgroups, which build the
// tap tiles and multiply; warp 8 feeds the W ring, warp 9 the patch buffers.
template <int R, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
dcn_shift_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ offset,
                       const __nv_bfloat16* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int H, int W, int Cin,
                       int Cout, int tiles_w, int tiles) {
  constexpr int PW = patch_w(R);
  constexpr int PATCH = patch_bytes(R);
  constexpr int STAGES = w_stages(R);
  constexpr int B_BYTES = TK * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* a_tiles = smem + STAGES * B_BYTES;
  uint8_t* patches = a_tiles + 2 * A_BYTES;
  uint4* meta = reinterpret_cast<uint4*>(patches + 2 * PATCH);   // [KK][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(patches + 2 * PATCH +
                                               META_BYTES);
  const uint32_t ring = smem_u32(smem);
  const uint32_t wfull = smem_u32(bars), wempty = wfull + STAGES * 8;
  const uint32_t pfull = wempty + STAGES * 8, pempty = pfull + 2 * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int nsl = Cin / TK;
  const int iters = KK * nsl;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(wfull + s * 8, 1);    // the producer's arrive with the bytes
      mbar_init(wempty + s * 8, 2);   // one arrive per consumer warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(pfull + s * 8, 1);
      mbar_init(pempty + s * 8, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {          // the W ring: slice outside, tap in
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        mbar_wait(wempty + s * 8, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(wfull + s * 8, B_BYTES);
        const int sl = it / KK, k = it - sl * KK;
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load_3d(ring + s * B_BYTES + q * (TK * 128), &wmap,
                      wfull + s * 8, n0 + q * 64, sl * TK, k);
      }
    }
    return;
  }
  if (warp == CONSUMERS / 32 + 1) {      // x's halo'd patch, slice by slice
    if (lane == 0) {
      for (int sl = 0; sl < nsl; ++sl) {
        const int s = sl % 2;
        mbar_wait(pempty + s * 8, ((sl / 2) & 1) ^ 1);
        mbar_expect_tx(pfull + s * 8, PATCH);
        tma_load_4d(smem_u32(patches + s * PATCH), &xmap, pfull + s * 8,
                    sl * TK, w0 - (R + 1), h0 - (R + 1), n);
      }
    }
    return;
  }

  // per (tap, pixel): the top-left corner's byte offset in a patch slice,
  // the four hat weights (bf16) and the mask (bf16, in both halves)
#pragma unroll
  for (int i = 0; i < (KK * TH * TW + CONSUMERS - 1) / CONSUMERS; ++i) {
    const int e = tid + i * CONSUMERS;
    if (e >= KK * TH * TW) break;
    const int p = e / KK, k = e - p * KK;
    const int ph = p / TW, pw = p % TW;
    const int py = h0 + ph, px = w0 + pw;
    uint4 md = make_uint4(0u, 0u, 0u, 0u);
    if (py < H && px < W) {
      const size_t gp = ((size_t)n * H + py) * W + px;
      const float r = (float)R;
      const float oy = offset[gp * (2 * KK) + 2 * k];
      const float ox = offset[gp * (2 * KK) + 2 * k + 1];
      // clamped displacement of the tap from the output pixel
      const float dy = shifted(oy, r, k / 3);
      const float dx = shifted(ox, r, k % 3);
      const float fy = floorf(dy), fx = floorf(dx);
      // hat weights as the plain version writes them: max(0, 1 - |i - d|)
      float wy[2], wx[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        wy[a] = hat_w(__fsub_rn(fy + (float)a, dy));
        wx[a] = hat_w(__fsub_rn(fx + (float)a, dx));
      }
      const int ly = ph + (int)fy + R + 1, lx = pw + (int)fx + R + 1;
      const uint32_t mk = (uint32_t)__bfloat16_as_ushort(mask[gp * KK + k]);
      md.x = (uint32_t)((ly * PW + lx) * (TK * 2));
      md.y = bf16_bits(__fmul_rn(wy[0], wx[0])) |
             bf16_bits(__fmul_rn(wy[0], wx[1])) << 16;
      md.z = bf16_bits(__fmul_rn(wy[1], wx[0])) |
             bf16_bits(__fmul_rn(wy[1], wx[1])) << 16;
      md.w = mk | mk << 16;
    }
    meta[k * (TH * TW) + p] = md;
  }
  bar_consumers();

  const int wg = warp / 4, t = tid % 128;
  const int chunk = t % 8;               // the thread's 16 bytes of a pixel
  const int mrow = t / 8;                // its rows: mrow + 16 i, i < 4
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  // the metadata of the thread's four rows, loaded one tap ahead, so that
  // the corner reads, whose addresses it holds, need not wait for it
  uint4 mds[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mds[i] = meta[wg * 64 + mrow + 16 * i];

  for (int it = 0; it < iters; ++it) {
    const int sl = it / KK, k = it - sl * KK;
    if (k == 0) mbar_wait(pfull + (sl % 2) * 8, (sl / 2) & 1);
    // build this warpgroup's 64 rows of the tap tile; its buffer is free:
    // the wgmma that read it (two taps ago) has retired
    const uint8_t* patch = patches + (sl % 2) * PATCH + chunk * 16;
    uint8_t* atile = a_tiles + (it % 2) * A_BYTES + wg * (64 * 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mrow + 16 * i;
      const uint4 md = mds[i];
      const uint8_t* c = patch + md.x;
      const uint4 q00 = *reinterpret_cast<const uint4*>(c);
      const uint4 q01 = *reinterpret_cast<const uint4*>(c + TK * 2);
      const uint4 q10 = *reinterpret_cast<const uint4*>(c + PW * TK * 2);
      const uint4 q11 = *reinterpret_cast<const uint4*>(c + (PW + 1) * TK * 2);
      const __nv_bfloat162 w00 = as_bf162(__byte_perm(md.y, md.y, 0x1010));
      const __nv_bfloat162 w01 = as_bf162(__byte_perm(md.y, md.y, 0x3232));
      const __nv_bfloat162 w10 = as_bf162(__byte_perm(md.z, md.z, 0x1010));
      const __nv_bfloat162 w11 = as_bf162(__byte_perm(md.z, md.z, 0x3232));
      const __nv_bfloat162 mk = as_bf162(md.w);
      uint4 o;
      o.x = tap2(q00.x, q01.x, q10.x, q11.x, w00, w01, w10, w11, mk);
      o.y = tap2(q00.y, q01.y, q10.y, q11.y, w00, w01, w10, w11, mk);
      o.z = tap2(q00.z, q01.z, q10.z, q11.z, w00, w01, w10, w11, mk);
      o.w = tap2(q00.w, q01.w, q10.w, q11.w, w00, w01, w10, w11, mk);
      *reinterpret_cast<uint4*>(atile + m * 128 + ((chunk ^ (m & 7)) * 16)) =
          o;
    }
    {
      const uint4* mt =
          meta + (k == KK - 1 ? 0 : k + 1) * (TH * TW) + wg * 64 + mrow;
#pragma unroll
      for (int i = 0; i < 4; ++i) mds[i] = mt[16 * i];
    }
    // the tile was written by ordinary stores and is read by wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_warpgroup(wg);
    if (k == KK - 1 && t == 0) mbar_arrive(pempty + (sl % 2) * 8);
    const int s = it % STAGES;
    mbar_wait(wfull + s * 8, (it / STAGES) & 1);
    const uint32_t a = smem_u32(atile);
    const uint32_t b = ring + s * B_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < TK / 16; ++j)
      // A: rows of 128 bytes, 8-row groups 1 KB apart, 32 bytes per k step;
      // W: 64-column chunks 8 KB apart, 8-row groups 1 KB apart, 16 rows
      // (2 KB) per k step
      Wgmma<BN>::mma(d, wgmma_desc(a + j * 32, 16, 1024),
                     wgmma_desc(b + j * 2048, TK * 128, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (it > 0) {
      // the group before this one has retired: its W stage is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (t == 0) mbar_arrive(wempty + ((it - 1) % STAGES) * 8);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");

  // epilogue. Thread (warp, lane) holds, for each 8-column group j, the
  // columns 8j + 2q, + 1 (q = lane % 4) of the pixels (th, r8) in d[4j],
  // d[4j + 1] and (th, r8 + 8) in d[4j + 2], d[4j + 3], with th = the warp
  // and r8 = lane / 4. The sums go, rounded to bf16, through shared memory
  // (the W ring and the A tiles are free now; rows 16 bytes longer than
  // BN channels, so that the eight pixels of a warp's store fall on
  // different banks) and leave as whole rows: a warp reads one pixel's BN
  // channels, adds the bias in bf16 and stores 16 bytes a lane.
  constexpr int SROW = BN * 2 + 16;          // bytes per staged pixel
  const int q = lane % 4, r8 = lane / 4;
  bar_consumers();                           // both warpgroups' wgmma retired
  {
    uint8_t* pa = smem + (warp * TW + r8) * SROW + q * 4;
    uint8_t* pb = pa + 8 * SROW;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<uint32_t*>(pa + j * 16) =
          pack_bf16x2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(pb + j * 16) =
          pack_bf16x2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
  bar_consumers();
  constexpr int LANES = BN / 8;              // 16-byte pieces of a row
  const int piece = tid % LANES;
  const int col = n0 + piece * 8;
  if (col < Cout) {
    float bv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      bv[c] = bias != nullptr ? __bfloat162float(bias[col + c]) : 0.f;
    for (int p = tid / LANES; p < TH * TW; p += CONSUMERS / LANES) {
      const int h = h0 + p / TW, w = w0 + p % TW;
      if (h >= H || w >= W) continue;
      uint4 v = *reinterpret_cast<const uint4*>(smem + p * SROW + piece * 16);
      if (bias != nullptr) {
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float lo = __uint_as_float(u[c] << 16);
          const float hi = __uint_as_float(u[c] & 0xffff0000u);
          u[c] = pack_bf16x2(__fadd_rn(lo, bv[2 * c]),
                             __fadd_rn(hi, bv[2 * c + 1]));
        }
      }
      *reinterpret_cast<uint4*>(out + ((size_t)(n * H + h) * W + w) * Cout +
                                col) = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dcn_shift_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     float* __restrict__ out,
                     int N, int H, int W, int Cin, int Cout, float r) {
  constexpr int BN = BN_F32;
  __shared__ TapMeta meta;
  __shared__ __align__(16) float As[BK][BM + 4];   // transposed tap tile
  __shared__ __align__(16) float Bs[BK][BN];

  const int P = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // channels tx, tx+16, ..., tx+112
  const int ty = tid / 16;   // pixels 4*ty .. 4*ty+3

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < KK; ++k) {
    build_meta(meta, offset, mask, m0, P, H, W, k, r);
    __syncthreads();
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int p = e / BK, c = e % BK, ci = c0 + c;
        As[c][p] = ci < Cin ? tap_value(meta, x, p, ci, Cin) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, o = e % BN;
        const int ci = c0 + kk, co = n0 + o;
        Bs[kk][o] = (ci < Cin && co < Cout)
                        ? weight[((size_t)k * Cin + ci) * Cout + co]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gp = m0 + ty * 4 + i;
    if (gp >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co < Cout) {
        float v = acc[i][j];
        if (bias != nullptr) v = v + bias[co];
        out[(size_t)gp * Cout + co] = v;
      }
    }
  }
}

// ---- the backward: the tap kernel and the dx kernel ------------------------
//
// The gradient of the function above, with the conventions of JAX's autodiff
// of the XLA shift expansion (das_tpu/ops/deform_conv.py:111, which the JAX
// package trains; the Pallas kernel has no VJP) where the hat weights and
// the clamp have kinks. Per tap k, with T_k the tap tile (the window sum,
// before the mask), A_k = m_k T_k, G the output gradient and U_k = G W_k^T
// (P x Cin, given):
//   dmask_k   = sum_c U_k T_k
//   doffset_k = m_k clamp'(o) sum_c U_k dT_k/d(dy, dx)
//   dx(q)     = sum over the (pixel p, tap k) whose window holds q of
//               hat hat m_k(p) U_k(p)
// and A_k is written for dW_k = A_k^T G. U and dW are plain large matrix
// products outside any kernel (torch.matmul in ops/dcn_shift.py), as the
// JAX package leaves them to XLA as the transpose of its einsum.
//
// What bounds it: with the products outside, both kernels stream. The tap
// kernel reads U and writes A, two (P x 9 x Cin) tensors (2 GB in bf16 at
// 4 x 160 x 336 x 256), and reads x's corners from the caches; the dx
// kernel reads U again. So they are bound by bytes, ~1 ms at 3.35 TB/s at
// that shape against ~0.5 ms of the products at the tensor-core peak.
// Design: one warp a (pixel, tap), 8 bf16 or 4 f32 channels a lane in one
// 16-byte load (every load of a pass issued before any is used), the tile
// recomputed from x as the forward rounds it (the forward keeps none), the
// three channel sums reduced by shuffles; the derivative's
// extra rows and columns (the slopes where i - d is exactly -1 or +1 in
// f32: an integer offset, or one within half an ulp of an integer) read
// only where their slope is not zero, which is the same for the whole
// warp. dx is the transpose of the shift as a gather: one warp an input
// pixel, whose lanes examine the (2r+2)^2 window of every tap side by side
// and then add the rows of U they found in a fixed order: no atomics,
// deterministic.

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// d hat(i - d) / d d at t = i - d, hat(t) = max(0, 1 - |t|), as JAX's
// autodiff gives it: |t|' = +1 at t = 0, and max passes half at a tie. So
// +1 for 0 <= t < 1, -1 for -1 < t < 0, +0.5 at t = 1, -0.5 at t = -1, 0
// beyond.
__device__ __forceinline__ float hat_slope(float t) {
  const float a = fabsf(t);
  const float mag = a < 1.f ? 1.f : (a == 1.f ? 0.5f : 0.f);
  return t >= 0.f ? mag : -mag;
}

// jnp.clip's slope: 1 inside (-r, r), 0.5 at exactly +-r, 0 beyond.
__device__ __forceinline__ float clamp_slope(float o, float r) {
  const float a = fabsf(o);
  return a < r ? 1.f : (a == r ? 0.5f : 0.f);
}

// V channels of T a lane: one 16-byte load or store where V > 1 (8 bf16 or
// 4 f32 channels), else one element.
template <typename T, int V>
struct Lanes;
template <typename T>
struct Lanes<T, 1> {
  using raw = T;
  static __device__ __forceinline__ raw load(const T* p) { return *p; }
  static __device__ __forceinline__ raw zero() { return from_f<T>(0.f); }
  static __device__ __forceinline__ float get(const raw& r, int) {
    return to_f(r);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *p = from_f<T>(v[0]);
  }
};
template <>
struct Lanes<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ float get(const raw& r, int e) {
    return bf16_lane(r, e);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
};
template <>
struct Lanes<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float get(const raw& r, int e) {
    return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// One warp a (pixel, tap), V channels a lane. u == nullptr: the tile alone.
// Writes what is not null of tile (P x 9 x Cin), dmask (P x 9, in T) and
// doffset (P x 18, f32). The launcher keeps P x 9 below 2^31.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
dcn_shift_bwd_tap_kernel(const T* __restrict__ x,
                         const float* __restrict__ offset,
                         const T* __restrict__ mask, const T* __restrict__ u,
                         T* __restrict__ tile, float* __restrict__ doffset,
                         T* __restrict__ dmask, int N, int H, int W, int Cin,
                         int R) {
  using L = Lanes<T, V>;
  const int e = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (e >= N * H * W * KK) return;
  const int lane = threadIdx.x % 32;
  const int gp = e / KK, k = e - gp * KK;
  const int kh = k / 3, kw = k % 3;
  const int n = gp / (H * W);
  const int rem = gp - n * (H * W);
  const int py = rem / W, px = rem - py * W;
  const float r = (float)R;
  const float oy = offset[(size_t)gp * (2 * KK) + 2 * k];
  const float ox = offset[(size_t)gp * (2 * KK) + 2 * k + 1];
  // clamped displacement of the tap from the output pixel, as the forward
  const float dy = shifted(oy, r, kh);
  const float dx = shifted(ox, r, kw);
  const int iy0 = (int)floorf(dy), ix0 = (int)floorf(dx);
  // rows iy0 - 1 .. iy0 + 2 and columns ix0 - 1 .. ix0 + 2 (index 0..3):
  // the hat weights (zero but at index 1 and 2), their slopes inside the
  // tap's window, displacements kh - 1 - R .. kh + R (row iy0 - 1 leaves
  // it where the clamped offset is -R), and whether the pixel lies in the
  // image (bit a of iny, b of inx). Rows iy0 - 1 and iy0 + 2 have a slope
  // only where i - d rounds to exactly -1 or +1 in f32, as it does in the
  // JAX expansion: d an integer, or within half an ulp of one.
  float wy[4], wx[4], sy[4], sx[4];
  unsigned iny = 0, inx = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int iy = iy0 + a - 1, ix = ix0 + a - 1;
    const float ty = __fsub_rn((float)iy, dy), tx = __fsub_rn((float)ix, dx);
    wy[a] = hat_w(ty);
    wx[a] = hat_w(tx);
    sy[a] = (iy >= kh - 1 - R && iy <= kh + R) ? hat_slope(ty) : 0.f;
    sx[a] = (ix >= kw - 1 - R && ix <= kw + R) ? hat_slope(tx) : 0.f;
    iny |= (unsigned)(py + iy >= 0 && py + iy < H) << a;
    inx |= (unsigned)(px + ix >= 0 && px + ix < W) << a;
  }
  // the forward's four corners, their weights rounded to T
  float wr[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wr[a][b] = rnd<T>(__fmul_rn(wy[a + 1], wx[b + 1]));
  // which pixels of the 4 x 4 neighbourhood are read: the corners, rows 0
  // and 3 (columns 1, 2) where their slope is not zero, columns 0 and 3
  // (rows 1, 2) where theirs is not; bit 4 a + b. The same for the warp.
  unsigned need = 0x0660u;
  if (sy[0] != 0.f) need |= 0x0006u;
  if (sy[3] != 0.f) need |= 0x6000u;
  if (sx[0] != 0.f) need |= 0x0110u;
  if (sx[3] != 0.f) need |= 0x0880u;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (!((iny >> a) & (inx >> b) & 1u)) need &= ~(1u << (4 * a + b));
  // element offset of pixel (iy0 - 1, ix0 - 1); read only where in image
  const long long base =
      ((long long)(n * H + py + iy0 - 1) * W + px + ix0 - 1) * Cin;
  const long long rowstep = (long long)W * Cin;
  const float m = to_f(mask[(size_t)gp * KK + k]);
  const size_t row = ((size_t)gp * KK + k) * Cin;
  float sm = 0.f, sdy = 0.f, sdx = 0.f;
  for (int c = lane * V; c < Cin; c += 32 * V) {
    // every load of the pass first, so that they are in flight together
    typename L::raw q[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        q[a][b] = (need >> (4 * a + b)) & 1u
                      ? L::load(x + base + a * rowstep + b * Cin + c)
                      : L::zero();
    const typename L::raw uq = u != nullptr ? L::load(u + row + c)
                                            : L::zero();
    float tv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // the tap value as the forward computes it: the corners in window
      // order, each product and partial sum rounded to T; a corner outside
      // the image adds nothing
      float v = 0.f;
#pragma unroll
      for (int a = 1; a < 3; ++a)
#pragma unroll
        for (int b = 1; b < 3; ++b)
          if ((need >> (4 * a + b)) & 1u)
            v = rnd<T>(__fadd_rn(
                v, rnd<T>(__fmul_rn(L::get(q[a][b], i), wr[a - 1][b - 1]))));
      tv[i] = rnd<T>(__fmul_rn(v, m));
      if (u != nullptr) {
        // the slopes, f32: d/ddy sums sy[a] wx[b] x, d/ddx wy[a] sx[b] x
        float gy = 0.f, gx = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          gy += sy[a] * (wx[1] * L::get(q[a][1], i) +
                         wx[2] * L::get(q[a][2], i));
#pragma unroll
        for (int b = 0; b < 4; ++b)
          gx += sx[b] * (wy[1] * L::get(q[1][b], i) +
                         wy[2] * L::get(q[2][b], i));
        const float uu = L::get(uq, i);
        sm += uu * v;
        sdy += uu * gy;
        sdx += uu * gx;
      }
    }
    if (tile != nullptr) L::store(tile + row + c, tv);
  }
  if (u == nullptr) return;
#pragma unroll
  for (int s = 16; s > 0; s /= 2) {
    sm += __shfl_xor_sync(0xffffffffu, sm, s);
    sdy += __shfl_xor_sync(0xffffffffu, sdy, s);
    sdx += __shfl_xor_sync(0xffffffffu, sdx, s);
  }
  if (lane != 0) return;
  if (dmask != nullptr) dmask[(size_t)gp * KK + k] = from_f<T>(sm);
  if (doffset != nullptr) {
    doffset[(size_t)gp * (2 * KK) + 2 * k] = m * clamp_slope(oy, r) * sdy;
    doffset[(size_t)gp * (2 * KK) + 2 * k + 1] =
        m * clamp_slope(ox, r) * sdx;
  }
}

// One warp an input pixel q. Its candidates are the (tap k, displacement
// (iy, ix) of the tap's window): the output pixel p = q - (iy, ix) read q
// with the weight hat(iy - dy_k(p)) hat(ix - dx_k(p)). The lanes examine the
// candidates side by side, each keeping the weight times m_k(p) and the row
// of U_k(p) of those it finds; then, candidate by candidate in a fixed
// order, the warp adds weight x U_k(p) into q's channels, V a lane. In f32,
// cast once: no atomics, the same order every run.
template <typename T, int V, int R>
__global__ void __launch_bounds__(THREADS)
dcn_shift_bwd_dx_kernel(const float* __restrict__ offset,
                        const T* __restrict__ mask, const T* __restrict__ u,
                        T* __restrict__ dx, int N, int H, int W, int Cin) {
  using L = Lanes<T, V>;
  constexpr int WIN = 2 * R + 2;           // the window's span an axis
  constexpr int CAND = KK * WIN * WIN;     // 144 at R = 1, 324 at R = 2
  constexpr int PER = (CAND + 31) / 32;    // candidates a lane examines
  const int q = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (q >= N * H * W) return;
  const int lane = threadIdx.x % 32;
  const int n = q / (H * W);
  const int rem = q - n * (H * W);
  const int qy = rem / W, qx = rem - qy * W;
  const float r = (float)R;
  float coef[PER];
  unsigned long long urow[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + 32 * i;
    coef[i] = 0.f;
    urow[i] = 0;
    if (j >= CAND) continue;
    const int k = j / (WIN * WIN), d = j - k * (WIN * WIN);
    const int kh = k / 3, kw = k % 3;
    const int iy = kh - 1 - R + d / WIN, ix = kw - 1 - R + d % WIN;
    const int py = qy - iy, px = qx - ix;
    if (py < 0 || py >= H || px < 0 || px >= W) continue;
    const size_t gp = ((size_t)n * H + py) * W + px;
    const float dy = shifted(offset[gp * (2 * KK) + 2 * k], r, kh);
    const float dxx = shifted(offset[gp * (2 * KK) + 2 * k + 1], r, kw);
    const float wy = hat_w(__fsub_rn((float)iy, dy));
    const float wx = hat_w(__fsub_rn((float)ix, dxx));
    coef[i] = __fmul_rn(__fmul_rn(wy, wx), to_f(mask[gp * KK + k]));
    urow[i] = (gp * KK + k) * Cin;
  }
  // every lane takes every pass: the shuffles need the whole warp
  for (int c0 = 0; c0 < Cin; c0 += 32 * V) {
    const int c = c0 + lane * V;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      unsigned live = __ballot_sync(0xffffffffu, coef[i] != 0.f);
      while (live != 0u) {
        const int src = __ffs(live) - 1;
        live &= live - 1u;
        const float cf = __shfl_sync(0xffffffffu, coef[i], src);
        const unsigned long long ur = __shfl_sync(0xffffffffu, urow[i],
                                                  src);
        if (c < Cin) {
          const typename L::raw row = L::load(u + ur + c);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = fmaf(cf, L::get(row, e), acc[e]);
        }
      }
    }
    if (c < Cin) L::store(dx + (size_t)q * Cin + c, acc);
  }
}

// ---- the backward on Hopper: a patch-staged tap kernel ---------------------
//
// The lane tap kernel above reads everything through L2: each input pixel is
// fetched by ~36 warps. At train level 0 (4 x 160 x 336 x 256 bf16, r=1) it
// took 3.37 ms against the 0.64 ms that its compulsory bytes take at 3.35
// TB/s (NVIDIA H100 80GB HBM3, 700 W). The kernel below (bf16, 64 | Cin,
// 16-byte aligned x, U, tile and dx: the train step's calls) stages what a
// block shares in shared memory by TMA, as the forward's wgmma pass does,
// and reads U once: 1.03 ms there. The tiled pass pairs it with the lane dx
// kernel (0.54 ms there).
//
// One block an 8 x 16 patch of one image, 1152 (pixel, tap) pairs.
//   * Once a block, per pair, into shared memory: the forward's 16 bytes
//     (the top-left corner's byte offset in the halo'd patch, the four hat
//     weights rounded to bf16, the mask), which of the 4 x 4 neighbourhood's
//     extra rows and columns the slopes read, and for the derivative the hat
//     weights of the two corner rows and columns (f32) and the eight slopes
//     (JAX's values at the kinks, 0, +-1/2 or +-1: exact in bf16).
//   * Per 64-channel slice, x's halo'd patch arrives by one TMA box, the
//     forward's, into one of two buffers; outside the image it reads zeros.
//     The rows and columns read for a slope lie in the tap's window
//     kh-1-R .. kh+R, inside the halo's -(R+1) .. R+2.
//   * Per slice and patch row, U's 16 pixels x 9 taps x 64 channels (18 KB,
//     one box of a 5-D map over (N, H, W, 9, Cin)) arrive in a ring.
//   * 18 consumer warps, eight threads of 16 bytes a pair, two pairs a
//     thread side by side: the tile from the four corners as the forward
//     builds it (packed bf16, window order, from +0, times the mask),
//     stored as 128-byte rows; the channel sums U.T (dmask) and U.x of every
//     corner or extra pixel read, the latter combined with the hat weights
//     and slopes once a slice (the slope terms); reduced by three shuffles,
//     carried across slices in f32 in shared memory, written by the last
//     slice. (At train level 0, 12 warps of three pairs took 1.136 ms, 18
//     of two 1.034: the kernel waits on its chains of shared loads.)
//   * One producer warp keeps the TMA loads in flight.
// Where the lane kernel skips a corner outside the image, TMA's zero adds
// +0: only the sign of a zero sum can change, and the tile compares equal.
// At train level 3 (36 patches on 132 SMs) it is slower than the lane tap
// kernel (0.077 against 0.054 ms); all levels take it all the same, so that
// every call of a train step runs one pass (PERF.md, section 6).
// A tiled dx kernel (U_k's rows of the patch grown by the window staged by
// TMA, per-(q, tap) bits of the live candidates) was slower than the lane dx
// kernel at every train level (1.06 against 0.54 ms at level 0) and went.

constexpr int TAP_CONSUMERS = 576;               // 18 consumer warps
constexpr int TAP_THREADS = TAP_CONSUMERS + 32;  // and one producer warp
constexpr int ROW_PAIRS = TW * KK;               // (pixel, tap) pairs a row
constexpr int PAIRS = TH * ROW_PAIRS;            // ... a block: 1152
constexpr int U_ROW_BYTES = ROW_PAIRS * TK * 2;  // 18 KB
constexpr int PAIR_TASKS = ROW_PAIRS * 8 / TAP_CONSUMERS;   // 2 a thread

__host__ __device__ constexpr int tap_stages(int r) { return r == 1 ? 4 : 3; }
constexpr int tap_smem_bytes(int r) {
  // 128 to align, two patch slices, the U ring, the metadata (16 + 32 bytes
  // a pair), the f32 sums (3 a pair), the barriers
  return 128 + 2 * patch_bytes(r) + tap_stages(r) * U_ROW_BYTES + PAIRS * 48 +
         PAIRS * 12 + (4 + 2 * tap_stages(r)) * 8;
}

static_assert(PAIR_TASKS * TAP_CONSUMERS == ROW_PAIRS * 8,
              "every (pair, 16 bytes) has one thread");

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// sum_i u_i x_i over the 8 channels of a 16-byte piece of a row, in f32
__device__ __forceinline__ float dot8(const uint4& u, const uint4& x) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) d = fmaf(bf16_lane(u, i), bf16_lane(x, i), d);
  return d;
}

template <int R>
__global__ void __launch_bounds__(TAP_THREADS, 1)
dcn_shift_bwd_tap_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap umap,
                               const float* __restrict__ offset,
                               const __nv_bfloat16* __restrict__ mask,
                               __nv_bfloat16* __restrict__ tile,
                               float* __restrict__ doffset,
                               __nv_bfloat16* __restrict__ dmask, int H,
                               int W, int Cin, int tiles_w, int tiles,
                               int has_u) {
  constexpr int PW = patch_w(R);
  constexpr int PATCH = patch_bytes(R);
  constexpr int STAGES = tap_stages(R);
  constexpr int PIX = TK * 2;                    // a pixel's bytes a slice
  constexpr int ROW = PW * PIX;                  // a patch row's
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint8_t* patches = smem;
  uint8_t* urows = patches + 2 * PATCH;
  uint4* meta = reinterpret_cast<uint4*>(urows + STAGES * U_ROW_BYTES);
  uint4* slopes = meta + PAIRS;                  // two a pair
  float* sums = reinterpret_cast<float*>(slopes + 2 * PAIRS);   // three
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + 3 * PAIRS);
  const uint32_t xfull = smem_u32(bars), xempty = xfull + 2 * 8;
  const uint32_t ufull = xempty + 2 * 8, uempty = ufull + STAGES * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x / tiles, tl = blockIdx.x % tiles;
  const int h0 = (tl / tiles_w) * TH, w0 = (tl % tiles_w) * TW;
  const int nsl = Cin / TK;
  const float r = (float)R;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(xfull + s * 8, 1);
      mbar_init(xempty + s * 8, TAP_CONSUMERS / 32);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ufull + s * 8, 1);
      mbar_init(uempty + s * 8, TAP_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TAP_CONSUMERS / 32) {      // the producer: x's patch a slice,
    if (lane == 0) {                     // then U's rows of that slice
      for (int sl = 0; sl < nsl; ++sl) {
        const int b = sl % 2;
        mbar_wait(xempty + b * 8, ((sl / 2) & 1) ^ 1);
        mbar_expect_tx(xfull + b * 8, PATCH);
        tma_load_4d(smem_u32(patches + b * PATCH), &xmap, xfull + b * 8,
                    sl * TK, w0 - (R + 1), h0 - (R + 1), n);
        if (!has_u) continue;
        for (int row = 0; row < TH; ++row) {
          const int it = sl * TH + row, s = it % STAGES;
          mbar_wait(uempty + s * 8, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(ufull + s * 8, U_ROW_BYTES);
          tma_load_5d(smem_u32(urows + s * U_ROW_BYTES), &umap, ufull + s * 8,
                      sl * TK, 0, w0, h0 + row, n);
        }
      }
    }
    return;
  }

  // per pair e = (pixel, tap): the metadata (see above). A pixel outside
  // the image keeps zero weights and slopes and corners inside the patch.
  for (int e = tid; e < PAIRS; e += TAP_CONSUMERS) {
    const int pix = e / KK, k = e - pix * KK;
    const int ph = pix / TW, pw = pix % TW;
    const int py = h0 + ph, px = w0 + pw;
    const int kh = k / 3, kw = k % 3;
    uint4 md = make_uint4(
        (uint32_t)(((ph + R + 1) * PW + pw + R + 1) * PIX), 0u, 0u, 0u);
    uint4 sw = make_uint4(0u, 0u, 0u, 0u), ss = sw;
    if (py < H && px < W) {
      const size_t gp = ((size_t)n * H + py) * W + px;
      const float oy = offset[gp * (2 * KK) + 2 * k];
      const float ox = offset[gp * (2 * KK) + 2 * k + 1];
      // clamped displacement of the tap from the output pixel, as the
      // forward; rows iy0 - 1 .. iy0 + 2 and columns ix0 - 1 .. ix0 + 2,
      // their weights and slopes as the lane kernel computes them
      const float dy = shifted(oy, r, kh);
      const float dx = shifted(ox, r, kw);
      const int iy0 = (int)floorf(dy), ix0 = (int)floorf(dx);
      float wy[4], wx[4], sy[4], sx[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int iy = iy0 + a - 1, ix = ix0 + a - 1;
        const float ty = __fsub_rn((float)iy, dy);
        const float tx = __fsub_rn((float)ix, dx);
        wy[a] = hat_w(ty);
        wx[a] = hat_w(tx);
        sy[a] = (iy >= kh - 1 - R && iy <= kh + R) ? hat_slope(ty) : 0.f;
        sx[a] = (ix >= kw - 1 - R && ix <= kw + R) ? hat_slope(tx) : 0.f;
      }
      // bit 4 a + b of the 4 x 4 neighbourhood: the corners, and rows 0, 3
      // (columns 1, 2) or columns 0, 3 (rows 1, 2) where their slope is
      // not zero
      uint32_t need = 0x0660u;
      if (sy[0] != 0.f) need |= 0x0006u;
      if (sy[3] != 0.f) need |= 0x6000u;
      if (sx[0] != 0.f) need |= 0x0110u;
      if (sx[3] != 0.f) need |= 0x0880u;
      const uint32_t mk = (uint32_t)__bfloat16_as_ushort(mask[gp * KK + k]);
      md.x = (uint32_t)(((ph + iy0 + R + 1) * PW + pw + ix0 + R + 1) * PIX) |
             need << 16;
      md.y = bf16_bits(__fmul_rn(wy[1], wx[1])) |
             bf16_bits(__fmul_rn(wy[1], wx[2])) << 16;
      md.z = bf16_bits(__fmul_rn(wy[2], wx[1])) |
             bf16_bits(__fmul_rn(wy[2], wx[2])) << 16;
      md.w = mk | mk << 16;
      sw = make_uint4(__float_as_uint(wy[1]), __float_as_uint(wy[2]),
                      __float_as_uint(wx[1]), __float_as_uint(wx[2]));
      ss = make_uint4(bf16_bits(sy[0]) | bf16_bits(sy[1]) << 16,
                      bf16_bits(sy[2]) | bf16_bits(sy[3]) << 16,
                      bf16_bits(sx[0]) | bf16_bits(sx[1]) << 16,
                      bf16_bits(sx[2]) | bf16_bits(sx[3]) << 16);
    }
    meta[e] = md;
    slopes[2 * e] = sw;
    slopes[2 * e + 1] = ss;
  }
  bar_sync(1, TAP_CONSUMERS);

  const int chunk = tid % 8;             // the thread's 16 bytes of a row
  for (int sl = 0; sl < nsl; ++sl) {
    const int b = sl % 2;
    mbar_wait(xfull + b * 8, (sl / 2) & 1);
    const uint8_t* patch = patches + b * PATCH + chunk * 16;
    for (int row = 0; row < TH; ++row) {
      const int it = sl * TH + row, s = it % STAGES;
      if (has_u) mbar_wait(ufull + s * 8, (it / STAGES) & 1);
      const uint8_t* urow = urows + s * U_ROW_BYTES + chunk * 16;
      const int py = h0 + row;
      // the thread's pairs side by side, so that their loads and their
      // shuffles are in flight together
      float sm[PAIR_TASKS], sdy[PAIR_TASKS], sdx[PAIR_TASKS];
#pragma unroll
      for (int j = 0; j < PAIR_TASKS; ++j) {
        const int pk = tid / 8 + (TAP_CONSUMERS / 8) * j;
        const int pw = pk / KK, k = pk - pw * KK;
        const int e = row * ROW_PAIRS + pk;
        const uint4 md = meta[e];
        const uint8_t* c = patch + (md.x & 0xffffu);
        const uint4 q11 = ld16(c), q12 = ld16(c + PIX);
        const uint4 q21 = ld16(c + ROW), q22 = ld16(c + ROW + PIX);
        const __nv_bfloat162 w11 = as_bf162(__byte_perm(md.y, md.y, 0x1010));
        const __nv_bfloat162 w12 = as_bf162(__byte_perm(md.y, md.y, 0x3232));
        const __nv_bfloat162 w21 = as_bf162(__byte_perm(md.z, md.z, 0x1010));
        const __nv_bfloat162 w22 = as_bf162(__byte_perm(md.z, md.z, 0x3232));
        uint4 v;                         // T, before the mask
        v.x = tap_sum2(q11.x, q12.x, q21.x, q22.x, w11, w12, w21, w22);
        v.y = tap_sum2(q11.y, q12.y, q21.y, q22.y, w11, w12, w21, w22);
        v.z = tap_sum2(q11.z, q12.z, q21.z, q22.z, w11, w12, w21, w22);
        v.w = tap_sum2(q11.w, q12.w, q21.w, q22.w, w11, w12, w21, w22);
        const int px = w0 + pw;
        if (tile != nullptr && py < H && px < W) {
          const __nv_bfloat162 mk = as_bf162(md.w);
          const size_t gp = ((size_t)n * H + py) * W + px;
          *reinterpret_cast<uint4*>(tile + (gp * KK + k) * Cin + sl * TK +
                                    chunk * 8) =
              make_uint4(mul2(v.x, mk), mul2(v.y, mk), mul2(v.z, mk),
                         mul2(v.w, mk));
        }
        sm[j] = sdy[j] = sdx[j] = 0.f;
        if (!has_u) continue;
        const uint4 uq = ld16(urow + pk * PIX);
        const float d11 = dot8(uq, q11), d12 = dot8(uq, q12);
        const float d21 = dot8(uq, q21), d22 = dot8(uq, q22);
        const uint32_t need = md.x >> 16;
        float d01 = 0.f, d02 = 0.f, d31 = 0.f, d32 = 0.f;
        float d10 = 0.f, d20 = 0.f, d13 = 0.f, d23 = 0.f;
        if (need & 0x0006u) {
          d01 = dot8(uq, ld16(c - ROW));
          d02 = dot8(uq, ld16(c - ROW + PIX));
        }
        if (need & 0x6000u) {
          d31 = dot8(uq, ld16(c + 2 * ROW));
          d32 = dot8(uq, ld16(c + 2 * ROW + PIX));
        }
        if (need & 0x0110u) {
          d10 = dot8(uq, ld16(c - PIX));
          d20 = dot8(uq, ld16(c + ROW - PIX));
        }
        if (need & 0x0880u) {
          d13 = dot8(uq, ld16(c + 2 * PIX));
          d23 = dot8(uq, ld16(c + ROW + 2 * PIX));
        }
        // the slope terms: d/ddy sums sy[a] wx[b] x, d/ddx wy[a] sx[b] x
        const uint4 sw = slopes[2 * e], ss = slopes[2 * e + 1];
        const float wy1 = __uint_as_float(sw.x), wy2 = __uint_as_float(sw.y);
        const float wx1 = __uint_as_float(sw.z), wx2 = __uint_as_float(sw.w);
        sm[j] = dot8(uq, v);
        sdy[j] = lo_f(ss.x) * (wx1 * d01 + wx2 * d02) +
                 hi_f(ss.x) * (wx1 * d11 + wx2 * d12) +
                 lo_f(ss.y) * (wx1 * d21 + wx2 * d22) +
                 hi_f(ss.y) * (wx1 * d31 + wx2 * d32);
        sdx[j] = lo_f(ss.z) * (wy1 * d10 + wy2 * d20) +
                 hi_f(ss.z) * (wy1 * d11 + wy2 * d21) +
                 lo_f(ss.w) * (wy1 * d12 + wy2 * d22) +
                 hi_f(ss.w) * (wy1 * d13 + wy2 * d23);
      }
      if (has_u) {
        // a pair's eight threads are neighbouring lanes
#pragma unroll
        for (int o = 1; o < 8; o *= 2)
#pragma unroll
          for (int j = 0; j < PAIR_TASKS; ++j) {
            sm[j] += __shfl_xor_sync(0xffffffffu, sm[j], o);
            sdy[j] += __shfl_xor_sync(0xffffffffu, sdy[j], o);
            sdx[j] += __shfl_xor_sync(0xffffffffu, sdx[j], o);
          }
        if (chunk == 0) {
#pragma unroll
          for (int j = 0; j < PAIR_TASKS; ++j) {
            const int pk = tid / 8 + (TAP_CONSUMERS / 8) * j;
            const int pw = pk / KK, k = pk - pw * KK;
            float* acc = sums + 3 * (row * ROW_PAIRS + pk);
            float a0 = sm[j], a1 = sdy[j], a2 = sdx[j];
            if (sl > 0) {
              a0 += acc[0];
              a1 += acc[1];
              a2 += acc[2];
            }
            if (sl + 1 < nsl) {
              acc[0] = a0;
              acc[1] = a1;
              acc[2] = a2;
              continue;
            }
            const int px = w0 + pw;
            if (py >= H || px >= W) continue;
            const size_t gp = ((size_t)n * H + py) * W + px;
            const float m = to_f(mask[gp * KK + k]);
            if (dmask != nullptr) dmask[gp * KK + k] = __float2bfloat16_rn(a0);
            if (doffset != nullptr) {
              doffset[gp * (2 * KK) + 2 * k] =
                  m * clamp_slope(offset[gp * (2 * KK) + 2 * k], r) * a1;
              doffset[gp * (2 * KK) + 2 * k + 1] =
                  m * clamp_slope(offset[gp * (2 * KK) + 2 * k + 1], r) * a2;
            }
          }
        }
      }
      // this warp is done with the U row (and, after the last row, with
      // the patch slice)
      __syncwarp();
      if (has_u && lane == 0) mbar_arrive(uempty + s * 8);
    }
    if (lane == 0) mbar_arrive(xempty + b * 8);
  }
}

template <typename T, int V>
cudaError_t launch_backward_lanes(const void* x, const void* offset,
                                  const void* mask, const void* u,
                                  void* tile, void* doffset, void* dmask,
                                  void* dx, int N, int H, int W, int Cin,
                                  int radius, cudaStream_t s) {
  constexpr int WARPS = THREADS / 32;
  const int P = N * H * W;
  if (tile != nullptr || doffset != nullptr || dmask != nullptr) {
    dcn_shift_bwd_tap_kernel<T, V>
        <<<(P * KK + WARPS - 1) / WARPS, THREADS, 0, s>>>(
            static_cast<const T*>(x), static_cast<const float*>(offset),
            static_cast<const T*>(mask), static_cast<const T*>(u),
            static_cast<T*>(tile), static_cast<float*>(doffset),
            static_cast<T*>(dmask), N, H, W, Cin, radius);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dx != nullptr) {
    const int blocks = (P + WARPS - 1) / WARPS;
    if (radius == 1)
      dcn_shift_bwd_dx_kernel<T, V, 1><<<blocks, THREADS, 0, s>>>(
          static_cast<const float*>(offset), static_cast<const T*>(mask),
          static_cast<const T*>(u), static_cast<T*>(dx), N, H, W, Cin);
    else
      dcn_shift_bwd_dx_kernel<T, V, 2><<<blocks, THREADS, 0, s>>>(
          static_cast<const float*>(offset), static_cast<const T*>(mask),
          static_cast<const T*>(u), static_cast<T*>(dx), N, H, W, Cin);
  }
  return cudaGetLastError();
}

// 16-byte loads where Cin is a multiple of their channels and every tensor
// that is read or written by the channel starts on 16 bytes, else one
// element at a time.
template <typename T>
cudaError_t launch_backward(const void* x, const void* offset,
                            const void* mask, const void* u, void* tile,
                            void* doffset, void* dmask, void* dx, int N,
                            int H, int W, int Cin, int radius,
                            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = Cin % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(u) |
                     reinterpret_cast<uintptr_t>(tile) |
                     reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
  return vec ? launch_backward_lanes<T, V>(x, offset, mask, u, tile, doffset,
                                           dmask, dx, N, H, W, Cin, radius, s)
             : launch_backward_lanes<T, 1>(x, offset, mask, u, tile, doffset,
                                           dmask, dx, N, H, W, Cin, radius, s);
}

// The wgmma pass takes bf16 with Cin and Cout multiples of 64 and 16-byte
// aligned bases of x and the weight (what TMA's maps need).
bool takes_wgmma(int Cin, int Cout, int is_bf16, int aligned) {
  return is_bf16 && aligned && Cin > 0 && Cin % TK == 0 && Cout % 64 == 0;
}

// Output channels per block: 256, or 128 for a layer of at most 128
// channels or where blocks of 256 would leave more than half of the 132 SMs
// idle. Both halves of a split build the same tap tiles, so it pays only
// there: on an NVIDIA H100 80GB HBM3 at 700 W, B=4 and 256 channels, 128
// against 256 took 0.042 against 0.051 ms at 20x36 (36 patches) but 0.082
// against 0.051 ms at 40x72 (100 patches) and 0.93 against 0.57 at 160x288.
int block_n(int patches, int Cout) {
  return Cout <= 128 || patches <= 66 ? 128 : 256;
}

// The 4-D map over x (N, H, W, Cin) whose box is one 64-channel slice of a
// halo'd patch, read pixel by pixel, 128 bytes at a time: no swizzle.
bool x_patch_map(CUtensorMap* map, const void* x, int N, int H, int W,
                 int Cin, int R) {
  const cuuint64_t d[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                           (cuuint64_t)N};
  const cuuint64_t st[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                            (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {TK, (cuuint32_t)patch_w(R),
                             (cuuint32_t)patch_h(R), 1};
  return bf16_map(map, x, 4, d, st, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The 5-D map over U viewed as (N, H, W, 9, Cin) whose box is 64 channels
// x 9 taps x one patch row of 16 pixels, no swizzle.
bool u_row_map(CUtensorMap* map, const void* u, int N, int H, int W,
               int Cin) {
  const cuuint64_t d[5] = {(cuuint64_t)Cin, KK, (cuuint64_t)W, (cuuint64_t)H,
                           (cuuint64_t)N};
  const cuuint64_t st[4] = {(cuuint64_t)Cin * 2, (cuuint64_t)KK * Cin * 2,
                            (cuuint64_t)W * KK * Cin * 2,
                            (cuuint64_t)H * W * KK * Cin * 2};
  const cuuint32_t box[5] = {TK, KK, TW, 1, 1};
  return bf16_map(map, u, 5, d, st, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int R, int BN>
cudaError_t launch_wgmma(const void* x, const void* offset, const void* mask,
                         const void* weight, const void* bias, void* out,
                         int N, int H, int W, int Cin, int Cout,
                         cudaStream_t s) {
  CUtensorMap xmap, wmap;
  const cuuint64_t wd[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, KK};
  const cuuint64_t wst[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t wb[3] = {64, TK, 1};
  // the weight tile is wgmma's B operand: the 128-byte swizzle
  if (!x_patch_map(&xmap, x, N, H, W, Cin, R) ||
      !bf16_map(&wmap, weight, 3, wd, wst, wb, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem_bytes(R, BN);
  // above 48 KB a kernel has to be allowed its shared memory; the
  // attribute belongs to the current device, so it is set at every launch
  const cudaError_t allowed = cudaFuncSetAttribute(
      dcn_shift_wgmma_kernel<R, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return allowed;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid((unsigned)(N * tiles_w * tiles_h),
                  (unsigned)((Cout + BN - 1) / BN));
  dcn_shift_wgmma_kernel<R, BN><<<grid, WG_THREADS, smem, s>>>(
      xmap, wmap, static_cast<const float*>(offset),
      static_cast<const __nv_bfloat16*>(mask),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, tiles_w,
      tiles_w * tiles_h);
  return cudaGetLastError();
}

// The tiled backward takes bf16 with Cin a multiple of 64 and x, U, the tile
// and dx on 16-byte boundaries (TMA's maps, 16-byte rows).
bool takes_tiled_backward(int Cin, int is_bf16, int aligned) {
  return is_bf16 && aligned && Cin > 0 && Cin % TK == 0;
}

template <int R>
cudaError_t launch_tap_tiled(const void* x, const void* offset,
                             const void* mask, const void* u, void* tile,
                             void* doffset, void* dmask, int N, int H, int W,
                             int Cin, cudaStream_t s) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  CUtensorMap xmap, umap = {};
  if (!x_patch_map(&xmap, x, N, H, W, Cin, R) ||
      (u != nullptr && !u_row_map(&umap, u, N, H, W, Cin)))
    return cudaErrorInvalidValue;
  constexpr int smem = tap_smem_bytes(R);
  const cudaError_t allowed = cudaFuncSetAttribute(
      dcn_shift_bwd_tap_tiled_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return allowed;
  dcn_shift_bwd_tap_tiled_kernel<R>
      <<<(unsigned)(N * tiles_w * tiles_h), TAP_THREADS, smem, s>>>(
          xmap, umap, static_cast<const float*>(offset),
          static_cast<const __nv_bfloat16*>(mask),
          static_cast<__nv_bfloat16*>(tile), static_cast<float*>(doffset),
          static_cast<__nv_bfloat16*>(dmask), H, W, Cin, tiles_w,
          tiles_w * tiles_h, u != nullptr);
  return cudaGetLastError();
}

}  // namespace

// 1 if a call with these channels, type and alignment (x's and the weight's
// base addresses multiples of 16) takes the wgmma pass, else 0.
extern "C" int dcn_shift_takes_wgmma(int Cin, int Cout, int is_bf16,
                                     int aligned) {
  return takes_wgmma(Cin, Cout, is_bf16, aligned);
}

// x (N,H,W,Cin), offset (N,H,W,18) f32, mask (N,H,W,9), weight (9,Cin,Cout),
// bias (Cout,) or null, out (N,H,W,Cout); x, mask, weight, bias and out share
// one type: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). All contiguous; radius
// 1 or 2. wmma != 0 keeps a bf16 call off the wgmma pass, on the WMMA pass
// that every bf16 shape took before (for timing the two side by side).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue if a
// tensor map could not be encoded.
extern "C" int dcn_shift_forward_pass(const void* x, const void* offset,
                                      const void* mask, const void* weight,
                                      const void* bias, void* out, int N,
                                      int H, int W, int Cin, int Cout,
                                      int radius, int is_bf16, int wmma,
                                      void* stream) {
  const long long P = (long long)N * H * W;
  if (P == 0 || Cout == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float r = (float)radius;
  const unsigned gm = (unsigned)((P + BM - 1) / BM);
  const int aligned = ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(weight)) % 16) == 0;
  if (!wmma && takes_wgmma(Cin, Cout, is_bf16, aligned)) {
    const int patches = N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
    const bool wide = block_n(patches, Cout) == 256;
    if (radius == 1)
      return (int)(wide ? launch_wgmma<1, 256>(x, offset, mask, weight, bias,
                                               out, N, H, W, Cin, Cout, s)
                        : launch_wgmma<1, 128>(x, offset, mask, weight, bias,
                                               out, N, H, W, Cin, Cout, s));
    if (radius == 2)
      return (int)(wide ? launch_wgmma<2, 256>(x, offset, mask, weight, bias,
                                               out, N, H, W, Cin, Cout, s)
                        : launch_wgmma<2, 128>(x, offset, mask, weight, bias,
                                               out, N, H, W, Cin, Cout, s));
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    // 16-byte loads of 8 channels need 8 | Cin, 8 | Cout and aligned bases
    const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && aligned;
    const dim3 grid(gm, (unsigned)((Cout + BN_BF16 - 1) / BN_BF16));
    dcn_shift_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(offset),
        static_cast<const __nv_bfloat16*>(mask),
        static_cast<const __nv_bfloat16*>(weight),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), N, H, W, Cin, Cout, r, vec);
  } else {
    const dim3 grid(gm, (unsigned)((Cout + BN_F32 - 1) / BN_F32));
    dcn_shift_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(offset),
        static_cast<const float*>(mask), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(out), N, H, W,
        Cin, Cout, r);
  }
  return (int)cudaGetLastError();
}

// The same, each call on the pass its shapes name.
extern "C" int dcn_shift_forward(const void* x, const void* offset,
                                 const void* mask, const void* weight,
                                 const void* bias, void* out, int N, int H,
                                 int W, int Cin, int Cout, int radius,
                                 int is_bf16, void* stream) {
  return dcn_shift_forward_pass(x, offset, mask, weight, bias, out, N, H, W,
                                Cin, Cout, radius, is_bf16, 0, stream);
}

// The backward, on the tensors the forward was given (x, offset f32, mask),
// with u = G W^T (P x 9 x Cin, x's type) where doffset, dmask or dx is asked
// for. Each of tile (P x 9 x Cin), doffset (P x 18, f32), dmask (P x 9) and
// dx (P x Cin) is written unless it is null; tile, dmask and dx in x's type
// (f32: is_bf16 = 0, bf16: 1). Launches a tap kernel where tile, doffset or
// dmask is asked for and the dx kernel where dx is. The tap kernel is the
// tiled one where the shapes take the tiled pass, else the lane one. lanes
// != 0 keeps a call on the lane pass (for timing the two side by side).
// *tiled, unless tiled is null, is set to 1 if the tiled tap kernel was
// launched, else 0. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue if a tensor map could not be encoded.
extern "C" int dcn_shift_backward_pass(const void* x, const void* offset,
                                       const void* mask, const void* u,
                                       void* tile, void* doffset,
                                       void* dmask, void* dx, int N, int H,
                                       int W, int Cin, int radius,
                                       int is_bf16, int lanes, int* tiled,
                                       void* stream) {
  if (tiled != nullptr) *tiled = 0;
  if ((long long)N * H * W == 0 || Cin == 0) return 0;
  // the kernels index pixels and (pixel, tap) pairs with 32-bit ints
  if ((long long)N * H * W * KK >= (1LL << 31) ||
      (radius != 1 && radius != 2) ||
      (u == nullptr && (doffset != nullptr || dmask != nullptr ||
                        dx != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int aligned = ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(u) |
                        reinterpret_cast<uintptr_t>(tile) |
                        reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
  if (!lanes && takes_tiled_backward(Cin, is_bf16, aligned) &&
      (tile != nullptr || doffset != nullptr || dmask != nullptr)) {
    const cudaError_t err =
        radius == 1 ? launch_tap_tiled<1>(x, offset, mask, u, tile, doffset,
                                          dmask, N, H, W, Cin, s)
                    : launch_tap_tiled<2>(x, offset, mask, u, tile, doffset,
                                          dmask, N, H, W, Cin, s);
    if (err != cudaSuccess) return (int)err;
    if (tiled != nullptr) *tiled = 1;
    // the lane dx kernel, 16-byte loads (8 | Cin, aligned bases)
    return (int)launch_backward_lanes<__nv_bfloat16, 8>(
        x, offset, mask, u, nullptr, nullptr, nullptr, dx, N, H, W, Cin,
        radius, s);
  }
  return (int)(is_bf16
                   ? launch_backward<__nv_bfloat16>(x, offset, mask, u, tile,
                                                    doffset, dmask, dx, N, H,
                                                    W, Cin, radius, s)
                   : launch_backward<float>(x, offset, mask, u, tile, doffset,
                                            dmask, dx, N, H, W, Cin, radius,
                                            s));
}

// The same, each call on the pass its shapes name.
extern "C" int dcn_shift_backward(const void* x, const void* offset,
                                  const void* mask, const void* u,
                                  void* tile, void* doffset, void* dmask,
                                  void* dx, int N, int H, int W, int Cin,
                                  int radius, int is_bf16, int* tiled,
                                  void* stream) {
  return dcn_shift_backward_pass(x, offset, mask, u, tile, doffset, dmask, dx,
                                 N, H, W, Cin, radius, is_bf16, 0, tiled,
                                 stream);
}
