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
//   1. conv: one block owns 64 output pixels of ONE image (tiles never
//      straddle two images) x all output channels of its column block, and
//      loops over the 9 taps and 32-channel slices of Cin, as the DCN kernel
//      (dcn_shift.cu) does without the offsets. bf16 runs WMMA (mma.sync, f32
//      accumulate) with 16-byte loads when Cin and Cout are multiples of 8,
//      the next slice's loads in flight during the current product; f32 runs
//      true FMAs. The epilogue writes y (f32) to a workspace and the block's
//      per-(image, group) partial sums of y and y^2 to its own slot of a
//      partials buffer: no atomics, so runs repeat bit for bit.
//   2. stats: one block per (image, group) sums the slots in a fixed tree
//      order and writes mean and rstd.
//   3. apply: elementwise relu(y * a + b), rounded to x's type.
// Recomputing the conv instead of the workspace round trip, a cluster/DSMEM
// reduction, wgmma and TMA are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
// miss the block's channels get 0. One slot per block.
__device__ __forceinline__ void write_group_partials(
    const float* t1, const float* t2, float2* part, size_t slot, int n0,
    int bn, int Cout, int G) {
  const int cg = Cout / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
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

// bf16 conv pass: 64 pixels x BN output channels per block, WM x WN warps.
template <int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
conv_gn_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ weight,
                    float* __restrict__ ws, float2* __restrict__ part,
                    int H, int W, int Cin, int Cout, int G, int tiles,
                    bool vec) {
  static_assert(WM * WN == THREADS / 32, "eight warps");
  constexpr int FM = BM / 16 / WM;        // 16-row fragments per warp
  constexpr int FN = BN / 16 / WN;        // 16-column fragments per warp
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int BV = BK * BN / 8 / THREADS;   // 16-byte W loads per thread
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
  if (vec) {
    // thread -> (pixel, 8 channels) of the x tile; BV 8-channel runs of W_k
    const int pa = tid / (BK / 8), ca = (tid % (BK / 8)) * 8;
    uint4 qa, qb[BV];
    auto fetch = [&](int it) {
      const int k = it / nsl, c0 = (it % nsl) * BK;
      const int idx = rows[k][pa];
      const int ci = c0 + ca;
      qa = (idx >= 0 && ci < Cin)
               ? __ldg(reinterpret_cast<const uint4*>(
                     x + (size_t)idx * Cin + ci))
               : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int t = 0; t < BV; ++t) {
        const int e = tid + t * THREADS;
        const int kr = e / (BN / 8), o = (e % (BN / 8)) * 8;
        const int cw = c0 + kr, co = n0 + o;
        qb[t] = (cw < Cin && co < Cout)
                    ? __ldg(reinterpret_cast<const uint4*>(
                          weight + ((size_t)k * Cin + cw) * Cout + co))
                    : make_uint4(0, 0, 0, 0);
      }
    };
    fetch(0);
    for (int it = 0; it < iters; ++it) {
      *reinterpret_cast<uint4*>(&As[pa * LDA + ca]) = qa;
#pragma unroll
      for (int t = 0; t < BV; ++t) {
        const int e = tid + t * THREADS;
        *reinterpret_cast<uint4*>(
            &Bs[(e / (BN / 8)) * LDB + (e % (BN / 8)) * 8]) = qb[t];
      }
      __syncthreads();
      if (it + 1 < iters) fetch(it + 1);   // in flight during the product
      mma_slice<FM, FN, LDA, LDB>(acc, As, Bs, wm * FM * 16, wn * FN * 16);
      __syncthreads();
    }
  } else {
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
                       n0, BN, Cout, G);
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
                       n0, BN, Cout, G);
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

}  // namespace

// Slots of the partials buffer per image: (pixel tiles) x (column blocks).
// The caller allocates N * slots * G float2 for it.
extern "C" int conv_gn_relu_slots(int H, int W, int Cout, int is_bf16) {
  const int bn = block_n(Cout, is_bf16);
  return ((H * W + BM - 1) / BM) * ((Cout + bn - 1) / bn);
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
  const int tiles = (int)((HW + BM - 1) / BM);
  const int bn = block_n(Cout, is_bf16);
  const int nb = (Cout + bn - 1) / bn;
  const dim3 grid((unsigned)(N * tiles), (unsigned)nb);
  float* wsf = static_cast<float*>(ws);
  float2* pt = static_cast<float2*>(part);
  if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(weight);
    // 16-byte loads of 8 channels need 8 | Cin, 8 | Cout and aligned bases
    const bool vec = Cin % 8 == 0 && Cout % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(weight)) % 16) == 0;
    if (bn == 64)
      conv_gn_bf16_kernel<64, 4, 2><<<grid, THREADS, 0, s>>>(
          xb, wb, wsf, pt, H, W, Cin, Cout, G, tiles, vec);
    else
      conv_gn_bf16_kernel<256, 2, 4><<<grid, THREADS, 0, s>>>(
          xb, wb, wsf, pt, H, W, Cin, Cout, G, tiles, vec);
  } else {
    conv_gn_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(weight), wsf,
        pt, H, W, Cin, Cout, G, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const double cnt = (double)HW * (Cout / G);
  float2* st = static_cast<float2*>(stats);
  gn_stats_kernel<<<(unsigned)(N * G), THREADS, 0, s>>>(
      pt, st, G, tiles * nb, (float)(1.0 / cnt), eps);
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
