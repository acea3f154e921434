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
// Only the 2x2 corners around the clamped point have a nonzero hat weight,
// so the kernel reads those four. It rounds as the plain version does
// (each hat weight, product and partial sum to x's type, in window order,
// with no fused multiply-add), so the tap tile it feeds the product is the
// plain version's bit for bit; only the order of the f32 sums differs.
//
// What bounds it on an H100: the contraction. At the serving shapes
// (Cin = Cout = 256) it is 2*9*256*256 = 1.18 MFLOP per output pixel against
// about 1.1 KB of compulsory traffic (x, offsets, mask, output), some 1000
// operations per byte, far above the card's ~295 bf16 tensor-core operations
// per byte. So the kernel is bound by operations, and the tensor cores must
// do the product.
//
// Design: the TPU kernel kept a 4-row band of full width with all channels
// in VMEM; that does not fit in 227 KB of shared memory. Here one block owns
// a tile of 64 output pixels (flattened over N*H*W, so a ragged edge is one
// bound) x all output channels of its column block, and loops over the 9
// taps and over 32-channel slices of Cin:
//   * per tap, 64 threads compute each pixel's four corner indices and hat
//     weights (zero outside the image) and its mask into shared memory;
//   * per slice, the block builds the 64 x 32 modulated tap tile in shared
//     memory from global x and loads the matching 32-row slice of W_k. When
//     Cin and Cout are multiples of 8 (the model's layers), each thread
//     moves 8 channels with 16-byte loads, so a slice costs one round trip
//     to memory; otherwise one element per load;
//   * bf16: 8 warps multiply the tiles with WMMA (mma.sync, bf16 in, f32
//     accumulate in registers), 64 x 256 output channels per block, so the
//     tap tile is built once for every output channel of a 256-channel
//     layer; f32: every thread does a 4 x 8 register tile of FMAs over
//     64 x 128 outputs, so fp32 inputs keep full fp32 products.
// The epilogue casts the f32 sum to x's type, then adds the bias in that
// type, as the TPU kernel does. TMA, wgmma and a software pipeline are left
// for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
  const float dy = __fadd_rn(fminf(fmaxf(oy, -r), r), (float)(kh - 1));
  const float dx = __fadd_rn(fminf(fmaxf(ox, -r), r), (float)(kw - 1));
  const float fy = floorf(dy), fx = floorf(dx);
  // hat weights as the plain version writes them: max(0, 1 - |i - d|)
  float wy[2], wx[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    wy[a] = fmaxf(0.f, 1.f - fabsf(__fsub_rn(fy + (float)a, dy)));
    wx[a] = fmaxf(0.f, 1.f - fabsf(__fsub_rn(fx + (float)a, dx)));
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

}  // namespace

// x (N,H,W,Cin), offset (N,H,W,18) f32, mask (N,H,W,9), weight (9,Cin,Cout),
// bias (Cout,) or null, out (N,H,W,Cout); x, mask, weight, bias and out share
// one type: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). All contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int dcn_shift_forward(const void* x, const void* offset,
                                 const void* mask, const void* weight,
                                 const void* bias, void* out, int N, int H,
                                 int W, int Cin, int Cout, int radius,
                                 int is_bf16, void* stream) {
  const long long P = (long long)N * H * W;
  if (P == 0 || Cout == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float r = (float)radius;
  const unsigned gm = (unsigned)((P + BM - 1) / BM);
  if (is_bf16) {
    // 16-byte loads of 8 channels need 8 | Cin, 8 | Cout and aligned bases
    const bool vec = Cin % 8 == 0 && Cout % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(weight)) % 16) == 0;
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
