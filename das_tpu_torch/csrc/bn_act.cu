// Eval BatchNorm, with the residual add and the ReLU that follow it, in one
// pass over a channels-last bf16 tensor, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the backbones' eval
// BatchNorm to XLA, which fuses it into the convolution's epilogue. In the
// port the backbones' BatchNorms (MSPN2's and HRNet's, 128 to 305 a served
// request) ran as PyTorch's chain: a cast of the bf16 input to f32,
// cuDNN's f32 eval BN, a cast back, and at the call site the residual add
// and the ReLU, 3 to 5 launches that move 24 to 30 bytes an element.
//
//   out[r, c] = act(bf16(x[r, c] * scale[c] + shift[c]) [+ residual[r, c]])
//   scale[c]  = weight[c] * (1 / sqrt(var[c] + eps)),
//   shift[c]  = bias[c] - mean[c] * scale[c]
//
// with r a pixel (N*H*W rows) and c a channel. Every operation is f32 and
// rounded as the plain version (ops/bn_act.py::bn_act_plain), a chain of
// PyTorch calls, rounds it: IEEE square root and division, then products
// and sums by the _rn intrinsics, so that nothing contracts into a fused
// multiply-add; the affine's result rounded to bf16 once, and with a
// residual the sum of that and the residual in f32, rounded once more, as
// PyTorch's bf16 add rounds it; then the ReLU. It equals the plain version
// bit for bit.
//
// Bound: bytes. An element is read once (2 bytes) and written once (2),
// plus 2 for the residual: 0.085 ms for exp_panoptic's largest BN (B=4,
// 256 channels at 160x288, with a residual) at an H100's 3.35 TB/s. The
// design is about reaching that:
//
// * A thread owns a fixed slice of 8 channels (16 bytes), so it computes
//   the slice's scale and shift once, in registers, from the module's f32
//   buffers: no launch and no buffer for them. The threads of a row take
//   neighbouring slices, so a warp's loads and stores are whole 16-byte
//   vectors on neighbouring addresses.
// * It walks the rows with a grid stride that is a whole number of rows,
//   four rows an iteration, their loads issued before any arithmetic so
//   that enough bytes are in flight to cover the memory's latency.
// * A C that is not a multiple of 8, or a base address that is not on 16
//   bytes, takes the same kernel with slices of one channel (2-byte loads).
//
// Every function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// blocks that fill the 132 SMs of an H100 with 2048 threads each
constexpr long long kMaxBlocks = 132LL * 8;

typedef __nv_bfloat16 bf16;

template <int V>
__device__ __forceinline__ void load(const bf16* p, bf16 (&a)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(a) = __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const bf16 (&a)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(a);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = a[k];
  }
}

// One thread owns channels [s*V, s*V + V) of rows r0, r0 + P, r0 + 2P, ...
// where S = C / V slices make a row and P = (threads in the grid) / S.
template <int V, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
              bf16* __restrict__ out, const float* __restrict__ weight,
              const float* __restrict__ bias, const float* __restrict__ mean,
              const float* __restrict__ var, long long rows, int C,
              float eps) {
  const int S = C / V;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
      + threadIdx.x;
  const long long P = static_cast<long long>(gridDim.x) * kThreads / S;
  if (g >= P * S) return;
  const int s = static_cast<int>(g % S);
  const int c0 = s * V;
  float scale[V], shift[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c0 + k], eps)));
    scale[k] = __fmul_rn(inv, weight[c0 + k]);
    shift[k] = __fsub_rn(bias[c0 + k], __fmul_rn(mean[c0 + k], scale[k]));
  }
  for (long long r = g / S; r < rows; r += P * kUnroll) {
    alignas(16) bf16 a[kUnroll][V];
    alignas(16) bf16 b[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * P;
      if (ru < rows) {
        load<V>(x + ru * C + c0, a[u]);
        if constexpr (RES) load<V>(res + ru * C + c0, b[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * P;
      if (ru >= rows) break;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float y = __fadd_rn(__fmul_rn(__bfloat162float(a[u][k]), scale[k]),
                            shift[k]);
        if constexpr (RES)
          y = __fadd_rn(__bfloat162float(__float2bfloat16_rn(y)),
                        __bfloat162float(b[u][k]));
        bf16 o = __float2bfloat16_rn(y);
        if constexpr (RELU)
          if (__bfloat162float(o) <= 0.0f) o = __float2bfloat16_rn(0.0f);
        a[u][k] = o;
      }
      store<V>(out + ru * C + c0, a[u]);
    }
  }
}

template <int V>
int launch(const bf16* x, const bf16* res, bf16* out, const float* w,
           const float* b, const float* m, const float* v, long long rows,
           int C, float eps, int relu, cudaStream_t st) {
  const long long S = C / V;
  long long blocks = (rows * S + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // every slice of a row needs a thread
  const long long least = (S + kThreads - 1) / kThreads;
  if (blocks < least) blocks = least;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (res && relu)
    bn_act_kernel<V, true, true><<<grid, kThreads, 0, st>>>(
        x, res, out, w, b, m, v, rows, C, eps);
  else if (res)
    bn_act_kernel<V, true, false><<<grid, kThreads, 0, st>>>(
        x, res, out, w, b, m, v, rows, C, eps);
  else if (relu)
    bn_act_kernel<V, false, true><<<grid, kThreads, 0, st>>>(
        x, res, out, w, b, m, v, rows, C, eps);
  else
    bn_act_kernel<V, false, false><<<grid, kThreads, 0, st>>>(
        x, res, out, w, b, m, v, rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, residual (or null) and out: (rows, C) bf16, rows = N*H*W of a
// channels-last tensor; weight, bias, mean, var: (C,) f32; all contiguous,
// on the device. relu != 0 applies the ReLU. Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for C < 1.
extern "C" int bn_act_forward(const void* x, const void* residual, void* out,
                              const void* weight, const void* bias,
                              const void* mean, const void* var,
                              long long rows, int C, float eps, int relu,
                              void* stream) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* rp = static_cast<const bf16*>(residual);
  bf16* op = static_cast<bf16*>(out);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  const bool vec = C % 8 == 0 && aligned16(x) && aligned16(out)
      && (residual == nullptr || aligned16(residual));
  return vec ? launch<8>(xp, rp, op, w, b, m, v, rows, C, eps, relu, st)
             : launch<1>(xp, rp, op, w, b, m, v, rows, C, eps, relu, st);
}
