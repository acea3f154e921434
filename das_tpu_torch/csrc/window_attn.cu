// Shifted-window multi-head self-attention of a Swin block (Liu et al.,
// arXiv:2103.14030; mmdet's WindowMSA inside ShiftWindowMSA) in one pass
// over the windows of a layer, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Swin. In the port the
// attention of a window ran as PyTorch's chain (ops/window_attn.py::
// window_attention_plain): a permute of the qkv projection, q * scale,
// q @ k^T, the relative-position bias gathered from its table and added,
// the shift mask added, softmax, @ v and a permute back, which writes and
// reads the 144 x 144 logits of every (window, head) pair about six times.
//
// For a (window, head) pair with tokens i, j < 144 (12 x 12, row-major):
//
//   s[i, j] = (q[i] . k[j]) * scale + table[idx(i, j), head] + m[i, j]
//   o[i]    = sum_j softmax_j(s[i, :]) v[j]
//   idx(i, j) = (yi - yj + 11) * 23 + (xi - xj + 11)
//
// with (y, x) a token's place in its window: mmdet's relative_position_index
// (double_step_seq, flipped), computed here from the place. m is 0 without
// the shift; with it, -100 where the two tokens' regions of the padded,
// rolled map differ (mmdet's img_mask: rows [0, Hp - 12), [Hp - 12, Hp - 6),
// [Hp - 6, Hp) and the same for columns, nine regions), from the window's
// place in the image. The products are bf16 on the tensor cores with f32
// sums; the logits, softmax and its sum stay f32 in registers; the softmax's
// numerators are rounded to bf16 for the product with v, and the output is
// rounded to bf16 once, after the division by the sum.
//
// Layout: qkv is the qkv projection of the windows' tokens, (B_, 144, 3, H,
// 32) bf16 (B_ = images x windows, the windows of an image row-major), read
// in place; out is (B_, 144, H * 32) bf16, the projection's input; table is
// the layer's (23 * 23, H) f32 bias table.
//
// Bound: bytes. A pair reads q, k and v (3 x 144 x 32 bf16) and writes o:
// 36.9 KB against 2.65 MFLOP, 72 FLOP a byte, far under the H100's 295.
// The design keeps everything else out of device memory:
//
// * One block a pair, 9 warps; warp w owns query rows [16w, 16w + 16). K and
//   V^T are staged in shared memory (rows padded so that the fragment loads
//   of a warp fall in 32 distinct banks); each warp's q rows go straight to
//   registers as mma.sync A fragments. The head's 529 bias values go to
//   shared memory once; the bias and the mask are made in registers from
//   the tokens' places, so no (144, 144) tensor is read.
// * A warp's 16 x 144 logits live in registers (18 m16n8 tiles of f32); the
//   row max and sum reduce over the four lanes that share a row; the
//   exponentials (exp2 of logits prescaled by log2 e) become the A fragments
//   of the product with V in place, as FlashAttention-2 keeps them.
// * Consecutive blocks are the heads of one window, so their q, k and v
//   slices share the rows' cache lines.
//
// Every function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWin = 12;                     // window side
constexpr int kN = kWin * kWin;              // tokens a window
constexpr int kD = 32;                       // head dimension
constexpr int kWarps = kN / 16;              // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = kN / 8;               // m16n8 tiles of a row block
constexpr int kSide = 2 * kWin - 1;
constexpr int kTable = kSide * kSide;        // 529 bias entries a head
constexpr int kKStride = kD + 8;             // K row stride in shared memory
constexpr int kVStride = kN + 8;             // V^T row stride
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -100.0f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The region (0, 1, 2) of padded coordinate t on a side of length L.
__device__ __forceinline__ int region(int t, int L, int shift) {
  return t < L - kWin ? 0 : (t < L - shift ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads, 2)
window_attn_kernel(const bf16* __restrict__ qkv,
                   const float* __restrict__ table, bf16* __restrict__ out,
                   int heads, int nwh, int nww, int shift, float scale) {
  __shared__ __align__(16) bf16 ks[kN * kKStride];
  __shared__ __align__(16) bf16 vt[kD * kVStride];
  __shared__ float tb[kTable];

  const int tid = threadIdx.x;
  const int h = blockIdx.x % heads;
  const long long win = blockIdx.x / heads;
  const int C = heads * kD;
  const long long row = 3LL * C;               // elements between tokens
  const bf16* base = qkv + win * kN * row + h * kD;

  // K rows and V^T columns: thread t takes token t % 144 and 8 of the 32
  // dimensions, so a warp's shared-memory stores fall in distinct banks.
  for (int i = tid; i < kN * (kD / 8); i += kThreads) {
    const int n = i % kN, c = (i / kN) * 8;
    const bf16* src = base + n * row + c;
    const uint4 kv = *reinterpret_cast<const uint4*>(src + C);
    const uint4 vv = *reinterpret_cast<const uint4*>(src + 2 * C);
    *reinterpret_cast<uint4*>(ks + n * kKStride + c) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(c + e) * kVStride + n] = ve[e];
  }
  for (int i = tid; i < kTable; i += kThreads)
    tb[i] = table[i * heads + h] * kLog2e;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;   // this thread's two rows

  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const bf16* q0 = base + r0 * row + kk * 16 + t4 * 2;
    const bf16* q1 = base + r1 * row + kk * 16 + t4 * 2;
    qa[kk][0] = ld32(q0);
    qa[kk][1] = ld32(q1);
    qa[kk][2] = ld32(q0 + 8);
    qa[kk][3] = ld32(q1 + 8);
  }

  // the rows' places in the window and, with the shift, their regions
  const int y0 = r0 / kWin, x0 = r0 % kWin, y1 = r1 / kWin, x1 = r1 % kWin;
  const int w = static_cast<int>(win % (static_cast<long long>(nwh) * nww));
  const int wy = (w / nww) * kWin, wx = (w % nww) * kWin;
  const int hp = nwh * kWin, wp = nww * kWin;
  int lab0 = 0, lab1 = 0;
  if (shift) {
    lab0 = region(wy + y0, hp, shift) * 3 + region(wx + x0, wp, shift);
    lab1 = region(wy + y1, hp, shift) * 3 + region(wx + x1, wp, shift);
  }
  __syncthreads();

  // s = q k^T, 18 tiles of 16 x 8
  float s[kTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const bf16* kr = ks + (nt * 8 + g) * kKStride + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma_bf16(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
  }

  // logits in log2 units: scale, bias and mask; the rows' maxima
  const float sl = scale * kLog2e;
  const float ml = kMask * kLog2e;
  float m0 = -1e30f, m1 = -1e30f;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + t4 * 2 + e;
      const int yj = j / kWin, xj = j % kWin;
      float a = s[nt][e] * sl
          + tb[(y0 - yj + kWin - 1) * kSide + (x0 - xj + kWin - 1)];
      float b = s[nt][e + 2] * sl
          + tb[(y1 - yj + kWin - 1) * kSide + (x1 - xj + kWin - 1)];
      if (shift) {
        const int lab = region(wy + yj, hp, shift) * 3
            + region(wx + xj, wp, shift);
        if (lab != lab0) a += ml;
        if (lab != lab1) b += ml;
      }
      s[nt][e] = a;
      s[nt][e + 2] = b;
      m0 = fmaxf(m0, a);
      m1 = fmaxf(m1, b);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    s[nt][0] = exp2f(s[nt][0] - m0);
    s[nt][1] = exp2f(s[nt][1] - m0);
    s[nt][2] = exp2f(s[nt][2] - m1);
    s[nt][3] = exp2f(s[nt][3] - m1);
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // o = p v: the exponentials of tiles 2kk and 2kk + 1 are the A fragment
  // of the kk-th 16 keys
  float acc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      const bf16* vr = vt + (nd * 8 + g) * kVStride + kk * 16 + t4 * 2;
      mma_bf16(acc[nd], pa, ld32(vr), ld32(vr + 8));
    }
  }

  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
  bf16* o0 = out + (win * kN + r0) * C + h * kD + t4 * 2;
  bf16* o1 = out + (win * kN + r1) * C + h * kD + t4 * 2;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    *reinterpret_cast<uint32_t*>(o0 + nd * 8) =
        pack_bf16(acc[nd][0] * i0, acc[nd][1] * i0);
    *reinterpret_cast<uint32_t*>(o1 + nd * 8) =
        pack_bf16(acc[nd][2] * i1, acc[nd][3] * i1);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// qkv: (windows, 144, 3, heads, 32) bf16, contiguous, 16-byte aligned; table:
// (529, heads) f32 contiguous; out: (windows, 144, heads * 32) bf16
// contiguous. The windows of an image are nwh x nww, row-major; shift is 0
// or 6 (the cyclic shift, which turns the mask on). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int window_attn_forward(const void* qkv, const void* table,
                                   void* out, long long windows, int heads,
                                   int nwh, int nww, int shift, float scale,
                                   void* stream) {
  if (heads < 1 || nwh < 1 || nww < 1 || (shift != 0 && shift != kWin / 2)
      || !aligned16(qkv) || windows * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  window_attn_kernel<<<static_cast<unsigned>(windows * heads), kThreads, 0,
                       st>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(table),
      static_cast<bf16*>(out), heads, nwh, nww, shift, scale);
  return static_cast<int>(cudaGetLastError());
}
