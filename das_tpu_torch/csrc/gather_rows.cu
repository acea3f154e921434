// Row gather (K4), its adjoint, and the fused bilinear sampler, for sm_90a.
//
// Replaces the in-kernel row gather of
// tools/analysis_tools/pallas_gather_probe.py::gather_pl (a same-shape
// take_along_axis on axis 0), which the JAX package runs as XLA
// take_along_axis(..., mode='clip') in every bilinear sample
// (das_tpu/ops/interp.py:68-79) and in the recursive-update take_at
// (das_tpu/models/recursive_update.py:187-189).
//
//   gather:   out[n, p, :] = table[n, clamp(idx[n, p], 0, R - 1), :]
//   adjoint:  grad_table[n, r, :] = sum over p with clamp(idx[n, p]) == r
//                                   of grad_out[n, p, :]   (f32 accumulator)
//   sampler:  out[n, p, :] = the zero-padded bilinear sample of the
//             (N, H*W, C) image at (x[n, p], y[n, p]): four row reads, each
//             times its corner weight, summed
//
// Bound: bytes. The gather reads each output row once, writes it once and
// reads each index once; the sampler reads four rows and two coordinates
// per point and writes one row. At the model's shapes (rows of 3 to 256
// channels, 512 to 18432 points per table) those bytes take 0.0002 to 0.04
// ms at an H100's 3.35 TB/s: mostly less than one launch costs the host.
// So what bounds the callers is the number of launches, and the design is
// about that:
//
// * One launch serves up to kMaxSegs segments, each its own (table, idx,
//   out) with its own R, P and row width; the descriptors travel by value
//   in the kernel's parameters. The four corners of a bilinear sample are
//   one segment with 4 P indices; the recursive update's take_at of two
//   fields at the same points is two segments.
// * The adjoint is one launch too. Segments that belong to one table add
//   into one zeroed f32 buffer with atomics, as XLA's scatter-add does; the
//   wrapper zeroes it once and casts it once.
// * Where no gradient is asked for, sample_rows_bilinear does a whole
//   sample in one launch: floor, the four weights in f32, the in-bounds
//   test, the cast of each weight to the table's type, four row reads, four
//   products and three sums, each rounded as the plain composition of
//   PyTorch calls rounds it (__fmul_rn and __fadd_rn, so nothing contracts
//   into a fused multiply-add), in the order (x0,y0), (x1,y0), (x0,y1),
//   (x1,y1). It equals that composition bit for bit in f32 and bf16.
//
// A row moves in the widest unit (16, 8, 4 or 2 bytes) that divides its
// byte count and the base addresses: a 256-channel bf16 row is one 16-byte
// load per lane and a warp covers a row, while the recursive update's rows
// of 3, 6 and 8 channels move as 2-, 4- or 16-byte units, several rows per
// warp. One thread per (row, unit); the threads of a row read its index in
// the same instruction (one broadcast transaction) and clamp it. The gather
// is a bit copy: it equals the plain version bit for bit in any type.
//
// Every function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 8;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  // a grid-stride loop covers the rest: 16 blocks of 256 per SM fill the
  // 132 SMs of an H100
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

// One segment of a grouped launch. Forward: src the table, dst the output,
// a work item is one unit of 1 << shift bytes, `units` per row. Adjoint:
// src the output gradient, dst the table's f32 buffer, a work item is one
// element, `units` = C per row, `bf16` the gradient's type.
struct Seg {
  const char* src;
  const void* idx;
  char* dst;
  long long R, P;
  long long start;   // the first work item of this segment
  int units, shift, idx64, bf16;
};

struct Segs {
  Seg s[kMaxSegs];
  long long total;
  int n;
};

__device__ __forceinline__ long long clamped_row(const Seg& g, long long row) {
  long long r = g.idx64
      ? __ldg(static_cast<const long long*>(g.idx) + row)
      : static_cast<long long>(__ldg(static_cast<const int*>(g.idx) + row));
  return r < 0 ? 0 : (r > g.R - 1 ? g.R - 1 : r);
}

__device__ __forceinline__ int segment_of(const Segs& segs, long long t) {
  int s = 0;
  while (s + 1 < segs.n && t >= segs.s[s + 1].start) ++s;
  return s;
}

template <typename U>
__device__ __forceinline__ void copy_unit(char* dst, const char* src,
                                          long long to, long long from) {
  reinterpret_cast<U*>(dst)[to] = __ldg(reinterpret_cast<const U*>(src) + from);
}

__global__ void gather_grouped_kernel(const __grid_constant__ Segs segs) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < segs.total; t += step) {
    const Seg& g = segs.s[segment_of(segs, t)];
    const long long local = t - g.start;
    const long long row = local / g.units;
    const long long u = local - row * g.units;
    const long long n = row / g.P;
    const long long from = (n * g.R + clamped_row(g, row)) * g.units + u;
    switch (g.shift) {
      case 4: copy_unit<uint4>(g.dst, g.src, local, from); break;
      case 3: copy_unit<uint2>(g.dst, g.src, local, from); break;
      case 2: copy_unit<uint32_t>(g.dst, g.src, local, from); break;
      default: copy_unit<uint16_t>(g.dst, g.src, local, from); break;
    }
  }
}

// one thread per element of each segment's grad_out (N, P, C)
__global__ void scatter_grouped_kernel(const __grid_constant__ Segs segs) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < segs.total; t += step) {
    const Seg& g = segs.s[segment_of(segs, t)];
    const long long local = t - g.start;
    const long long row = local / g.units;
    const long long c = local - row * g.units;
    const long long n = row / g.P;
    const float v = g.bf16
        ? __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(g.src)[local])
        : reinterpret_cast<const float*>(g.src)[local];
    atomicAdd(reinterpret_cast<float*>(g.dst) +
                  (n * g.R + clamped_row(g, row)) * g.units + c, v);
  }
}

// the widest unit, as log2 of its bytes, that divides the row and the base
// addresses, so that every row starts on a unit boundary
inline int unit_shift(uintptr_t a) {
  return a % 16 == 0 ? 4 : a % 8 == 0 ? 3 : a % 4 == 0 ? 2 : 1;
}

// ---- the fused sampler ---------------------------------------------------

__device__ __forceinline__ float mul_t(float v, float w) {
  return __fmul_rn(v, w);
}
__device__ __forceinline__ __nv_bfloat16 mul_t(__nv_bfloat16 v,
                                               __nv_bfloat16 w) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(v), __bfloat162float(w)));
}
__device__ __forceinline__ float add_t(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 add_t(__nv_bfloat16 a,
                                               __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ void cast_t(float w, float& out) { out = w; }
__device__ __forceinline__ void cast_t(float w, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(w);
}

template <int BYTES> struct Unit;
template <> struct Unit<2> { using type = uint16_t; };
template <> struct Unit<4> { using type = uint32_t; };
template <> struct Unit<8> { using type = uint2; };
template <> struct Unit<16> { using type = uint4; };

// T: the table's type; E: elements per unit. One thread per (point, unit);
// the threads of a point each form its weights again.
template <typename T, int E>
__global__ void sample_rows_bilinear_kernel(
    const T* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ y, T* __restrict__ out, long long rows,
    long long P, int H, int W, int units) {
  using U = typename Unit<E * sizeof(T)>::type;
  const long long total = rows * units;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long R = static_cast<long long>(H) * W;
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += step) {
    const long long row = t / units;
    const long long u = t - row * units;
    const long long n = row / P;
    const float xf = __ldg(x + row), yf = __ldg(y + row);
    const float x0 = floorf(xf), y0 = floorf(yf);
    const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
    const float wx1 = __fsub_rn(xf, x0), wy1 = __fsub_rn(yf, y0);
    const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
    const float xs[2] = {x0, x1}, ys[2] = {y0, y1};
    const float wxs[2] = {wx0, wx1}, wys[2] = {wy0, wy1};
    __align__(16) T acc[E];
#pragma unroll
    for (int k = 0; k < 4; ++k) {          // (x0,y0), (x1,y0), (x0,y1), (x1,y1)
      const float xi = xs[k & 1], yi = ys[k >> 1];
      const bool inb = xi >= 0.f && xi <= xmax && yi >= 0.f && yi <= ymax;
      T w;
      cast_t(__fmul_rn(__fmul_rn(wxs[k & 1], wys[k >> 1]), inb ? 1.f : 0.f),
             w);
      const long long xc =
          static_cast<long long>(fminf(fmaxf(xi, 0.f), xmax));
      const long long yc =
          static_cast<long long>(fminf(fmaxf(yi, 0.f), ymax));
      const U bits = __ldg(reinterpret_cast<const U*>(table) +
                           (n * R + yc * W + xc) * units + u);
      const T* v = reinterpret_cast<const T*>(&bits);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const T p = mul_t(v[e], w);
        acc[e] = k == 0 ? p : add_t(acc[e], p);
      }
    }
    reinterpret_cast<U*>(out)[t] = *reinterpret_cast<const U*>(acc);
  }
}

template <typename T, int E>
void launch_sampler(const void* table, const float* x, const float* y,
                    void* out, long long rows, long long P, int H, int W,
                    int row_bytes, cudaStream_t stream) {
  const int units = row_bytes / static_cast<int>(E * sizeof(T));
  sample_rows_bilinear_kernel<T, E>
      <<<grid_for(rows * units), kThreads, 0, stream>>>(
          static_cast<const T*>(table), x, y, static_cast<T*>(out), rows, P,
          H, W, units);
}

}  // namespace

extern "C" {

// desc: n rows of 7 int64 each,
//   forward: table, idx, out, R, P, row bytes (an even number), idx is int64
//   adjoint: grad_out, idx, the table's zeroed f32 buffer, R, P, C,
//            (grad_out is bf16) | (idx is int64) << 1
// with table (N, R, C), idx (N, P), out and grad_out (N, P, C); 1 <= n <= 8.
int gather_rows_grouped(const long long* desc, int n, long long N,
                        int backward, cudaStream_t stream) {
  if (n < 1 || n > kMaxSegs) return static_cast<int>(cudaErrorInvalidValue);
  Segs segs;
  long long total = 0;
  int used = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + 7 * i;
    Seg& g = segs.s[used];
    g.src = reinterpret_cast<const char*>(d[0]);
    g.idx = reinterpret_cast<const void*>(d[1]);
    g.dst = reinterpret_cast<char*>(d[2]);
    g.R = d[3];
    g.P = d[4];
    g.start = total;
    if (backward) {
      g.units = static_cast<int>(d[5]);
      g.shift = 0;
      g.bf16 = static_cast<int>(d[6] & 1);
      g.idx64 = static_cast<int>(d[6] >> 1);
    } else {
      g.shift = unit_shift(static_cast<uintptr_t>(d[0]) |
                           static_cast<uintptr_t>(d[2]) |
                           static_cast<uintptr_t>(d[5]));
      g.units = static_cast<int>(d[5] >> g.shift);
      g.bf16 = 0;
      g.idx64 = static_cast<int>(d[6]);
    }
    const long long work = N * g.P * g.units;
    if (work <= 0) continue;          // an empty segment launches nothing
    total += work;
    ++used;
  }
  if (used > 0) {
    segs.n = used;
    segs.total = total;
    if (backward)
      scatter_grouped_kernel<<<grid_for(total), kThreads, 0, stream>>>(segs);
    else
      gather_grouped_kernel<<<grid_for(total), kThreads, 0, stream>>>(segs);
  }
  return static_cast<int>(cudaGetLastError());
}

// table (N, H*W, C) f32 or bf16 (bf16 != 0), x and y (N, P) f32, out
// (N, P, C) in the table's type.
int sample_rows_bilinear(const void* table, const float* x, const float* y,
                         void* out, long long N, int H, int W, long long P,
                         int C, int bf16, cudaStream_t stream) {
  const long long rows = N * P;
  if (rows > 0 && C > 0) {
    const int row_bytes = C * (bf16 ? 2 : 4);
    const int shift = unit_shift(reinterpret_cast<uintptr_t>(table) |
                                 reinterpret_cast<uintptr_t>(out) |
                                 static_cast<uintptr_t>(row_bytes));
#define SAMPLE(T, E) \
  launch_sampler<T, E>(table, x, y, out, rows, P, H, W, row_bytes, stream)
    if (bf16) {
      if (shift == 4) SAMPLE(__nv_bfloat16, 8);
      else if (shift == 3) SAMPLE(__nv_bfloat16, 4);
      else if (shift == 2) SAMPLE(__nv_bfloat16, 2);
      else SAMPLE(__nv_bfloat16, 1);
    } else {
      if (shift == 4) SAMPLE(float, 4);
      else if (shift == 3) SAMPLE(float, 2);
      else SAMPLE(float, 1);
    }
#undef SAMPLE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
