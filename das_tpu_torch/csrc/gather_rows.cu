// Row gather (K4), its adjoint, the fused bilinear sampler and its
// backward, for sm_90a.
//
// Replaces the in-kernel row gather of
// tools/analysis_tools/pallas_gather_probe.py::gather_pl (a same-shape
// take_along_axis on axis 0), which the JAX package runs as
// XLA take_along_axis(..., mode='clip') in every bilinear sample
// (das_tpu/ops/interp.py:68-79) and in the recursive-update take_at
// (das_tpu/models/recursive_update.py:187-189), and XLA's adjoints of both.
//
//   gather:   out[n, p, :] = table[n, clamp(idx[n, p], 0, R - 1), :]
//   adjoint:  grad_table[n, r, :] = sum over p with clamp(idx[n, p]) == r
//                                   of grad_out[n, p, :]   (f32 accumulator)
//   sampler:  out[n, p, :] = the zero-padded bilinear sample of the
//             (N, H*W, C) image at (x[n, p], y[n, p]): four row reads, each
//             times its corner weight, summed; with a mask (N, P), that sum
//             times mask[n, p]
//   sampler backward: the vector-Jacobian product of the sampler, the image
//             gradient into an f32 accumulator, dx and dy in f32
//
// Bound: bytes. The gather reads each output row once, writes it once and
// reads each index once; the sampler reads four rows and two coordinates
// per point (and a masked one its mask value) and writes one row. At the
// serving shapes (rows of 3 to 256 channels, 512 to 18432 points per
// table) those bytes take 0.0002 to 0.04
// ms at an H100's 3.35 TB/s: mostly less than one launch costs the host.
// So what bounds the callers is the number of launches, and the design is
// about that:
//
// * One launch serves up to kMaxSegs segments, each its own (table, idx,
//   out) with its own R, P and row width; the descriptors travel by value
//   in the kernel's parameters. The recursive update's take_at of two
//   fields at the same points is two segments.
// * The adjoint is one call too. Segments that belong to one table add
//   into one f32 buffer with atomics, as XLA's scatter-add does; the call
//   zeroes the allocation that holds every buffer (one memset), adds, and
//   casts each bf16 table once (one grouped cast kernel), so the host
//   makes one call where a PyTorch composition makes four. A row goes to a
//   group of lanes sized to it: the group finds the row's segment and
//   reads and clamps its index once, then moves the row in 16-, 8-, 4- or
//   2-byte units, each added by one vector atomic (sm_90's float4 / float2
//   atomicAdd, REDG.E.ADD.F32x4) where the f32 unit is that wide. Offsets
//   are 32-bit where the sizes fit.
// * A whole sample is one launch: floor, the four weights in f32, the
//   in-bounds test, the cast of each weight to the table's type, four row
//   reads, four products and three sums, each rounded as the plain
//   composition of PyTorch calls rounds it (the _rn intrinsics, so
//   nothing contracts into a fused multiply-add; bf16 in packed pairs),
//   in the order (x0,y0), (x1,y0), (x0,y1), (x1,y1). It equals that
//   composition bit for bit in f32 and bf16. The four rows are loaded
//   before any arithmetic, and offsets are 32-bit where they fit: at a
//   DCN's 256 channels the per-element arithmetic and the 64-bit
//   divisions, not the bytes, had set the time (1.0849 ms against a
//   0.2867 ms bound at exp_panoptic's level 0; 0.78 ms after).
// * The served DCN's sample is masked (the MASKED instance of the same
//   kernel): each point's sum, rounded to T, is multiplied by the point's
//   modulation value in T and rounded once more, as PyTorch's product of
//   the sample and the mask rounds it. Its points are the nine taps of
//   each pixel in turn, so its output is the (N*H*W, 9*C) im2col matrix
//   of the DCN, which one GEMM contracts. It has no backward: training
//   samples unmasked and multiplies under autograd.
// * Its backward is one call too (zero-fill, kernel, cast), and needs only
//   the image and the coordinates: the training path saves no corner rows
//   and scatters none. In the 'clip' DCN of a B=4 640x1344 train step
//   that is 4 x 1,935,360 corner rows of 256 channels (3.96 GB in bf16) a
//   level-0 call. What bounds it on this card is the image gradient's
//   atomics: up to four rows of f32 adds a point, a vector atomic adding
//   16 bytes taking about the time of four scalar ones. The kernel gives each point a lane group sized to its row, forms the
//   weights, corners and masks once per point, adds each corner's share
//   with vector atomics (none for a corner outside the image or of zero
//   weight), and reduces the coordinates' sums over the group with
//   shuffles. A window of the image in shared memory, to add a patch's
//   shares there first, was tried and lost: shared-memory f32 atomics
//   compile to compare-and-swap loops (ATOMS.CAST.SPIN) on sm_90a. Taking
//   the points a chunk of neighbouring pixels at a time across all nine
//   planes of a DCN's taps, to keep the rows they add into in L2, gained
//   nothing measurable.
//
// A row moves in the widest unit (16, 8, 4 or 2 bytes) that divides its
// byte count and the base addresses: a 256-channel bf16 row is one 16-byte
// load per lane and a warp covers a row, while the recursive update's rows
// of 3, 6 and 8 channels move as 2-, 4- or 16-byte units, several rows per
// warp. The gather takes one thread per (row, unit); the threads of a row
// read its index in the same instruction (one broadcast transaction) and
// clamp it. It is a bit copy: it equals the plain version bit for bit in
// any type.
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

// One segment of a grouped gather: src the table, dst the output, a work
// item is one unit of 1 << shift bytes, `units` per row.
struct Seg {
  const char* src;
  const void* idx;
  char* dst;
  long long R, P;
  long long start;   // the first work item of this segment
  int units, shift, idx64;
};

struct Segs {
  Seg s[kMaxSegs];
  long long total;
  int n;
};

template <typename S>
__device__ __forceinline__ long long clamped_row(const S& g, long long row) {
  long long r = g.idx64
      ? __ldg(static_cast<const long long*>(g.idx) + row)
      : static_cast<long long>(__ldg(static_cast<const int*>(g.idx) + row));
  return r < 0 ? 0 : (r > g.R - 1 ? g.R - 1 : r);
}

template <typename SS>
__device__ __forceinline__ int segment_of(const SS& segs, long long t) {
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

// the widest unit, as log2 of its bytes, that divides the row and the base
// addresses, so that every row starts on a unit boundary
inline int unit_shift(uintptr_t a) {
  return a % 16 == 0 ? 4 : a % 8 == 0 ? 3 : a % 4 == 0 ? 2 : 1;
}

// the log2 of the lanes that a row of `units` units gets: the next power
// of two, at most a warp
inline int lanes_log2(int units) {
  int l = 0;
  while ((1 << l) < units && l < 5) ++l;
  return l;
}

template <int BYTES> struct Unit;
template <> struct Unit<2> { using type = uint16_t; };
template <> struct Unit<4> { using type = uint32_t; };
template <> struct Unit<8> { using type = uint2; };
template <> struct Unit<16> { using type = uint4; };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// an f32 value rounded to T, as a PyTorch op in T rounds its result
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// E f32 values added at p (aligned to min(4 E, 16) bytes) in global memory
// by the fewest atomics: sm_90's vector atomicAdd on float4 and float2
template <int E> __device__ __forceinline__ void red_add(float* p,
                                                         const float* v);
template <> __device__ __forceinline__ void red_add<1>(float* p,
                                                       const float* v) {
  atomicAdd(p, v[0]);
}
template <> __device__ __forceinline__ void red_add<2>(float* p,
                                                       const float* v) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}
template <> __device__ __forceinline__ void red_add<4>(float* p,
                                                       const float* v) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <> __device__ __forceinline__ void red_add<8>(float* p,
                                                       const float* v) {
  red_add<4>(p, v);
  red_add<4>(p + 4, v + 4);
}

// ---- the row adjoint -----------------------------------------------------

// One segment of a grouped adjoint: grad the output gradient (N, P, C),
// dst the table's zeroed f32 buffer (N, R, C). A row of grad goes to
// 1 << lanes lanes, which move it in units of E elements; a work item is
// one (row, lane).
struct RowSeg {
  const char* grad;
  const void* idx;
  float* dst;
  long long R, P;
  long long start;   // the first work item of this segment
  int C, units, lanes, E, bf16, idx64;
};

struct RowSegs {
  RowSeg s[kMaxSegs];
  long long total;
  int n;
};

template <typename T, int E, typename I>
__device__ __forceinline__ void scatter_row(const RowSeg& g, I row,
                                            int lane) {
  using U = typename Unit<E * sizeof(T)>::type;
  const I n = row / static_cast<I>(g.P);
  const I r = static_cast<I>(clamped_row(g, row));
  const U* src = reinterpret_cast<const U*>(g.grad) + row * g.units;
  float* dst = g.dst + (n * static_cast<I>(g.R) + r) * g.C;
  for (int u = lane; u < g.units; u += 1 << g.lanes) {
    const U bits = __ldg(src + u);
    const T* v = reinterpret_cast<const T*>(&bits);
    float f[E];
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = to_f(v[e]);
    red_add<E>(dst + u * E, f);
  }
}

// I: the offsets' type, int where every segment's N*R*C and N*P*C fit
template <typename I>
__global__ void scatter_rows_kernel(const __grid_constant__ RowSegs segs) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < segs.total; t += step) {
    const RowSeg& g = segs.s[segment_of(segs, t)];
    const long long local = t - g.start;
    const I row = static_cast<I>(local >> g.lanes);
    const int lane = static_cast<int>(local & ((1 << g.lanes) - 1));
    switch (g.bf16 * 16 + g.E) {
      case 4: scatter_row<float, 4, I>(g, row, lane); break;
      case 2: scatter_row<float, 2, I>(g, row, lane); break;
      case 1: scatter_row<float, 1, I>(g, row, lane); break;
      case 24: scatter_row<__nv_bfloat16, 8, I>(g, row, lane); break;
      case 20: scatter_row<__nv_bfloat16, 4, I>(g, row, lane); break;
      case 18: scatter_row<__nv_bfloat16, 2, I>(g, row, lane); break;
      default: scatter_row<__nv_bfloat16, 1, I>(g, row, lane); break;
    }
  }
}

// the widest unit of E elements of an adjoint segment: E divides C, the
// gradient's base is aligned to E elements and the f32 buffer's to the
// f32 unit (at most 16 bytes: a bf16 unit of 8 adds as two float4)
inline int adjoint_elems(uintptr_t grad, uintptr_t dst, int C, int bf16) {
  const int elt = bf16 ? 2 : 4;
  for (int E = bf16 ? 8 : 4; E > 1; E >>= 1) {
    const int f32_unit = E * 4 < 16 ? E * 4 : 16;
    if (C % E == 0 && grad % (E * elt) == 0 && dst % f32_unit == 0)
      return E;
  }
  return 1;
}

// ---- the fused sampler ---------------------------------------------------

__device__ __forceinline__ void cast_t(float w, float& out) { out = w; }
__device__ __forceinline__ void cast_t(float w, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(w);
}

// acc (E elements) = v * w where first, else acc + v * w, each product
// and sum rounded to T, none contracted into a fused multiply-add. In
// bf16 (in pairs where E is even) the bf16 instructions round once, as
// PyTorch's f32 operation then cast does: a product of two bf16 values
// is exact in f32, and an f32 sum of two rounds away only bits far below
// bf16's half ulp.
template <int E>
__device__ __forceinline__ void mul_add(float* acc, const float* v, float w,
                                        bool first) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float p = __fmul_rn(v[e], w);
    acc[e] = first ? p : __fadd_rn(acc[e], p);
  }
}
template <int E>
__device__ __forceinline__ void mul_add(__nv_bfloat16* acc,
                                        const __nv_bfloat16* v,
                                        __nv_bfloat16 w, bool first) {
  if constexpr (E % 2 == 0) {
    const __nv_bfloat162 w2 = __bfloat162bfloat162(w);
    __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(acc);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(v);
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      const __nv_bfloat162 p = __hmul2_rn(v2[e], w2);
      a2[e] = first ? p : __hadd2_rn(a2[e], p);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const __nv_bfloat16 p = __hmul_rn(v[e], w);
      acc[e] = first ? p : __hadd_rn(acc[e], p);
    }
  }
}

// T: the table's type; E: elements per unit; MASKED: each point's sum
// times mask[point] (N, P) in T; I: the offsets' type, int where the
// work items and the table's units fit. One thread per (point, unit);
// the threads of a point each form its weights again.
template <typename T, int E, bool MASKED, typename I>
__global__ void sample_rows_bilinear_kernel(
    const T* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ y, const T* __restrict__ mask,
    T* __restrict__ out, I rows, I P, int H, int W, int units) {
  using U = typename Unit<E * sizeof(T)>::type;
  const I total = rows * units;
  const I step = static_cast<I>(gridDim.x) * blockDim.x;
  const I R = static_cast<I>(H) * W;
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  for (I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const I row = t / units;
    const I u = t - row * units;
    const I n = row / P;
    const float xf = __ldg(x + row), yf = __ldg(y + row);
    const float x0 = floorf(xf), y0 = floorf(yf);
    const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
    const float wx1 = __fsub_rn(xf, x0), wy1 = __fsub_rn(yf, y0);
    const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
    const float xs[2] = {x0, x1}, ys[2] = {y0, y1};
    const float wxs[2] = {wx0, wx1}, wys[2] = {wy0, wy1};
    U bits[4];
    T w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {          // (x0,y0), (x1,y0), (x0,y1), (x1,y1)
      const float xi = xs[k & 1], yi = ys[k >> 1];
      const bool inb = xi >= 0.f && xi <= xmax && yi >= 0.f && yi <= ymax;
      cast_t(__fmul_rn(__fmul_rn(wxs[k & 1], wys[k >> 1]), inb ? 1.f : 0.f),
             w[k]);
      const I xc = static_cast<I>(fminf(fmaxf(xi, 0.f), xmax));
      const I yc = static_cast<I>(fminf(fmaxf(yi, 0.f), ymax));
      bits[k] = __ldg(reinterpret_cast<const U*>(table) +
                      (n * R + yc * W + xc) * units + u);
    }
    __align__(16) T acc[E];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mul_add<E>(acc, reinterpret_cast<const T*>(&bits[k]), w[k], k == 0);
    if (MASKED) mul_add<E>(acc, acc, mask[row], true);
    reinterpret_cast<U*>(out)[t] = *reinterpret_cast<const U*>(acc);
  }
}

template <typename T, int E, typename I>
void launch_sampler(const void* table, const float* x, const float* y,
                    const void* mask, void* out, I rows, I P, int H, int W,
                    int units, int grid, cudaStream_t stream) {
  if (mask != nullptr)
    sample_rows_bilinear_kernel<T, E, true, I>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const T*>(table), x, y, static_cast<const T*>(mask),
            static_cast<T*>(out), rows, P, H, W, units);
  else
    sample_rows_bilinear_kernel<T, E, false, I>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const T*>(table), x, y, nullptr,
            static_cast<T*>(out), rows, P, H, W, units);
}

template <typename T, int E>
void launch_sampler(const void* table, const float* x, const float* y,
                    const void* mask, void* out, long long N, long long P,
                    int H, int W, int row_bytes, cudaStream_t stream) {
  const int units = row_bytes / static_cast<int>(E * sizeof(T));
  const long long rows = N * P;
  const int grid = grid_for(rows * units);
  // an int t never passes 2^31 - 1, even one grid stride past the end
  if (rows * units + static_cast<long long>(grid) * kThreads < (1LL << 31) &&
      N * H * W * static_cast<long long>(units) < (1LL << 31))
    launch_sampler<T, E, int>(table, x, y, mask, out, static_cast<int>(rows),
                              static_cast<int>(P), H, W, units, grid, stream);
  else
    launch_sampler<T, E, long long>(table, x, y, mask, out, rows, P, H, W,
                                    units, grid, stream);
}

// ---- the sampler's backward ----------------------------------------------

// dtable null: no image gradient; dx null: no coordinate gradient (dy
// with it).
struct SampleBwd {
  const void* table;   // (N, H*W, C) T
  const void* grad;    // (N, P, C) T
  const float* x;      // (N, P)
  const float* y;
  float* dtable;       // (N, H*W, C) f32, zeroed
  float* dx;           // (N, P) f32
  float* dy;
  int N, H, W, P, C;
};

// A point's four corners in the order (x0,y0), (x1,y0), (x0,y1), (x1,y1):
// weights in f32 as the forward forms them, cast to T and back (zero
// outside the image), clamped pixel, in-bounds mask; and the two axes'
// weights for the coordinates' chain.
struct Corners {
  float w[4];
  int xc[4], yc[4];
  bool inb[4];
  float wx0, wx1, wy0, wy1;
};

template <typename T>
__device__ __forceinline__ void corners_of(float xf, float yf, int H, int W,
                                           Corners& c) {
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  const float x0 = floorf(xf), y0 = floorf(yf);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  c.wx1 = __fsub_rn(xf, x0);
  c.wy1 = __fsub_rn(yf, y0);
  c.wx0 = __fsub_rn(1.f, c.wx1);
  c.wy0 = __fsub_rn(1.f, c.wy1);
  const float xs[2] = {x0, x1}, ys[2] = {y0, y1};
  const float wxs[2] = {c.wx0, c.wx1}, wys[2] = {c.wy0, c.wy1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xi = xs[k & 1], yi = ys[k >> 1];
    c.inb[k] = xi >= 0.f && xi <= xmax && yi >= 0.f && yi <= ymax;
    c.w[k] = rnd<T>(__fmul_rn(__fmul_rn(wxs[k & 1], wys[k >> 1]),
                              c.inb[k] ? 1.f : 0.f));
    c.xc[k] = static_cast<int>(fminf(fmaxf(xi, 0.f), xmax));
    c.yc[k] = static_cast<int>(fminf(fmaxf(yi, 0.f), ymax));
  }
}

// dx, dy of a point from its four corners' sums dw_k (f32, not yet rounded
// to T): dw_k rounded to T and masked, then through the weights, in the
// order of the closed form (gather.py::sample_rows_bilinear_backward_plain)
template <typename T>
__device__ __forceinline__ void write_dxy(const SampleBwd& a, long long pt,
                                          const Corners& c,
                                          const float* part) {
  float dw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) dw[k] = c.inb[k] ? rnd<T>(part[k]) : 0.f;
  const float dwx0 = __fadd_rn(__fmul_rn(dw[0], c.wy0), __fmul_rn(dw[2], c.wy1));
  const float dwx1 = __fadd_rn(__fmul_rn(dw[1], c.wy0), __fmul_rn(dw[3], c.wy1));
  const float dwy0 = __fadd_rn(__fmul_rn(dw[0], c.wx0), __fmul_rn(dw[1], c.wx1));
  const float dwy1 = __fadd_rn(__fmul_rn(dw[2], c.wx0), __fmul_rn(dw[3], c.wx1));
  a.dx[pt] = __fsub_rn(dwx1, dwx0);
  a.dy[pt] = __fsub_rn(dwy1, dwy0);
}

// T: the image's type; E: elements per unit. A point goes to 1 << lanes
// lanes of a warp (lanes <= 5), which take its row's units in turn.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
sample_bwd_direct_kernel(const __grid_constant__ SampleBwd a, int lanes) {
  using U = typename Unit<E * sizeof(T)>::type;
  const int L = 1 << lanes;
  const int units = a.C / E;
  const int sub = threadIdx.x & (L - 1);
  const int per_block = kThreads >> lanes;
  const long long total = static_cast<long long>(a.N) * a.P;
  const long long R = static_cast<long long>(a.H) * a.W;
  const U* grad = static_cast<const U*>(a.grad);
  const U* table = static_cast<const U*>(a.table);
  // every lane of a warp runs every iteration, so that the shuffles meet
  for (long long base = static_cast<long long>(blockIdx.x) * per_block;
       base < total; base += static_cast<long long>(gridDim.x) * per_block) {
    const long long pt = base + (threadIdx.x >> lanes);   // the point
    const bool live = pt < total;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    Corners c;
    if (live) {
      const int n = static_cast<int>(pt / a.P);
      corners_of<T>(__ldg(a.x + pt), __ldg(a.y + pt), a.H, a.W, c);
      long long row[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        row[k] = n * R + static_cast<long long>(c.yc[k]) * a.W + c.xc[k];
      for (int u = sub; u < units; u += L) {
        const U gb = __ldg(grad + pt * units + u);
        const T* gv = reinterpret_cast<const T*>(&gb);
        float gf[E];
#pragma unroll
        for (int e = 0; e < E; ++e) gf[e] = to_f(gv[e]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.inb[k]) continue;           // a corner outside adds nothing
          if (a.dtable != nullptr && c.w[k] != 0.f) {
            float t[E];
#pragma unroll
            for (int e = 0; e < E; ++e) t[e] = rnd<T>(__fmul_rn(gf[e], c.w[k]));
            red_add<E>(a.dtable + row[k] * a.C + u * E, t);
          }
          if (a.dx != nullptr) {
            const U vb = __ldg(table + row[k] * units + u);
            const T* v = reinterpret_cast<const T*>(&vb);
#pragma unroll
            for (int e = 0; e < E; ++e)
              part[k] += rnd<T>(__fmul_rn(gf[e], to_f(v[e])));
          }
        }
      }
    }
    if (a.dx != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (int off = L >> 1; off > 0; off >>= 1)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
      if (live && sub == 0) write_dxy<T>(a, pt, c, part);
    }
  }
}

template <typename T, int E>
void launch_bwd_direct(const SampleBwd& a, cudaStream_t stream) {
  const int lanes = lanes_log2(a.C / E);
  const long long groups = (static_cast<long long>(a.N) * a.P + 
                            (kThreads >> lanes) - 1) / (kThreads >> lanes);
  const long long cap = 132LL * 8;
  const int blocks = static_cast<int>(groups < cap ? (groups < 1 ? 1 : groups)
                                                   : cap);
  sample_bwd_direct_kernel<T, E><<<blocks, kThreads, 0, stream>>>(a, lanes);
}

// f32 -> bf16 of up to kMaxSegs buffers in one launch (blockIdx.y: the
// buffer), four values a thread where both ends allow it: the adjoints'
// and the sampler backward's one cast of each accumulator
struct CastSeg {
  const float* src;
  __nv_bfloat16* dst;
  long long n;
};

struct CastSegs {
  CastSeg s[kMaxSegs];
  int n;
};

__global__ void cast_bf16_kernel(const __grid_constant__ CastSegs segs) {
  const CastSeg& c = segs.s[blockIdx.y];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const bool vec = reinterpret_cast<uintptr_t>(c.src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c.dst) % 8 == 0;
  const long long quads = vec ? c.n / 4 : 0;
  for (long long i = first; i < quads; i += step) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(c.src) + i);
    __align__(8) __nv_bfloat16 o[4] = {
        __float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y),
        __float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w)};
    reinterpret_cast<uint2*>(c.dst)[i] = *reinterpret_cast<const uint2*>(o);
  }
  for (long long i = quads * 4 + first; i < c.n; i += step)
    c.dst[i] = __float2bfloat16_rn(c.src[i]);
}

void launch_casts(const CastSegs& casts, cudaStream_t stream) {
  if (casts.n == 0) return;
  long long most = 0;
  for (int i = 0; i < casts.n; ++i)
    most = casts.s[i].n > most ? casts.s[i].n : most;
  dim3 grid(grid_for((most + 3) / 4), casts.n);
  cast_bf16_kernel<<<grid, kThreads, 0, stream>>>(casts);
}

}  // namespace

extern "C" {

// The gather. desc: n rows of 7 int64 each: table, idx, out, R, P, row
// bytes (an even number), idx is int64; with table (N, R, C), idx (N, P)
// and out (N, P, C); 1 <= n <= 8.
int gather_rows_grouped(const long long* desc, int n, long long N,
                        cudaStream_t stream) {
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
    g.shift = unit_shift(static_cast<uintptr_t>(d[0]) |
                         static_cast<uintptr_t>(d[2]) |
                         static_cast<uintptr_t>(d[5]));
    g.units = static_cast<int>(d[5] >> g.shift);
    g.idx64 = static_cast<int>(d[6]);
    const long long work = N * g.P * g.units;
    if (work <= 0) continue;          // an empty segment launches nothing
    total += work;
    ++used;
  }
  if (used > 0) {
    segs.n = used;
    segs.total = total;
    gather_grouped_kernel<<<grid_for(total), kThreads, 0, stream>>>(segs);
  }
  return static_cast<int>(cudaGetLastError());
}

// The adjoint, whole: zero `zero_bytes` at `zero` (the one allocation that
// holds every table's f32 buffer), add the segments' rows, cast the bf16
// tables. desc: n rows of 9 int64 each: grad_out, idx, the table's f32
// buffer (16-byte aligned where the row's unit allows), R, P, C,
// (grad_out is bf16) | (idx is int64) << 1, the table's bf16 output or 0
// (set on one segment of a table, which is then cast there once), the
// table's elements N*R*C; with idx (N, P) and grad_out (N, P, C);
// 1 <= n <= 8.
int scatter_rows_grouped(const long long* desc, int n, long long N,
                         void* zero, long long zero_bytes,
                         cudaStream_t stream) {
  if (n < 1 || n > kMaxSegs) return static_cast<int>(cudaErrorInvalidValue);
  if (zero_bytes > 0) {
    const cudaError_t e = cudaMemsetAsync(zero, 0, zero_bytes, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  RowSegs segs;
  CastSegs casts;
  casts.n = 0;
  long long total = 0, biggest = 0;
  int used = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + 9 * i;
    if (d[7] != 0) {
      casts.s[casts.n].src = reinterpret_cast<const float*>(d[2]);
      casts.s[casts.n].dst = reinterpret_cast<__nv_bfloat16*>(d[7]);
      casts.s[casts.n].n = d[8];
      ++casts.n;
    }
    RowSeg& g = segs.s[used];
    g.grad = reinterpret_cast<const char*>(d[0]);
    g.idx = reinterpret_cast<const void*>(d[1]);
    g.dst = reinterpret_cast<float*>(d[2]);
    g.R = d[3];
    g.P = d[4];
    g.C = static_cast<int>(d[5]);
    g.bf16 = static_cast<int>(d[6] & 1);
    g.idx64 = static_cast<int>(d[6] >> 1);
    g.E = adjoint_elems(static_cast<uintptr_t>(d[0]),
                        static_cast<uintptr_t>(d[2]), g.C, g.bf16);
    g.units = g.C / g.E;
    g.lanes = lanes_log2(g.units);
    g.start = total;
    if (N * g.P * g.C <= 0) continue;   // an empty segment adds nothing
    biggest = N * g.R * g.C > biggest ? N * g.R * g.C : biggest;
    biggest = N * g.P * g.C > biggest ? N * g.P * g.C : biggest;
    total += (N * g.P) << g.lanes;
    ++used;
  }
  if (used > 0) {
    segs.n = used;
    segs.total = total;
    if (biggest < (1LL << 31))
      scatter_rows_kernel<int><<<grid_for(total), kThreads, 0, stream>>>(
          segs);
    else
      scatter_rows_kernel<long long>
          <<<grid_for(total), kThreads, 0, stream>>>(segs);
  }
  launch_casts(casts, stream);
  return static_cast<int>(cudaGetLastError());
}

// table (N, H*W, C) f32 or bf16 (bf16 != 0), x and y (N, P) f32, mask
// (N, P) in the table's type or null (no mask), out (N, P, C) in the
// table's type.
int sample_rows_bilinear(const void* table, const float* x, const float* y,
                         const void* mask, void* out, long long N, int H,
                         int W, long long P, int C, int bf16,
                         cudaStream_t stream) {
  const long long rows = N * P;
  if (rows > 0 && C > 0) {
    const int row_bytes = C * (bf16 ? 2 : 4);
    const int shift = unit_shift(reinterpret_cast<uintptr_t>(table) |
                                 reinterpret_cast<uintptr_t>(out) |
                                 static_cast<uintptr_t>(row_bytes));
#define SAMPLE(T, E) \
  launch_sampler<T, E>(table, x, y, mask, out, N, P, H, W, row_bytes, stream)
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

// The sampler's backward, whole. table (N, H*W, C) f32 or bf16 (bf16 !=
// 0), grad (N, P, C) in its type, x and y (N, P) f32. dtable (N, H*W, C)
// f32, zeroed here, or null for no image gradient; for a bf16 table `out`
// (N, H*W, C) bf16 receives its cast (null for f32: dtable is the
// gradient). dx and dy (N, P) f32, or null for no coordinate gradient.
int sample_rows_bilinear_backward(const void* table, const void* grad,
                                  const float* x, const float* y,
                                  float* dtable, void* out, float* dx,
                                  float* dy, long long N, int H, int W,
                                  long long P, int C, int bf16,
                                  cudaStream_t stream) {
  if (N * P >= (1LL << 31) || (dx == nullptr) != (dy == nullptr) ||
      (bf16 && dtable != nullptr && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elems = N * H * W * C;
  if (dtable != nullptr && elems > 0) {
    const cudaError_t e = cudaMemsetAsync(dtable, 0, elems * 4, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (N * P > 0 && C > 0 && (dtable != nullptr || dx != nullptr)) {
    SampleBwd a;
    a.table = table;
    a.grad = grad;
    a.x = x;
    a.y = y;
    a.dtable = dtable;
    a.dx = dx;
    a.dy = dy;
    a.N = static_cast<int>(N);
    a.H = H;
    a.W = W;
    a.P = static_cast<int>(P);
    a.C = C;
    const int row_bytes = C * (bf16 ? 2 : 4);
    const int shift = unit_shift(reinterpret_cast<uintptr_t>(table) |
                                 reinterpret_cast<uintptr_t>(grad) |
                                 static_cast<uintptr_t>(row_bytes));
#define BWD(T, E) launch_bwd_direct<T, E>(a, stream)
    if (bf16) {
      if (shift == 4) BWD(__nv_bfloat16, 8);
      else if (shift == 3) BWD(__nv_bfloat16, 4);
      else if (shift == 2) BWD(__nv_bfloat16, 2);
      else BWD(__nv_bfloat16, 1);
    } else {
      if (shift == 4) BWD(float, 4);
      else if (shift == 3) BWD(float, 2);
      else BWD(float, 1);
    }
#undef BWD
  }
  if (bf16 && dtable != nullptr && elems > 0) {
    CastSegs casts;
    casts.n = 1;
    casts.s[0].src = dtable;
    casts.s[0].dst = static_cast<__nv_bfloat16*>(out);
    casts.s[0].n = elems;
    launch_casts(casts, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
