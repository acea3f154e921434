// Row gather (K4) and its adjoint, for sm_90a.
//
// Replaces the in-kernel row gather of
// tools/analysis_tools/pallas_gather_probe.py::gather_pl (a same-shape
// take_along_axis on axis 0), which the JAX package runs as XLA
// take_along_axis(..., mode='clip') in every bilinear sample
// (das_tpu/ops/interp.py:68-79) and in the recursive-update take_at
// (das_tpu/models/recursive_update.py:187-189).
//
//   forward:  out[n, p, :] = table[n, clamp(idx[n, p], 0, R - 1), :]
//   backward: grad_table[n, r, :] = sum over p with clamp(idx[n, p]) == r
//                                   of grad_out[n, p, :]   (f32 accumulator)
//
// Bound: no arithmetic, so bytes. The forward reads each output row once
// and writes it once, and reads each index once:
// (2 N P C elt + N P idx_bytes) / 3.35 TB/s. At the probe's shape
// (11520 rows of 128 bf16) that is 1.77 us, far below a launch, so the
// kernel is launch-bound at every shape of the model.
//
// Design: a row is copied in the widest unit (16, 8, 4 or 2 bytes) that
// divides its byte count and the two base addresses, so the 256-channel
// bf16 rows of the DCN taps move as one 16-byte load per lane and a warp
// covers a row, while the recursive
// update's rows of 3, 6 and 8 channels move as 2-, 4- or 16-byte units,
// several rows per warp. One thread per (row, unit); the threads of a row
// read its index in the same instruction (one broadcast transaction) and
// clamp it. The forward is a bit copy: it equals the plain version bit for
// bit in any type. The backward adds into an f32 buffer with atomics, as
// XLA's scatter-add does; the wrapper casts the buffer to the table's type.
//
// Every function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  // a grid-stride loop covers the rest: 16 blocks of 256 per SM fill the
  // 132 SMs of an H100
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

template <typename I>
__device__ __forceinline__ long long clamped_row(const I* idx, long long row,
                                                 long long R) {
  long long r = static_cast<long long>(__ldg(idx + row));
  return r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
}

// U: the copy unit; units: units per row; rows = N * P output rows
template <typename U, typename I>
__global__ void gather_rows_kernel(const U* __restrict__ table,
                                   const I* __restrict__ idx,
                                   U* __restrict__ out, long long rows,
                                   long long P, long long R, int units) {
  const long long total = rows * units;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += step) {
    const long long row = t / units;
    const int u = static_cast<int>(t - row * units);
    const long long n = row / P;
    const long long r = clamped_row(idx, row, R);
    out[t] = __ldg(table + (n * R + r) * units + u);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one thread per element of grad_out (N, P, C)
template <typename T, typename I>
__global__ void scatter_rows_kernel(const T* __restrict__ grad,
                                    const I* __restrict__ idx,
                                    float* __restrict__ buf, long long rows,
                                    long long P, long long R, int C) {
  const long long total = rows * C;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += step) {
    const long long row = t / C;
    const int c = static_cast<int>(t - row * C);
    const long long n = row / P;
    const long long r = clamped_row(idx, row, R);
    atomicAdd(buf + (n * R + r) * C + c, to_f32(grad[t]));
  }
}

template <typename U, typename I>
void launch_gather(const void* table, const void* idx, void* out,
                   long long rows, long long P, long long R, int row_bytes,
                   cudaStream_t stream) {
  const int units = row_bytes / static_cast<int>(sizeof(U));
  gather_rows_kernel<U, I><<<grid_for(rows * units), kThreads, 0, stream>>>(
      static_cast<const U*>(table), static_cast<const I*>(idx),
      static_cast<U*>(out), rows, P, R, units);
}

template <typename I>
void launch_gather_unit(const void* table, const void* idx, void* out,
                        long long rows, long long P, long long R,
                        int row_bytes, cudaStream_t stream) {
  // the widest unit that divides the row and both base addresses, so that
  // every row of the table and of the output starts on a unit boundary
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0)
    launch_gather<uint4, I>(table, idx, out, rows, P, R, row_bytes, stream);
  else if (a % 8 == 0)
    launch_gather<uint2, I>(table, idx, out, rows, P, R, row_bytes, stream);
  else if (a % 4 == 0)
    launch_gather<uint32_t, I>(table, idx, out, rows, P, R, row_bytes,
                               stream);
  else
    launch_gather<uint16_t, I>(table, idx, out, rows, P, R, row_bytes,
                               stream);
}

template <typename T>
void launch_scatter(const void* grad, const void* idx, float* buf,
                    long long rows, long long P, long long R, int C,
                    int idx64, cudaStream_t stream) {
  const int grid = grid_for(rows * C);
  if (idx64)
    scatter_rows_kernel<T, long long><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(grad), static_cast<const long long*>(idx), buf,
        rows, P, R, C);
  else
    scatter_rows_kernel<T, int><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(grad), static_cast<const int*>(idx), buf, rows,
        P, R, C);
}

}  // namespace

extern "C" {

// table (N, R, C), idx (N, P) int32 or int64 (idx64), out (N, P, C);
// row_bytes = C * element size, an even number.
int gather_rows_forward(const void* table, const void* idx, void* out,
                        long long N, long long R, long long P, int row_bytes,
                        int idx64, cudaStream_t stream) {
  const long long rows = N * P;
  if (rows > 0) {
    if (idx64)
      launch_gather_unit<long long>(table, idx, out, rows, P, R, row_bytes,
                                    stream);
    else
      launch_gather_unit<int>(table, idx, out, rows, P, R, row_bytes, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad (N, P, C) f32 or bf16 (bf16 != 0), idx as above, buf (N, R, C) f32,
// zeroed by the caller.
int gather_rows_backward(const void* grad, const void* idx, float* buf,
                         long long N, long long R, long long P, int C,
                         int bf16, int idx64, cudaStream_t stream) {
  const long long rows = N * P;
  if (rows > 0 && C > 0) {
    if (bf16)
      launch_scatter<__nv_bfloat16>(grad, idx, buf, rows, P, R, C, idx64,
                                    stream);
    else
      launch_scatter<float>(grad, idx, buf, rows, P, R, C, idx64, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
