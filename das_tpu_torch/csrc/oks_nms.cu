// Greedy hard OKS-NMS keep mask, hand-written for Hopper (sm_90a). Built by
// das_tpu_torch/ops/oks_nms.py with nvcc into a shared library with a plain
// C interface and called through ctypes.
//
// Replaces: das_tpu/ops/pallas_nms.py::oks_nms_pallas (the TPU kernel K3).
// Same function, per image: candidates sorted by score, descending;
// sim(i, j) = mean over the J joints of exp(-d2 / (2 var_k) / scale) with
// d2 the squared distance of joint k, var_k = (2 sigma_k)^2 and
// scale = (a_i + a_j) / 2 + eps; candidate i is kept iff valid[i] and no
// kept j < i has sim(i, j) > thr. The expression order is the plain
// version's, with no fused multiply-add, so sim has the plain version's bits
// wherever expf does.
//
// What bounds it on an H100: the pairwise similarities, ~9 f32 operations per
// joint per pair (an exp and two divisions among them), M^2 / 2 pairs per
// image, on the CUDA cores; the inputs are a few MB. The greedy scan is a
// chain of M dependent decisions, which no bound on bytes or operations
// sees: its cost is latency.
//
// Design (torchvision's NMS scheme with OKS in place of IoU): the TPU kernel
// built the whole M x M similarity matrix in VMEM (55 MB at M = 3720), then
// scanned it. Here:
//   1. a grid kernel, one block per (64-row block, 64-column block, image),
//      one thread per row, computes sim on the fly for the 64 columns j < i
//      and stores the bits sim > thr as one uint64 word: an M x ceil(M/64)
//      bit matrix per image (1.7 MB at M = 3720). Blocks above the diagonal
//      write zero words;
//   2. one block per image: warp 0 walks i in order, holding the kept set as
//      a bitset in shared memory, and keeps i iff valid[i] and its row's
//      words AND the kept set are all zero (one __any_sync per row); the
//      other warps meanwhile stage the next chunk of rows in shared memory.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TB = 64;          // rows and columns per block: one bit word
constexpr int JMAX = 32;        // joints the kernel takes
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_SMEM = 48 * 1024;

__global__ void __launch_bounds__(TB)
oks_mask_kernel(const float* __restrict__ kpts,     // (B, M, J, 2)
                const float* __restrict__ areas,    // (B, M)
                const float* __restrict__ var2,     // (J,) 2 * (2 sigma)^2
                unsigned long long* __restrict__ mask,   // (B, M, NW)
                int M, int J, int NW, float thr, float eps) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int i = rb * TB + t;
  unsigned long long* row = mask + ((size_t)b * M + i) * NW;
  if (cb > rb) {            // no j < i in this block
    if (i < M) row[cb] = 0ull;
    return;
  }
  __shared__ float xr[JMAX][TB], yr[JMAX][TB];       // this block's rows
  __shared__ float xc[TB][JMAX + 1], yc[TB][JMAX + 1];   // its columns
  __shared__ float ac[TB], v2[JMAX];
  const int i0 = rb * TB, j0 = cb * TB;
  const float* kb = kpts + (size_t)b * M * J * 2;
  for (int e = t; e < TB * J; e += TB) {
    const int q = e / J, k = e % J;
    const bool ri = i0 + q < M, cj = j0 + q < M;
    xr[k][q] = ri ? kb[((size_t)(i0 + q) * J + k) * 2] : 0.f;
    yr[k][q] = ri ? kb[((size_t)(i0 + q) * J + k) * 2 + 1] : 0.f;
    xc[q][k] = cj ? kb[((size_t)(j0 + q) * J + k) * 2] : 0.f;
    yc[q][k] = cj ? kb[((size_t)(j0 + q) * J + k) * 2 + 1] : 0.f;
  }
  ac[t] = j0 + t < M ? areas[(size_t)b * M + j0 + t] : 0.f;
  for (int k = t; k < J; k += TB) v2[k] = var2[k];
  __syncthreads();
  if (i >= M) return;
  const float ai = areas[(size_t)b * M + i];
  const float fj = (float)J;
  const int jn = min(TB, i - j0);           // columns j0 .. j0+jn-1 are < i
  unsigned long long word = 0ull;
  for (int q = 0; q < jn; ++q) {
    const float scale = __fadd_rn(__fmul_rn(__fadd_rn(ai, ac[q]), 0.5f), eps);
    float acc = 0.f;
    for (int k = 0; k < J; ++k) {
      const float dx = __fsub_rn(xr[k][t], xc[q][k]);
      const float dy = __fsub_rn(yr[k][t], yc[q][k]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      acc = __fadd_rn(acc, expf(__fdiv_rn(__fdiv_rn(-d2, v2[k]), scale)));
    }
    if (__fdiv_rn(acc, fj) > thr) word |= 1ull << q;
  }
  row[cb] = word;
}

__global__ void __launch_bounds__(SCAN_THREADS)
oks_scan_kernel(const unsigned long long* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int M, int NW, int R) {
  extern __shared__ unsigned long long sm[];
  unsigned long long* kept = sm;              // NW words: the kept set
  unsigned long long* buf[2] = {sm + NW, sm + NW + (size_t)R * NW};
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const unsigned long long* mb = mask + (size_t)b * M * NW;
  for (int w = tid; w < NW; w += SCAN_THREADS) kept[w] = 0ull;
  for (int e = tid; e < min(R, M) * NW; e += SCAN_THREADS) buf[0][e] = mb[e];
  __syncthreads();
  const int chunks = (M + R - 1) / R;
  for (int ch = 0; ch < chunks; ++ch) {
    const unsigned long long* cur = buf[ch % 2];
    const int r0 = ch * R, rn = min(R, M - r0);
    if (warp != 0) {
      const int n0 = r0 + R;
      if (n0 < M) {
        unsigned long long* nxt = buf[(ch + 1) % 2];
        const int nn = min(R, M - n0) * NW;
        for (int e = tid - 32; e < nn; e += SCAN_THREADS - 32)
          nxt[e] = mb[(size_t)n0 * NW + e];
      }
    } else {
      for (int r = 0; r < rn; ++r) {
        const int i = r0 + r;
        const int nw = (i + 63) / 64;       // the words that hold j < i
        bool hit = false;
        for (int w = lane; w < nw; w += 32)
          hit |= (cur[(size_t)r * NW + w] & kept[w]) != 0ull;
        hit = __any_sync(0xffffffffu, hit);
        if (lane == 0) {
          const bool ok = valid[(size_t)b * M + i] && !hit;
          keep[(size_t)b * M + i] = ok;
          if (ok) kept[i / 64] |= 1ull << (i % 64);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Rows of the bit matrix staged per chunk by the scan, for M candidates;
// 0 if M is too large for the scan's shared memory.
extern "C" int oks_nms_scan_rows(int M) {
  const int nw = (M + TB - 1) / TB;
  const int words = SCAN_SMEM / 8 - nw;
  return words < 2 * nw ? 0 : (words / (2 * nw) < TB ? words / (2 * nw) : TB);
}

// kpts (B,M,J,2), areas (B,M), var2 (J,) f32; valid (B,M) bool; scratch
// mask (B, M, ceil(M/64)) uint64; keep (B,M) bool. All contiguous, on the
// device; J <= 32. Returns cudaGetLastError() after the first launch that
// fails, or after the last; cudaErrorInvalidValue if M or J is too large.
extern "C" int oks_nms_keep_forward(const void* kpts, const void* areas,
                                    const void* var2, const void* valid,
                                    void* mask, void* keep, int B, int M,
                                    int J, float thr, float eps,
                                    void* stream) {
  if (B == 0 || M == 0) return 0;
  const int R = oks_nms_scan_rows(M);
  if (J > JMAX || J < 1 || R == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nw = (M + TB - 1) / TB;
  oks_mask_kernel<<<dim3(nw, nw, B), TB, 0, s>>>(
      static_cast<const float*>(kpts), static_cast<const float*>(areas),
      static_cast<const float*>(var2),
      static_cast<unsigned long long*>(mask), M, J, nw, thr, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(nw + 2 * R * nw) * 8;
  oks_scan_kernel<<<B, SCAN_THREADS, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), M, nw,
      R);
  return (int)cudaGetLastError();
}
