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
// version's, with true divisions and no fused multiply-add, so sim has the
// plain version's bits wherever expf does. With max_keep the scan stops
// once that many are kept and the rest are not kept.
//
// What bounds it on an H100: two things that no count of bytes sees (the
// inputs are a few MB). (1) The pairwise similarities on the CUDA cores:
// per joint per pair two IEEE divisions and an expf, ~35 instructions, over
// M^2 / 2 pairs per image. (2) The greedy scan: a chain of M dependent
// decisions, whose cost is latency.
//
// Design (torchvision's NMS scheme with OKS in place of IoU; the TPU kernel
// built the whole M x M similarity matrix in VMEM, 55 MB at M = 3720, then
// scanned it row by row):
//   1. oks_mask_kernel: one 256-thread block per 64 x 64 tile on or below
//      the diagonal (a triangular grid; nothing is launched or written
//      above it, and the scan never reads there). Four threads share a row
//      and take its 64 columns interleaved, so neighbouring lanes read
//      neighbouring shared-memory rows; the four 16-bit pieces of the word
//      sim > thr are joined by shuffles and stored as one uint64: an
//      M x ceil(M/64) bit matrix per image (1.7 MB at M = 3720). Shared
//      memory is sized by J (16 KB at J = 15), so an SM holds 8 blocks, 64
//      warps, to hide the divisions. A pair stops early once even J - k
//      further terms of 1 could not lift its mean above thr (with a margin
//      of 0.01 on the sum, far above the rounding of J additions): the bit
//      is 0 either way, so the word keeps the plain version's bits, and
//      most pairs of a request (poses far apart) stop after two joints.
//   2. oks_scan_kernel: one block per image walks the 64-row blocks in
//      order. Per block c: (A) all 256 threads, four a row, OR
//      mask[i][w] & kept[w] over the words w < c from shared memory; (B)
//      warp 0 resolves the 64 x 64 diagonal block in registers: 64 unrolled
//      steps of ok = pre[r] & !(d[r] & kept_c); kept_c |= ok << r, with
//      pre = valid & !hitA as one 64-bit word, and writes keep for the 64
//      rows at once; meanwhile warps 1-7 stage the words w <= c + 1 of
//      block c + 1 into the other half of a double buffer. The dependent
//      chain is ceil(M/64) x (two barriers + 64 register steps) instead of
//      M steps with memory in them.
// Shared memory of the scan: kept[NW] words, two buffers of 64 rows of NW | 1
// words (60 KB at M = 3720; the odd stride keeps (A) free of bank
// conflicts), filled by cp.async, and 64 hit bytes.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TB = 64;          // rows and columns per block: one bit word
constexpr int JMAX = 32;        // joints the kernel takes
constexpr int MASK_THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_SMEM_MAX = 200 * 1024;
constexpr float EXIT_MARGIN = 0.01f;

using u64 = unsigned long long;

__global__ void __launch_bounds__(MASK_THREADS)
oks_mask_kernel(const float* __restrict__ kpts,     // (B, M, J, 2)
                const float* __restrict__ areas,    // (B, M)
                const float* __restrict__ var2,     // (J,) 2 * (2 sigma)^2
                u64* __restrict__ mask,             // (B, M, NW)
                int M, int J, int NW, float thr, float eps) {
  // tile (rb, cb), cb <= rb, from the triangular index
  const int tri = blockIdx.x, b = blockIdx.y;
  int rb = (int)((sqrtf(8.f * (float)tri + 1.f) - 1.f) * 0.5f);
  while ((rb + 1) * (rb + 2) / 2 <= tri) ++rb;
  while (rb * (rb + 1) / 2 > tri) --rb;
  const int cb = tri - rb * (rb + 1) / 2;

  extern __shared__ float sm[];
  const int JS = J | 1;                   // odd stride: no bank conflicts
  float* xr = sm;                         // [J][TB] this block's rows
  float* yr = xr + J * TB;
  float* xc = yr + J * TB;                // [TB][JS] its columns
  float* yc = xc + TB * JS;
  float* ac = yc + TB * JS;               // [TB]
  float* v2 = ac + TB;                    // [J]

  const int t = threadIdx.x;
  const int i0 = rb * TB, j0 = cb * TB;
  const float2* kb = reinterpret_cast<const float2*>(kpts) + (size_t)b * M * J;
  // rows i0.. and columns j0.. are each TB * J consecutive (x, y) pairs
  for (int e = t; e < TB * J; e += MASK_THREADS) {
    const int q = e / J, k = e - q * J;
    const float2 r = i0 + q < M ? kb[(size_t)i0 * J + e] : make_float2(0, 0);
    const float2 c = j0 + q < M ? kb[(size_t)j0 * J + e] : make_float2(0, 0);
    xr[k * TB + q] = r.x;
    yr[k * TB + q] = r.y;
    xc[q * JS + k] = c.x;
    yc[q * JS + k] = c.y;
  }
  if (t < TB) ac[t] = j0 + t < M ? areas[(size_t)b * M + j0 + t] : 0.f;
  if (t < J) v2[t] = var2[t];
  __syncthreads();

  const int row = t / 4, part = t % 4;
  const int i = i0 + row;
  const float ai = i < M ? areas[(size_t)b * M + i] : 0.f;
  const float fj = (float)J;
  // a pair whose sum cannot reach `need` cannot have mean > thr
  const float need = thr * fj - EXIT_MARGIN;
  const int jn = min(TB, i - j0);           // columns j0 .. j0+jn-1 are < i
  u64 word = 0ull;
  if (i < M) {
    for (int q = part; q < jn; q += 4) {
      const float scale =
          __fadd_rn(__fmul_rn(__fadd_rn(ai, ac[q]), 0.5f), eps);
      float acc = 0.f;
      int k = 0;
      for (; k < J; ++k) {
        const float dx = __fsub_rn(xr[k * TB + row], xc[q * JS + k]);
        const float dy = __fsub_rn(yr[k * TB + row], yc[q * JS + k]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        acc = __fadd_rn(acc, expf(__fdiv_rn(__fdiv_rn(-d2, v2[k]), scale)));
        if (acc + (float)(J - 1 - k) < need) break;
      }
      if (k == J && __fdiv_rn(acc, fj) > thr) word |= 1ull << q;
    }
  }
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  if (part == 0 && i < M) mask[((size_t)b * M + i) * NW + cb] = word;
}

// Stage the words 0 .. c of the rows of block c (zeros past row M) into buf,
// rows RS words apart, with asynchronous copies: all in flight at once.
__device__ __forceinline__ void stage_block(u64* buf, const u64* mb, int c,
                                            int M, int NW, int RS, int tid,
                                            int nthreads) {
  const int nwc = c + 1;
  for (int e = tid; e < TB * nwc; e += nthreads) {
    const int r = e / nwc, w = e - r * nwc;
    const int i = c * TB + r;
    if (i < M) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       static_cast<uint32_t>(
                           __cvta_generic_to_shared(buf + r * RS + w))),
                   "l"(mb + (size_t)i * NW + w)
                   : "memory");
    } else {
      buf[r * RS + w] = 0ull;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(SCAN_THREADS)
oks_scan_kernel(const u64* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int M, int NW, int max_keep) {
  extern __shared__ u64 smw[];
  __shared__ int full;                        // max_keep are kept
  const int RS = NW | 1;                      // odd row stride, in words
  u64* kept = smw;                            // NW words: the kept set
  u64* bufs = smw + NW;                       // two of TB x RS words
  uint8_t* hit = reinterpret_cast<uint8_t*>(smw + NW + 2 * (size_t)TB * RS);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const u64* mb = mask + (size_t)b * M * NW;
  const uint8_t* vb = valid + (size_t)b * M;
  uint8_t* kb = keep + (size_t)b * M;
  stage_block(bufs, mb, 0, M, NW, RS, tid, SCAN_THREADS);
  int count = 0;                              // kept so far (warp 0)
  __syncthreads();
  for (int c = 0; c < NW; ++c) {
    const u64* cur = bufs + (c % 2) * TB * RS;
    const int i0 = c * TB;
    // warp 0's lanes hold valid of rows lane and lane + 32 of the block
    bool va = false, vb2 = false;
    if (warp == 0) {
      va = i0 + lane < M && vb[i0 + lane];
      vb2 = i0 + lane + 32 < M && vb[i0 + lane + 32];
    }
    {  // (A): four threads a row OR the words below the diagonal block
      const int r = tid / 4, part = tid % 4;
      bool h = false;
      for (int w = part; w < c; w += 4)
        h |= (cur[r * RS + w] & kept[w]) != 0ull;
      h |= __shfl_xor_sync(0xffffffffu, h, 1) != 0;
      h |= __shfl_xor_sync(0xffffffffu, h, 2) != 0;
      if (part == 0) hit[r] = h;
    }
    __syncthreads();
    if (warp == 0) {
      // (B): the diagonal block, every lane the same 64 register steps
      const uint32_t lo = __ballot_sync(0xffffffffu, va && !hit[lane]);
      const uint32_t hi = __ballot_sync(0xffffffffu, vb2 && !hit[lane + 32]);
      const u64 pre = (u64)hi << 32 | lo;
      u64 kc = 0ull;
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const u64 d = cur[r * RS + c];
        const bool ok = (pre >> r & 1ull) && (d & kc) == 0ull;
        kc |= (u64)ok << r;
      }
      if (max_keep >= 0 && count + __popcll(kc) > max_keep) {
        // keep the first max_keep - count of them only
        u64 first = 0ull;
        for (int left = max_keep - count; left > 0; --left) {
          const u64 low = kc & (~kc + 1ull);
          first |= low;
          kc ^= low;
        }
        kc = first;
      }
      count += __popcll(kc);
      if (lane == 0) {
        kept[c] = kc;
        full = max_keep >= 0 && count >= max_keep;
      }
      if (i0 + lane < M) kb[i0 + lane] = kc >> lane & 1ull;
      if (i0 + lane + 32 < M) kb[i0 + lane + 32] = kc >> (lane + 32) & 1ull;
    } else if (c + 1 < NW) {
      stage_block(bufs + ((c + 1) % 2) * TB * RS, mb, c + 1, M, NW, RS,
                  tid - 32, SCAN_THREADS - 32);
    }
    __syncthreads();
    if (full) {       // the rest are not kept
      for (int i = (c + 1) * TB + tid; i < M; i += SCAN_THREADS) kb[i] = 0;
      return;
    }
  }
}

size_t scan_smem_bytes(int nw) {
  return ((size_t)nw + 2 * (size_t)TB * (nw | 1)) * 8 + TB;
}

size_t mask_smem_bytes(int J) {
  return (size_t)(2 * J * TB + 2 * TB * (J | 1) + TB + J) * 4;
}

}  // namespace

// The most candidates the scan's shared memory takes.
extern "C" int oks_nms_max_candidates() {
  int nw = 1;
  while (scan_smem_bytes(nw + 1) <= SCAN_SMEM_MAX) ++nw;
  return nw * TB;
}

// kpts (B,M,J,2), areas (B,M), var2 (J,) f32; valid (B,M) bool; scratch
// mask (B, M, ceil(M/64)) uint64 (only words on or below the diagonal block
// are written and read); keep (B,M) bool. max_keep < 0: no limit. All
// contiguous, on the device; J <= 32. Returns cudaGetLastError() after the
// first launch that fails, or after the last; cudaErrorInvalidValue if M or
// J is too large.
extern "C" int oks_nms_keep_forward(const void* kpts, const void* areas,
                                    const void* var2, const void* valid,
                                    void* mask, void* keep, int B, int M,
                                    int J, float thr, float eps, int max_keep,
                                    void* stream) {
  if (B == 0 || M == 0) return 0;
  if (J > JMAX || J < 1 || M > oks_nms_max_candidates())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nw = (M + TB - 1) / TB;
  const size_t scan_smem = scan_smem_bytes(nw);
  // above 48 KB a kernel has to be allowed its shared memory; the
  // attribute belongs to the current device, so it is set at every launch
  const cudaError_t allowed = cudaFuncSetAttribute(
      oks_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SCAN_SMEM_MAX);
  if (allowed != cudaSuccess) return (int)allowed;
  oks_mask_kernel<<<dim3(nw * (nw + 1) / 2, B), MASK_THREADS,
                    mask_smem_bytes(J), s>>>(
      static_cast<const float*>(kpts), static_cast<const float*>(areas),
      static_cast<const float*>(var2), static_cast<u64*>(mask), M, J, nw, thr,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oks_scan_kernel<<<B, SCAN_THREADS, scan_smem, s>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), M, nw, max_keep);
  return (int)cudaGetLastError();
}
