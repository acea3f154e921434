// das_tpu_torch native host runtime: the hot CPU paths of the data pipeline.
//
// The port's copy of the JAX package's host library, with the same three
// C functions and the same arithmetic: the training transforms' resize
// (Resize / ResizePose) and affine warp (GlobalRotScaleTransPose) of a
// float32 HxWx3 image, and the fused normalize + BGR->RGB + pad into a batch
// slot. Exposed through a C ABI consumed via ctypes
// (das_tpu_torch/datasets/native.py), which builds it at first use with
// g++ -O3 -march=native -fPIC -shared into build/das_tpu_torch/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Fused normalize + (optional BGR->RGB) + pad + copy into a batch slot.
//   src:  HxWx3 float32 (BGR, as decoded)
//   dst:  PHxPWx3 float32 batch slot, fully overwritten (pad = 0)
// Equivalent to pipelines.Normalize + Pad + loader copy in one pass.
void das_normalize_pad(const float* src, int h, int w,
                       float* dst, int ph, int pw,
                       const float* mean, const float* stdv, int to_rgb) {
    const float inv0 = 1.0f / stdv[0], inv1 = 1.0f / stdv[1],
                inv2 = 1.0f / stdv[2];
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    for (int y = 0; y < ph; ++y) {
        float* drow = dst + (size_t)y * pw * 3;
        if (y >= h) {
            std::memset(drow, 0, sizeof(float) * (size_t)pw * 3);
            continue;
        }
        const float* srow = src + (size_t)y * w * 3;
        if (to_rgb) {
            for (int x = 0; x < w; ++x) {
                drow[x * 3 + 0] = (srow[x * 3 + 2] - m0) * inv0;
                drow[x * 3 + 1] = (srow[x * 3 + 1] - m1) * inv1;
                drow[x * 3 + 2] = (srow[x * 3 + 0] - m2) * inv2;
            }
        } else {
            for (int x = 0; x < w; ++x) {
                drow[x * 3 + 0] = (srow[x * 3 + 0] - m0) * inv0;
                drow[x * 3 + 1] = (srow[x * 3 + 1] - m1) * inv1;
                drow[x * 3 + 2] = (srow[x * 3 + 2] - m2) * inv2;
            }
        }
        if (w < pw)
            std::memset(drow + (size_t)w * 3, 0,
                        sizeof(float) * (size_t)(pw - w) * 3);
    }
}

// cv2.warpAffine-compatible inverse-mapped bilinear warp with a constant
// border (ref transforms_3d.py:986 semantics). trans is the FORWARD 2x3
// affine (src -> dst); it is inverted here like cv2 does.
void das_affine_warp(const float* src, int h, int w,
                     const double* trans, float* dst, int oh, int ow,
                     const float* border) {
    double a = trans[0], b = trans[1], c = trans[2];
    double d = trans[3], e = trans[4], f = trans[5];
    double det = a * e - b * d;
    if (det == 0.0) det = 1e-12;
    double ia = e / det, ib = -b / det, id = -d / det, ie = a / det;

    for (int y = 0; y < oh; ++y) {
        float* drow = dst + (size_t)y * ow * 3;
        for (int x = 0; x < ow; ++x) {
            double dx = x - c, dy = y - f;
            double sx = ia * dx + ib * dy;
            double sy = id * dx + ie * dy;
            int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
            float wx1 = (float)(sx - x0), wy1 = (float)(sy - y0);
            float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
            float acc[3] = {0.f, 0.f, 0.f};
            const float ws[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1,
                                 wx1 * wy1};
            const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
            const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
            for (int k = 0; k < 4; ++k) {
                const float wk = ws[k];
                if (wk == 0.f) continue;
                if (xs[k] < 0 || xs[k] >= w || ys[k] < 0 || ys[k] >= h) {
                    acc[0] += wk * border[0];
                    acc[1] += wk * border[1];
                    acc[2] += wk * border[2];
                } else {
                    const float* p = src +
                        ((size_t)ys[k] * w + xs[k]) * 3;
                    acc[0] += wk * p[0];
                    acc[1] += wk * p[1];
                    acc[2] += wk * p[2];
                }
            }
            drow[x * 3 + 0] = acc[0];
            drow[x * 3 + 1] = acc[1];
            drow[x * 3 + 2] = acc[2];
        }
    }
}

// Keep-ratio bilinear resize (cv2.INTER_LINEAR half-pixel convention),
// float32 HWC3.
void das_resize_bilinear(const float* src, int h, int w,
                         float* dst, int oh, int ow) {
    const double sy_scale = (double)h / oh;
    const double sx_scale = (double)w / ow;
    for (int y = 0; y < oh; ++y) {
        double sy = (y + 0.5) * sy_scale - 0.5;
        int y0 = (int)std::floor(sy);
        float wy1 = (float)(sy - y0);
        int y0c = std::min(std::max(y0, 0), h - 1);
        int y1c = std::min(std::max(y0 + 1, 0), h - 1);
        float* drow = dst + (size_t)y * ow * 3;
        const float* r0 = src + (size_t)y0c * w * 3;
        const float* r1 = src + (size_t)y1c * w * 3;
        for (int x = 0; x < ow; ++x) {
            double sx = (x + 0.5) * sx_scale - 0.5;
            int x0 = (int)std::floor(sx);
            float wx1 = (float)(sx - x0);
            int x0c = std::min(std::max(x0, 0), w - 1);
            int x1c = std::min(std::max(x0 + 1, 0), w - 1);
            for (int ch = 0; ch < 3; ++ch) {
                float top = r0[x0c * 3 + ch] * (1 - wx1) +
                            r0[x1c * 3 + ch] * wx1;
                float bot = r1[x0c * 3 + ch] * (1 - wx1) +
                            r1[x1c * 3 + ch] * wx1;
                drow[x * 3 + ch] = top * (1 - wy1) + bot * wy1;
            }
        }
    }
}

}  // extern "C"
