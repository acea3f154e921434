"""FCOS3D-style target assignment for the DAS head, port of
``das_tpu/core/targets.py`` (fixed shapes, the whole batch at once).

* per-level ``regress_ranges`` gate on the max visible joint-offset length,
* center sampling inside a ``radius*stride`` box around the root center,
* ambiguity resolved by the nearest root center (the first on a tie),
* centerness target ``exp(-alpha * dist / (1.414 * stride * radius))``,
* target layout ``[dx, dy, depth, duvd(3J), vis(J)]``, xy offsets divided
  by the level stride.

Ground truths arrive padded to a fixed G with a validity mask.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

INF = 1e8


def make_points(featmap_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int]) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """All-level points, their strides and per-point level id.

    Points follow the reference convention ``grid * stride + stride // 2``
    (ref das_head.py:269-279).
    """
    pts, strd, lvl = [], [], []
    for i, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        ys, xs = np.mgrid[0:h, 0:w]
        p = np.stack([xs.reshape(-1) * s, ys.reshape(-1) * s], -1) + s // 2
        pts.append(p.astype(np.float32))
        strd.append(np.full(h * w, s, np.float32))
        lvl.append(np.full(h * w, i, np.int32))
    return (np.concatenate(pts), np.concatenate(strd), np.concatenate(lvl))


def _assign(points, strides, rr, poses, centers2d, depths, valid,
            num_joints, radius, alpha, bg_label):
    """Per image and point (B, P): labels, pose targets, centerness."""
    B, G = poses.shape[:2]
    J = num_joints
    uvds = poses[..., 3:3 + 3 * J].reshape(B, G, J, 3)
    vis = poses[..., 3 + 3 * J:]                             # (B, G, J)
    # xy root-relative; z keeps the stored value (ref :584)
    duvd = torch.cat([uvds[..., :2] - poses[:, :, None, :2],
                      uvds[..., 2:]], dim=-1)
    # max visible joint-offset length per gt (ref :592)
    off_len = torch.sqrt((duvd[..., :2] ** 2).sum(-1)) * vis
    max_reg_dist = off_len.max(-1).values[:, None, :]        # (B, 1, G)

    dx = points[None, :, None, 0] - centers2d[:, None, :, 0]  # (B, P, G)
    dy = points[None, :, None, 1] - centers2d[:, None, :, 1]
    rs = strides[:, None] * radius                           # (P, 1)
    inside_cb = (dx.abs() < rs) & (dy.abs() < rs)
    inside_rr = (max_reg_dist >= rr[:, :1]) & (max_reg_dist <= rr[:, 1:2])
    dists = torch.sqrt(dx ** 2 + dy ** 2)
    dists = torch.where(inside_cb & inside_rr & valid[:, None, :], dists,
                        torch.full_like(dists, INF))
    min_dist, min_idx = dists.min(dim=2)                     # (B, P)

    labels = torch.where(min_dist < INF, 0, bg_label).to(torch.int32)

    def take(t):                                             # (B, G, c)
        return torch.gather(t, 1, min_idx[..., None].expand(
            B, min_idx.shape[1], t.shape[-1]))

    sel_dx = torch.gather(dx, 2, min_idx[..., None])[..., 0]
    sel_dy = torch.gather(dy, 2, min_idx[..., None])[..., 0]
    sel_depth = take(depths[..., None])
    sel_duvd = take(duvd.reshape(B, G, 3 * J))
    sel_vis = take(vis)
    inv_stride = (1.0 / strides)[None, :, None]
    pose_targets = torch.cat(
        [sel_dx[..., None] * inv_stride, sel_dy[..., None] * inv_stride,
         sel_depth, sel_duvd, sel_vis], dim=-1)              # (B, P, 3+4J)
    rel = torch.sqrt(sel_dx ** 2 + sel_dy ** 2) / (1.414 * rs[:, 0])
    return labels, pose_targets, torch.exp(-alpha * rel)


def get_targets(featmap_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int],
                regress_ranges: Sequence[Tuple[float, float]],
                gt_poses_3d: torch.Tensor,       # (B, G, 3 + 4J)
                gt_centers2d: torch.Tensor,      # (B, G, 2)
                gt_depths: torch.Tensor,         # (B, G)
                gt_valid: torch.Tensor,          # (B, G) bool
                num_joints: int,
                center_sample_radius: float = 1.5,
                centerness_alpha: float = 2.5,
                bg_label: int = 1) -> Dict[str, torch.Tensor]:
    """Batched assignment on the GTs' device. Returns flat tensors ordered
    level-major and, within a level, image-major, as the head flattens its
    predictions."""
    dev = gt_poses_3d.device
    pts_np, strd_np, lvl_np = make_points(featmap_sizes, strides)
    points = torch.from_numpy(pts_np).to(dev)
    strd = torch.from_numpy(strd_np).to(dev)
    rr = torch.from_numpy(
        np.asarray(regress_ranges, np.float32)[lvl_np]).to(dev)
    labels, pose_t, ctr_t = _assign(
        points, strd, rr, gt_poses_3d.float(), gt_centers2d.float(),
        gt_depths.float(), gt_valid.bool(), num_joints,
        center_sample_radius, centerness_alpha, bg_label)
    B = labels.shape[0]
    out = dict(labels=[], pose_targets=[], centerness_targets=[], strides=[])
    begin = 0
    for (h, w), s in zip(featmap_sizes, strides):
        sl = slice(begin, begin + h * w)
        out['labels'].append(labels[:, sl].reshape(-1))
        out['pose_targets'].append(
            pose_t[:, sl].reshape(-1, pose_t.shape[-1]))
        out['centerness_targets'].append(ctr_t[:, sl].reshape(-1))
        out['strides'].append(torch.full((B * h * w,), float(s),
                                         dtype=torch.float32, device=dev))
        begin += h * w
    return {k: torch.cat(v) for k, v in out.items()}
