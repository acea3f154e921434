"""Fused multi-person decode, port of ``das_tpu/core/decode.py``.

Per-level sigmoid and ``nms_pre`` top-k by score*centerness, root/joint
reconstruction, test-scale unwarp, score filtering and greedy OKS-NMS, all
with fixed shapes and on the device of the inputs. The JAX ``vmap`` over
images is a batch dimension here; nothing syncs with the host.

Conventions kept from the reference (das_head.py:653-796): the root xy
for joint reconstruction is the grid point itself, depth is scaled by
sqrt(sx*sy), xy are divided by the test scale factor, joint visibility is
forced to 1, and hard OKS-NMS at ``nms_thr`` keeps ``nms_post`` in score
order.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..ops.oks_nms import default_sigmas, oks_nms_fixed, soft_oks_nms_fixed
from .targets import make_points


def decode_single_image(cls_scores: Sequence[torch.Tensor],
                        pose_preds: Sequence[torch.Tensor],
                        centernesses: Sequence[torch.Tensor],
                        points: Sequence[torch.Tensor],
                        scale_factor: torch.Tensor,
                        num_joints: int,
                        nms_pre: int = 1000,
                        nms_post: int = 100,
                        nms_thr: float = 0.9,
                        score_thr: float = 0.07,
                        nms_type: str = 'hard') -> Dict[str, torch.Tensor]:
    """Decode one image: level tensors (H, W, C), scale_factor (2,)."""
    out = _decode(
        [c[None] for c in cls_scores], [p[None] for p in pose_preds],
        [c[None] for c in centernesses], points, scale_factor[None],
        num_joints, nms_pre, nms_post, nms_thr, score_thr, nms_type)
    return {k: v[0] for k, v in out.items()}


def _decode(cls_scores, pose_preds, centernesses, points, scale_factors,
            num_joints, nms_pre, nms_post, nms_thr, score_thr, nms_type):
    """Batched decode: level tensors (N, H, W, C), scale_factors (N, 2)."""
    J = num_joints
    N = cls_scores[0].shape[0]
    dev = cls_scores[0].device
    sf = scale_factors.float().to(dev)
    sx, sy = sf[:, 0:1], sf[:, 1:2]                          # (N, 1)
    depth_scale = torch.sqrt(sx * sy)
    mlvl_scores, mlvl_ctr, mlvl_poses, mlvl_centers = [], [], [], []

    for cls, pose, ctr, pts in zip(cls_scores, pose_preds, centernesses,
                                   points):
        scores = torch.sigmoid(cls.reshape(N, -1))
        ctrness = torch.sigmoid(ctr.reshape(N, -1))
        pp = pose.reshape(N, -1, pose.shape[-1]).float()
        pts = pts.to(dev).expand(N, -1, -1)
        if scores.shape[1] > nms_pre:
            ranked = scores * ctrness
            topk = torch.topk(ranked, nms_pre, dim=1).indices
            nidx = torch.arange(N, device=dev)[:, None]
            scores, ctrness = scores[nidx, topk], ctrness[nidx, topk]
            pp, pts = pp[nidx, topk], pts[nidx, topk]

        root2d = pts - pp[..., :2]
        depth = pp[..., 2] * depth_scale
        center2d = torch.stack(
            [root2d[..., 0] / sx, root2d[..., 1] / sy, depth], dim=-1)

        joints = pp[..., 3:3 + 3 * J].reshape(N, -1, J, 3)
        # roots for joint reconstruction: xy = grid point (ref :734-735)
        roots = torch.cat([pts, depth[..., None]], dim=-1)[:, :, None, :]
        joints = joints + roots
        joints = torch.stack(
            [joints[..., 0] * (1.0 / sx[..., None]),
             joints[..., 1] * (1.0 / sy[..., None]), joints[..., 2]], dim=-1)

        mlvl_scores.append(scores)
        mlvl_ctr.append(ctrness)
        mlvl_poses.append(joints)
        mlvl_centers.append(center2d)

    scores = torch.cat(mlvl_scores, dim=1)
    ctrness = torch.cat(mlvl_ctr, dim=1)
    poses = torch.cat(mlvl_poses, dim=1)
    centers = torch.cat(mlvl_centers, dim=1)

    nms_scores = scores * ctrness
    valid = nms_scores > score_thr
    # every above-threshold candidate of every level enters NMS (up to
    # nms_pre per level, ref das_head.py:763-783)
    xy = poses[..., :2]
    areas = (xy[..., 0].amax(-1) - xy[..., 0].amin(-1)) * \
        (xy[..., 1].amax(-1) - xy[..., 1].amin(-1))
    sig = default_sigmas(J)
    if nms_type == 'soft':
        gather, out_valid = soft_oks_nms_fixed(
            xy, nms_scores, areas, valid, nms_thr, nms_post, sig)
    elif nms_type == 'hard':
        gather, out_valid = oks_nms_fixed(
            xy, nms_scores, areas, valid, nms_thr, sig, max_dets=nms_post)
    else:
        raise ValueError(f'unsupported nms_type {nms_type!r} '
                         "(expected 'hard' or 'soft')")
    nidx = torch.arange(N, device=dev)[:, None]
    return dict(
        scores=torch.where(out_valid, nms_scores[nidx, gather],
                           torch.zeros_like(nms_scores[nidx, gather])),
        poses=poses[nidx, gather],
        centers=centers[nidx, gather],
        vis=torch.ones((N, nms_post, J), dtype=torch.float32, device=dev),
        valid=out_valid)


def decode_batch(cls_scores, pose_preds, centernesses, strides,
                 scale_factors, num_joints, test_cfg):
    """Decode a batch: level tensors are (N, H, W, C)."""
    featmap_sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    pts_np, _, _ = make_points(featmap_sizes, strides)
    points, begin = [], 0
    for (h, w) in featmap_sizes:
        points.append(torch.from_numpy(pts_np[begin:begin + h * w]))
        begin += h * w
    return _decode(
        cls_scores, pose_preds, centernesses, points,
        torch.as_tensor(scale_factors), num_joints,
        nms_pre=int(test_cfg.get('nms_pre', 1000)),
        nms_post=int(test_cfg.get('nms_post', 100)),
        nms_thr=float(test_cfg.get('nms_thr', 0.9)),
        score_thr=float(test_cfg.get('score_thr', 0.07)),
        nms_type=str(test_cfg.get('nms_type', 'hard')))
