"""The reference decode: per level the ``nms_pre`` best candidates by
sigmoid(cls) * sigmoid(ctr), root and joint reconstruction at the grid
point (the DAS convention, points at ``i * stride + stride // 2`` for the
config's strides), the test scale undone, the score threshold, and a
plain greedy OKS-NMS that repeatedly keeps the best live candidate and
drops every candidate whose OKS with it exceeds ``nms_thr``, up to
``nms_post``. Computed in the stage's precision (float32; the control:
bfloat16)."""

from __future__ import annotations

from typing import Dict, List

import torch

from .precision import current


def level_points(h: int, w: int, stride: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing='ij')
    return torch.stack([xs.reshape(-1) * stride, ys.reshape(-1) * stride],
                       -1).float() + stride // 2


def candidates(levels: List[Dict], strides, scale_factors: torch.Tensor,
               J: int, nms_pre: int) -> Dict[str, torch.Tensor]:
    """The candidate set: scores (N, M), poses (N, M, J, 3) and centers
    (N, M, 3), M = sum over levels of min(nms_pre, points)."""
    dt = current().decode
    sf = scale_factors.to(dt)
    sx, sy = sf[:, 0:1], sf[:, 1:2]
    depth_scale = torch.sqrt(sx * sy)
    scores, poses, centers = [], [], []
    for f, s in zip(levels, strides):
        N, H, W, _ = f['cls'].shape
        cls = torch.sigmoid(f['cls'].to(dt).reshape(N, -1))
        ctr = torch.sigmoid(f['ctr'].to(dt).reshape(N, -1))
        pose = f['pose'].to(dt).reshape(N, H * W, -1)
        pts = level_points(H, W, s, cls.device).to(dt).expand(N, -1, -1)
        if H * W > nms_pre:
            idx = torch.topk(cls * ctr, nms_pre, dim=1).indices
            take = idx[..., None]
            cls, ctr = cls.gather(1, idx), ctr.gather(1, idx)
            pose = pose.gather(1, take.expand(-1, -1, pose.shape[-1]))
            pts = pts.gather(1, take.expand(-1, -1, 2))
        root = pts - pose[..., :2]
        depth = pose[..., 2] * depth_scale
        centers.append(torch.stack([root[..., 0] / sx, root[..., 1] / sy,
                                    depth], -1))
        joints = pose[..., 3:3 + 3 * J].reshape(N, -1, J, 3) + torch.cat(
            [pts, depth[..., None]], -1)[:, :, None]
        poses.append(torch.stack([joints[..., 0] / sx[..., None],
                                  joints[..., 1] / sy[..., None],
                                  joints[..., 2]], -1))
        scores.append(cls * ctr)
    return dict(scores=torch.cat(scores, 1), poses=torch.cat(poses, 1),
                centers=torch.cat(centers, 1))


def oks_nms(xy: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            thr: float, keep_max: int) -> List[List[int]]:
    """Greedy OKS-NMS of one image's candidates: xy (M, J, 2); ties go to
    the lower index. Returns the kept indices in order."""
    J = xy.shape[1]
    var = (2 * 0.08) ** 2 if J != 17 else None
    if var is None:
        raise ValueError('COCO-17 sigmas are outside these configurations')
    area = (xy[..., 0].amax(-1) - xy[..., 0].amin(-1)) * \
        (xy[..., 1].amax(-1) - xy[..., 1].amin(-1))
    s = torch.where(valid, scores, torch.full_like(scores, -float('inf')))
    alive = valid.clone()
    kept = []
    eps = torch.finfo(torch.float64).eps
    while len(kept) < keep_max and bool(alive.any()):
        live = torch.where(alive, s, torch.full_like(s, -float('inf')))
        i = int(torch.argmax(live))
        kept.append(i)
        d2 = ((xy - xy[i]) ** 2).sum(-1)                         # (M, J)
        scale = (area + area[i]) / 2 + eps
        oks = torch.exp(-d2 / (2 * var) / scale[:, None]).mean(-1)
        alive &= oks <= thr
        alive[i] = False
    return kept


def decode(levels: List[Dict], strides, scale_factors, J: int,
           test_cfg: Dict) -> List[Dict[str, torch.Tensor]]:
    """Each image's people: scores (K,), poses (K, J, 3), centers (K, 3)
    in NMS order. ``levels`` hold 'cls', 'ctr' and 'pose' ([offset,
    depth, uvd, sigma], the eval head's layout) a level, NHWC."""
    c = candidates(levels, strides, scale_factors, J,
                   int(test_cfg.get('nms_pre', 1000)))
    out = []
    for b in range(c['scores'].shape[0]):
        sc = c['scores'][b]
        valid = sc > float(test_cfg.get('score_thr', 0.07))
        kept = oks_nms(c['poses'][b, ..., :2], sc, valid,
                       float(test_cfg.get('nms_thr', 0.9)),
                       int(test_cfg.get('nms_post', 100)))
        k = torch.tensor(kept, dtype=torch.long, device=sc.device)
        out.append(dict(scores=sc[k], poses=c['poses'][b][k],
                        centers=c['centers'][b][k]))
    return out
