"""2D pose drawing helpers for browse_dataset / visualize_results, the
port's copy of ``das_tpu/core/visualize.py`` (ref tools/misc/
browse_dataset.py, visualize_results.py — rebuilt for the DAS skeletons; the
reference's versions target the inherited point-cloud pipelines)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# panoptic-15 skeleton (joint order of CMUPanopticDataset)
SKELETON_15 = [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (0, 9), (9, 10),
               (10, 11), (2, 6), (6, 7), (7, 8), (2, 12), (12, 13),
               (13, 14)]
# muco-21 skeleton (first 17 = mpi-inf joint order)
SKELETON_21 = [(1, 0), (1, 16), (16, 15), (1, 2), (2, 3), (3, 4),
               (1, 5), (5, 6), (6, 7), (14, 8), (8, 9), (9, 10),
               (14, 11), (11, 12), (12, 13), (1, 15), (14, 15)]

_COLORS = [(66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
           (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36)]


def skeleton_for(num_joints: int) -> Sequence:
    return SKELETON_15 if num_joints <= 15 else SKELETON_21


def draw_pose_2d(img: np.ndarray, poses: np.ndarray,
                 vis: Optional[np.ndarray] = None,
                 scores: Optional[Sequence[float]] = None,
                 thickness: int = 2) -> np.ndarray:
    """Draw (P, J, >=2) poses onto a BGR uint8 image; returns a copy."""
    import cv2
    out = np.ascontiguousarray(img).copy()
    poses = np.asarray(poses)
    if poses.ndim == 2:
        poses = poses[None]
    skel = skeleton_for(poses.shape[1])
    for p, pose in enumerate(poses):
        color = _COLORS[p % len(_COLORS)]
        v = (np.ones(len(pose)) if vis is None
             else np.asarray(vis[p]).reshape(len(pose), -1)[:, 0])
        for a, b in skel:
            if a < len(pose) and b < len(pose) and v[a] > 0 and v[b] > 0:
                pa = tuple(np.round(pose[a, :2]).astype(int))
                pb = tuple(np.round(pose[b, :2]).astype(int))
                cv2.line(out, pa, pb, color, thickness, cv2.LINE_AA)
        for j, pt in enumerate(pose):
            if v[j] > 0:
                cv2.circle(out, tuple(np.round(pt[:2]).astype(int)),
                           thickness + 1, color, -1, cv2.LINE_AA)
        if scores is not None:
            anchor = pose[v > 0, :2].min(axis=0) if (v > 0).any() \
                else pose[0, :2]
            cv2.putText(out, f'{float(scores[p]):.2f}',
                        (int(anchor[0]), max(12, int(anchor[1]) - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                        cv2.LINE_AA)
    return out
