"""OKS (object-keypoint-similarity) NMS, port of ``das_tpu/ops/oks_nms.py``.

Fixed-shape greedy NMS for the fused decode: each of ``max_dets`` rounds is
one argmax over the live candidates and one OKS row against the pick, run
for exactly ``max_dets`` rounds with no host sync (a round after every
candidate is gone only writes -1, so the result is that of the JAX
``while_loop``, which stops early). The functions take one image's
candidates, or a batch of images along a leading dimension.
"""

from __future__ import annotations

import numpy as np
import torch

COCO17_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
    .87, .87, .89, .89
]) / 10.0


def default_sigmas(num_joints: int) -> np.ndarray:
    """Per-joint OKS sigmas (ref: pose_nms.py:65-72)."""
    if num_joints == 17:
        return COCO17_SIGMAS.copy()
    return np.ones(num_joints, dtype=np.float64) * 0.08


def oks_row(kpt: torch.Tensor, kpts: torch.Tensor, area, areas: torch.Tensor,
            sigmas: torch.Tensor) -> torch.Tensor:
    """OKS of one pose against all poses (ref ``oks_iou`` pose_nms.py:51).

    Args: kpt (..., J, 2) query; kpts (..., M, J, 2); area (...);
    areas (..., M); sigmas (J,). Returns (..., M).
    """
    variances = (2.0 * sigmas) ** 2
    d2 = ((kpts - kpt.unsqueeze(-3)) ** 2).sum(-1)             # (..., M, J)
    scale = (torch.as_tensor(area).unsqueeze(-1) + areas) / 2.0 \
        + float(np.spacing(1))
    e = d2 / variances / scale.unsqueeze(-1) / 2.0
    return torch.exp(-e).mean(-1)


def _batched(fn):
    """Run ``fn`` on (B, M, ...) inputs; accept one image's (M, ...)."""
    def wrapper(kpts, scores, areas, valid, *args, **kwargs):
        if kpts.dim() == 3:
            idx, ok = fn(kpts[None], scores[None], areas[None], valid[None],
                         *args, **kwargs)
            return idx[0], ok[0]
        return fn(kpts, scores, areas, valid, *args, **kwargs)
    wrapper.__doc__ = fn.__doc__
    wrapper.__name__ = fn.__name__
    return wrapper


def _pick(kpts, areas, s, order, k):
    """Argmax of ``s`` per image; writes the pick (or -1) at round k."""
    B = s.shape[0]
    bidx = torch.arange(B, device=s.device)
    i = s.argmax(-1)                                           # (B,)
    ok = s[bidx, i] > -torch.inf
    order[:, k] = torch.where(ok, i, torch.full_like(i, -1))
    return i, kpts[bidx, i], areas[bidx, i]


@_batched
def oks_nms_fixed(kpts: torch.Tensor, scores: torch.Tensor,
                  areas: torch.Tensor, valid: torch.Tensor, thr: float,
                  sigmas: np.ndarray, max_dets: int = None):
    """Greedy hard OKS-NMS over a fixed-size candidate set.

    Repeatedly picks the highest-scoring live candidate and suppresses
    everything with OKS > thr against it (ref pose_nms.py:92-126). Ties go
    to the lowest index. Candidates need not be sorted. Returns
    ``(gather_idx, out_valid)`` of length ``max_dets`` in greedy order.
    """
    B, M = scores.shape
    if max_dets is None:
        max_dets = M
    sig = torch.as_tensor(sigmas, dtype=torch.float32, device=kpts.device)
    neg = torch.full_like(scores, -torch.inf, dtype=torch.float32)
    s = torch.where(valid, scores.float(), neg)
    idx = torch.arange(M, device=kpts.device)
    order = torch.full((B, max_dets), -1, dtype=torch.long,
                       device=kpts.device)
    alive = valid.clone()
    for k in range(max_dets):
        sa = torch.where(alive, s, neg)
        i, kpt, area = _pick(kpts, areas, sa, order, k)
        row = oks_row(kpt, kpts, area, areas, sig)
        alive = alive & (row <= thr) & (idx != i[:, None])
    out_valid = order >= 0
    return torch.where(out_valid, order, 0), out_valid


@_batched
def soft_oks_nms_fixed(kpts: torch.Tensor, scores: torch.Tensor,
                       areas: torch.Tensor, valid: torch.Tensor, thr: float,
                       max_dets: int, sigmas: np.ndarray):
    """Soft OKS-NMS with gaussian rescoring (ref pose_nms.py:153-195):
    each round picks the argmax of the decayed scores and decays the rest
    by ``exp(-oks^2 / thr)`` against the pick. Returns ``(gather_idx,
    out_valid)`` of length ``max_dets`` in selection order."""
    B, M = scores.shape
    sig = torch.as_tensor(sigmas, dtype=torch.float32, device=kpts.device)
    s = torch.where(valid, scores.float(),
                    torch.full_like(scores, -torch.inf, dtype=torch.float32))
    order = torch.full((B, max_dets), -1, dtype=torch.long,
                       device=kpts.device)
    bidx = torch.arange(B, device=kpts.device)
    for k in range(max_dets):
        i, kpt, area = _pick(kpts, areas, s, order, k)
        row = oks_row(kpt, kpts, area, areas, sig)
        s = s * torch.exp(-(row ** 2) / thr)
        s[bidx, i] = -torch.inf
    out_valid = order >= 0
    return torch.where(out_valid, order, 0), out_valid
