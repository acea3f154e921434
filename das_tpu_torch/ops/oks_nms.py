"""OKS (object-keypoint-similarity) NMS, port of ``das_tpu/ops/oks_nms.py``
and of ``das_tpu/ops/pallas_nms.py``.

``oks_nms_fixed`` and ``soft_oks_nms_fixed`` are the ports of the JAX
functions: fixed-shape greedy NMS, each of ``max_dets`` rounds one argmax
over the live candidates and one OKS row against the pick, run for exactly
``max_dets`` rounds with no host sync (a round after every candidate is
gone only writes -1, so the result is that of the JAX ``while_loop``, which
stops early). The functions take one image's candidates, or a batch of
images along a leading dimension.

``oks_nms_keep`` is the counterpart of the Pallas kernel
``oks_nms_pallas``: the keep mask of greedy hard OKS-NMS over candidates
already sorted by score. On a CUDA tensor it launches the hand-written
kernel (``das_tpu_torch/csrc/oks_nms.cu``) or raises; on a CPU tensor it
runs the plain version, ``oks_nms_keep_plain``.

``oks_nms_sorted`` is what the decode calls for hard NMS. It has
``oks_nms_fixed``'s contract and result: a stable sort by score, one
``oks_nms_keep`` over the sorted candidates, and the first ``max_dets``
kept mapped back through the sort order, with no host sync and no round
per detection. Greedy NMS that takes the best live candidate each round
and one ordered scan over score-sorted candidates keep the same set in the
same order. One difference is kept on purpose: ``oks_row`` and the kernel
form the similarity in another expression order, so a pair whose
similarity lies within an ulp or two of the threshold can fall on the
other side (the JAX package has the same difference between
``oks_nms_fixed`` and ``oks_nms_pallas``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda_build import (FLOAT, INT, PTR, CudaLibrary, check_launch,
                         check_tensor)

LIB = CudaLibrary('oks_nms.cu', {
    'oks_nms_max_candidates': [],
    'oks_nms_keep_forward': [PTR] * 6 + [INT] * 3 + [FLOAT, FLOAT, INT,
                                                     PTR]})

# Kernel launches since the last reset (one per ``oks_nms_keep`` call on a
# CUDA tensor: its mask and scan kernels together); the main path's run
# reads it.
launches = 0
EPS = float(np.spacing(1))
# The kernel's limits: the candidates whose mask rows the scan's shared
# memory holds (``oks_nms_max_candidates()`` of oks_nms.cu, held equal to
# this by the card tests) and the joints (its JMAX)
MAX_CANDIDATES = 12608
MAX_JOINTS = 32

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
    scale = (torch.as_tensor(area).unsqueeze(-1) + areas) / 2.0 + EPS
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


_VAR2 = {}


def _nms_var2(sigmas: np.ndarray, device) -> torch.Tensor:
    """2 * (2 sigma)^2 per joint, formed in double and stored in f32, as
    the Pallas kernel's ``float(variances[k]) * 2.0`` constants. Kept per
    (sigmas, device), so that a request copies nothing from the host."""
    key = (tuple(float(v) for v in sigmas), str(device))
    if key not in _VAR2:
        var2 = ((np.asarray(sigmas, np.float64) * 2.0) ** 2) * 2.0
        _VAR2[key] = torch.tensor(var2, dtype=torch.float32, device=device)
    return _VAR2[key]


def oks_nms_keep_plain(kpts: torch.Tensor, areas: torch.Tensor,
                       valid: torch.Tensor, thr: float, sigmas: np.ndarray,
                       max_keep: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``oks_nms_keep`` (the Pallas kernel's
    semantics and expression order).

    sim(i, j) = sum_k exp(-d2_k / (2 var_k) / scale), summed over the joints
    in order and divided by J, with scale = (a_i + a_j) * 0.5 + eps; then
    the greedy scan in order: i is kept iff ``valid[i]`` and no kept j < i
    has sim(i, j) > thr. Every divisor is a tensor, so the division is a
    true division on the card too (a Python scalar divisor may become a
    multiply by its reciprocal there). With ``max_keep`` only the first
    ``max_keep`` kept stay kept. Shapes as ``oks_nms_keep``.
    """
    if kpts.dim() == 3:
        return oks_nms_keep_plain(kpts[None], areas[None], valid[None], thr,
                                  sigmas, max_keep)[0]
    B, M, J, _ = kpts.shape
    dev = kpts.device
    var2 = _nms_var2(sigmas, dev)
    x, y = kpts[..., 0].float(), kpts[..., 1].float()          # (B, M, J)
    a = areas.float()
    scale = (a[:, :, None] + a[:, None, :]) * 0.5 + EPS          # (B, M, M)
    acc = torch.zeros((B, M, M), dtype=torch.float32, device=dev)
    for k in range(J):
        dx = x[:, :, None, k] - x[:, None, :, k]
        dy = y[:, :, None, k] - y[:, None, :, k]
        d2 = dx * dx + dy * dy
        acc = acc + torch.exp(-d2 / var2[k] / scale)
    sim = acc / torch.tensor(float(J), device=dev)
    supp = (sim > thr).tril(-1)                   # (i, j): j < i suppresses
    keep = torch.zeros((B, M), dtype=torch.bool, device=dev)
    for i in range(M):
        keep[:, i] = valid[:, i] & ~(supp[:, i] & keep).any(-1)
    if max_keep is not None:
        keep = keep & (keep.cumsum(-1) <= max_keep)
    return keep


def check_kernel_limits(M: int, J: int, n_sigmas: int) -> None:
    """Raise unless the kernel takes M candidates of J joints with one
    sigma each: at most ``MAX_CANDIDATES`` and ``MAX_JOINTS``. The plain
    version, on the CPU, has no such limit."""
    if n_sigmas != J or not 1 <= J <= MAX_JOINTS:
        raise ValueError(f'the kernel takes 1..{MAX_JOINTS} joints with one '
                         f'sigma each (got J={J}, {n_sigmas} sigmas)')
    if M > MAX_CANDIDATES:
        raise ValueError(f'{M} candidates exceed the kernel\'s '
                         f'{MAX_CANDIDATES} (its scan\'s shared memory)')


def oks_nms_keep(kpts: torch.Tensor, areas: torch.Tensor,
                 valid: torch.Tensor, thr: float, sigmas: np.ndarray,
                 max_keep: Optional[int] = None) -> torch.Tensor:
    """Greedy hard OKS-NMS keep mask over score-sorted candidates.

    Args: kpts (M, J, 2) xy, sorted by score, descending; areas (M,); valid
    (M,) bool; or a batch of images along a leading dimension. Returns the
    keep mask (M,) (or (B, M)) bool, in the input order. With ``max_keep``
    the scan stops deciding once that many are kept, and the rest are not
    kept; the first ``max_keep`` kept are the same either way.

    CPU tensors run ``oks_nms_keep_plain``; CUDA tensors launch the kernel,
    which takes f32 kpts and areas, a bool valid, M <= ``MAX_CANDIDATES``
    and J <= ``MAX_JOINTS`` (``check_kernel_limits``, before the build).
    """
    global launches
    if max_keep is not None and max_keep < 0:
        raise ValueError(f'max_keep must be >= 0 (got {max_keep})')
    if kpts.device.type == 'cpu':
        return oks_nms_keep_plain(kpts, areas, valid, thr, sigmas, max_keep)
    if kpts.device.type != 'cuda':
        raise ValueError(f'no OKS-NMS kernel for device {kpts.device}')
    if kpts.dim() == 3:
        return oks_nms_keep(kpts[None], areas[None], valid[None], thr,
                            sigmas, max_keep)[0]
    if kpts.dim() != 4 or kpts.shape[-1] != 2:
        raise ValueError(f'kpts must be (B,M,J,2), got {tuple(kpts.shape)}')
    B, M, J, _ = kpts.shape
    dev = kpts.device
    kpts, areas, valid = (t.contiguous() for t in (kpts, areas, valid))
    check_tensor('kpts', kpts, (B, M, J, 2), torch.float32, dev)
    check_tensor('areas', areas, (B, M), torch.float32, dev)
    check_tensor('valid', valid, (B, M), torch.bool, dev)
    check_kernel_limits(M, J, len(sigmas))
    lib = LIB.load()
    var2 = _nms_var2(sigmas, dev)
    nw = (M + 63) // 64
    mask = torch.empty((B, M, nw), dtype=torch.int64, device=dev)
    keep = torch.empty((B, M), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.oks_nms_keep_forward(
            kpts.data_ptr(), areas.data_ptr(), var2.data_ptr(),
            valid.data_ptr(), mask.data_ptr(), keep.data_ptr(), B, M, J,
            float(thr), EPS, -1 if max_keep is None else int(max_keep),
            stream)
    check_launch('oks_nms_keep', err)
    launches += 1
    return keep


@_batched
def oks_nms_sorted(kpts: torch.Tensor, scores: torch.Tensor,
                   areas: torch.Tensor, valid: torch.Tensor, thr: float,
                   sigmas: np.ndarray, max_dets: int = None):
    """Greedy hard OKS-NMS by one scan over the score-sorted candidates.

    Contract and result of ``oks_nms_fixed``: candidates need not be
    sorted; ties go to the lowest index (the sort is stable); returns
    ``(gather_idx, out_valid)`` of length ``max_dets`` in greedy order. The
    scan is ``oks_nms_keep``: the kernel on a CUDA tensor, its plain
    version on a CPU tensor. Nothing syncs with the host.
    """
    B, M = scores.shape
    if max_dets is None:
        max_dets = M
    dev = kpts.device
    # invalid candidates sort last, as oks_nms_fixed never picks them
    s = torch.where(valid, scores.float(),
                    torch.full_like(scores, -torch.inf, dtype=torch.float32))
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    bidx = torch.arange(B, device=dev)[:, None]
    keep = oks_nms_keep(
        kpts[bidx, order].float().contiguous(),
        areas[bidx, order].float().contiguous(),
        valid[bidx, order].contiguous(), thr, sigmas, max_keep=max_dets)
    # the first max_dets kept positions, in order: the largest of M - pos
    rank = torch.where(keep, M - torch.arange(M, device=dev), 0)
    top = torch.topk(rank, min(max_dets, M), dim=1).values      # (B, <=max)
    if max_dets > M:
        top = torch.nn.functional.pad(top, (0, max_dets - M))
    out_valid = top > 0
    pos = torch.where(out_valid, M - top, 0)
    return torch.where(out_valid, order.gather(1, pos), 0), out_valid
