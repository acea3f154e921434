"""Loss functions of the DAS head, port of ``das_tpu/losses/common.py``.

Elementwise tensor math in f32 whatever the compute dtype, as the
reference's ``@force_fp32`` loss (das_head.py:281-282).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor=None) -> torch.Tensor:
    """mmdet sigmoid focal loss, summed and divided by ``avg_factor``.

    logits (N, num_classes); labels (N,) int, ``num_classes`` meaning
    background.
    """
    logits = logits.float()
    num_classes = logits.shape[-1]
    target = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes] \
        .float()
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) \
        * pt.pow(gamma)
    loss = (_bce_with_logits(logits, target) * focal_weight).sum()
    if avg_factor is not None:
        loss = loss / avg_factor
    return loss


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """Stable elementwise binary cross entropy with logits. ``maximum``
    and the ``where`` form of ``|x|`` give JAX's derivatives at a logit of
    exactly 0 (``jnp.maximum`` passes half, ``jnp.abs``' is +1), where
    ``clamp_min`` and ``abs`` give 1 and 0."""
    return torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * targets \
        + torch.log1p(torch.exp(-torch.where(logits >= 0, logits, -logits)))


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         weight: Optional[torch.Tensor] = None,
                         avg_factor=None) -> torch.Tensor:
    """mmdet CrossEntropyLoss(use_sigmoid=True): elementwise BCE; with a
    weight and no ``avg_factor``, divided by the weight's sum."""
    logits = logits.float()
    loss = _bce_with_logits(logits, targets.float())
    if weight is not None:
        loss = loss * weight
        if avg_factor is None:
            return loss.sum() / weight.sum().clamp_min(1e-12)
    if avg_factor is not None:
        return loss.sum() / avg_factor
    return loss.mean()


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9.0,
                   weight: Optional[torch.Tensor] = None,
                   avg_factor=None) -> torch.Tensor:
    """mmdet SmoothL1Loss: huber with knee ``beta``, summed and divided by
    ``avg_factor``."""
    diff = (pred.float() - target.float()).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    if weight is not None:
        loss = loss * weight
    loss = loss.sum()
    if avg_factor is not None:
        loss = loss / torch.as_tensor(avg_factor).clamp_min(1e-12)
    return loss
