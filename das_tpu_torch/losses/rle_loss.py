"""Residual log-likelihood (RLE) regression loss, port of
``das_tpu/losses/rle_loss.py`` (the reference's ``RLELoss3D``).

``loss = nf_loss + logQ``: ``nf_loss = log(sigma) - log_phi`` from the
RealNVP flow (computed in the head) and ``logQ`` the residual Laplace term,
masked by per-joint visibility and divided by the visible count, in f32.
"""

from __future__ import annotations

import math

import torch

_AMP = 1.0 / math.sqrt(2.0 * math.pi)


def rle_loss(nf_loss: torch.Tensor, uvd: torch.Tensor, sigma: torch.Tensor,
             gt_uvd: torch.Tensor, gt_uv_weight: torch.Tensor,
             weight=None, residual: bool = True,
             vis_count=None) -> torch.Tensor:
    """RLE loss; every input (P, J, 3) but ``weight`` (a broadcastable
    code weight). Returns a scalar, 0 with fewer than one visible joint.
    ``vis_count`` (default: the visible joints of these inputs) is the
    divisor: the global batch's count, where a rank holds a share."""
    nf_loss = nf_loss.float() * gt_uv_weight
    if vis_count is None:
        vis_count = gt_uv_weight[..., 0].sum()
    loss = nf_loss
    if residual:
        # |r| as a where: its derivative at r = 0 is +1, as jnp.abs' is
        res = gt_uvd - uvd
        log_q = torch.log(sigma / _AMP) + torch.where(res >= 0, res, -res) \
            / (math.sqrt(2.0) * sigma + 1e-9)
        loss = nf_loss + log_q * gt_uv_weight
    if weight is not None:
        loss = loss * weight
    total = loss.sum() / vis_count.clamp_min(1e-9)
    return torch.where(vis_count < 1.0, torch.zeros_like(total), total)
