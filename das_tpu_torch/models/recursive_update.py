"""Recursive joint-offset refinement branch, port of
``das_tpu/models/recursive_update.py``.

A 1x1 reduction followed by N refinement layers. Each layer updates the
features with a DCNv2 conv and gates the joint-offset field
(``NextLevelOffset``), then re-samples the field at head-proposed
locations and fuses the 2*num_heads candidates with a per-dim online
softmax over their sampled confidences. Features are NCHW; the offset
fields are NHWC, as in the JAX functions. Every row fetch is K4
(``ops/gather.py``): each bilinear sample one launch (all candidates of a
level in one sample), the sparse path's two ``take_at`` fields one grouped
row gather, in the forward and, under training, in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.gather import gather_rows_grouped
from ..ops.interp import sample_bilinear_abs
from .graphs import Graphs
from .layers import ConvModule, conv2d, remat


def _fold(x: torch.Tensor, J: int, c: int) -> torch.Tensor:
    """(N, H, W, J*c) -> (N*J, H, W, c): joints into the batch axis."""
    N, H, W, _ = x.shape
    return x.reshape(N, H, W, J, c).permute(0, 3, 1, 2, 4) \
        .reshape(N * J, H, W, c)


def _fuse_candidates(samp_off, sampled, D):
    """Online softmax over candidates, in the JAX candidate order.

    samp_off (..., C, 2) candidate displacements; sampled (..., C, 2D)
    [uvd, conf] at each candidate. Returns (..., D) in ``sampled.dtype``.
    """
    shape = sampled.shape[:-2] + (D,)
    dt = sampled.dtype
    run_max = torch.full(shape, -torch.inf, dtype=dt, device=sampled.device)
    run_sum = torch.zeros(shape, dtype=dt, device=sampled.device)
    run_acc = torch.zeros(shape, dtype=dt, device=sampled.device)
    for c in range(samp_off.shape[-2]):
        off_c = samp_off[..., c, :]
        s = sampled[..., c, :]
        s_uvd, s_conf = s[..., :D], s[..., D:]
        if D == 3:
            diff = torch.cat([off_c, torch.zeros_like(off_c[..., :1])], -1)
        else:
            diff = off_c
        val = s_uvd + diff
        new_max = torch.maximum(run_max, s_conf)
        corr = torch.exp(run_max - new_max)
        w = torch.exp(s_conf - new_max)
        run_sum = run_sum * corr + w
        run_acc = run_acc * corr + w * val
        run_max = new_max
    return run_acc / run_sum


def _offset_sample(uvd: torch.Tensor, sampling_offset: torch.Tensor,
                   joint_conf: torch.Tensor, num_joints: int, num_heads: int,
                   dim: int) -> torch.Tensor:
    """Multi-head deformable re-sampling of the joint-offset field.

    Args (NHWC): uvd (N,H,W,J*dim); sampling_offset (N,H,W,J*heads*2);
    joint_conf (N,H,W,J*dim). Returns (N,H,W,J*dim).
    """
    N, H, W, _ = uvd.shape
    J, Hd, D = num_joints, num_heads, dim
    uvd_j = _fold(uvd, J, D)
    samp_j = _fold(sampling_offset, J, Hd * 2)
    conf_j = _fold(joint_conf, J, D)
    dev = uvd.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] + 0.5

    off_to_target = uvd_j[..., :2]
    tx = xs + off_to_target[..., 0].float() - 0.5
    ty = ys + off_to_target[..., 1].float() - 0.5
    off_from_target = sample_bilinear_abs(samp_j, tx, ty) \
        .reshape(N * J, H, W, Hd, 2) + off_to_target[..., None, :]
    off_from_source = samp_j.reshape(N * J, H, W, Hd, 2)
    samp_off = torch.cat([off_from_target, off_from_source], dim=3)

    feat = torch.cat([uvd_j, conf_j], dim=-1)               # (NJ,H,W,2D)
    # all 2*Hd candidates of every pixel in one sample, candidates innermost
    sx = xs[..., None] + samp_off[..., 0].float() - 0.5     # (NJ,H,W,2Hd)
    sy = ys[..., None] + samp_off[..., 1].float() - 0.5
    sampled = sample_bilinear_abs(feat, sx.reshape(N * J, -1),
                                  sy.reshape(N * J, -1)) \
        .reshape(N * J, H, W, 2 * Hd, 2 * D)
    fused = _fuse_candidates(samp_off, sampled, D)
    fused = fused.reshape(N, J, H, W, D).permute(0, 2, 3, 1, 4)
    return fused.reshape(N, H, W, J * D)


def _offset_sample_sparse(uvd: torch.Tensor, sampling_offset: torch.Tensor,
                          joint_conf: torch.Tensor, select_idx: torch.Tensor,
                          num_joints: int, num_heads: int, dim: int
                          ) -> torch.Tensor:
    """``_offset_sample`` at the flat spatial points ``select_idx`` (N, K)
    only; the same math, so the values equal the dense ones there.
    Returns (N, K, J*dim)."""
    N, H, W, _ = uvd.shape
    J, Hd, D = num_joints, num_heads, dim
    K = select_idx.shape[1]
    uvd_j = _fold(uvd, J, D)
    samp_j = _fold(sampling_offset, J, Hd * 2)
    conf_j = _fold(joint_conf, J, D)

    idxj = select_idx[:, None, :].expand(N, J, K).reshape(N * J, K)
    xk = (idxj % W).float() + 0.5
    yk = torch.div(idxj, W, rounding_mode='floor').float() + 0.5

    # both fields at the selected points, one launch: (NJ, K, D), (NJ, K, 2Hd)
    uvd_sel, samp_sel = gather_rows_grouped(
        [uvd_j.reshape(N * J, H * W, D).contiguous(),
         samp_j.reshape(N * J, H * W, Hd * 2).contiguous()], [idxj, idxj])

    off_to_target = uvd_sel[..., :2]
    tx = xk + off_to_target[..., 0].float() - 0.5
    ty = yk + off_to_target[..., 1].float() - 0.5
    off_from_target = sample_bilinear_abs(samp_j, tx, ty) \
        .reshape(N * J, K, Hd, 2) + off_to_target[..., None, :]
    off_from_source = samp_sel.reshape(N * J, K, Hd, 2)
    samp_off = torch.cat([off_from_target, off_from_source], dim=2)

    feat = torch.cat([uvd_j, conf_j], dim=-1)               # (NJ,H,W,2D)
    sx = xk[:, :, None] + samp_off[..., 0].float() - 0.5
    sy = yk[:, :, None] + samp_off[..., 1].float() - 0.5
    s_all = sample_bilinear_abs(feat, sx.reshape(N * J, K * 2 * Hd),
                                sy.reshape(N * J, K * 2 * Hd)) \
        .reshape(N * J, K, 2 * Hd, 2 * D)
    fused = _fuse_candidates(samp_off, s_all, D)            # (NJ, K, D)
    fused = fused.reshape(N, J, K, D).permute(0, 2, 1, 3)
    return fused.reshape(N, K, J * D)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class NextLevelOffset(nn.Module):
    """Gated offset update + proposal heads (ref recursive_update.py:164)."""

    def __init__(self, channels: int, num_joints: int, num_heads: int,
                 dim: int = 3, dcn_gather_mode: str = 'patch',
                 dcn_train_gather_mode: str = 'auto',
                 dcn_shift_radius: int = 2, dcn_shift_budget: int = 2048):
        super().__init__()
        J, Hd, D = num_joints, num_heads, dim
        self.update_feat_conv = ConvModule(
            channels, channels, 3, 1, 1, dcn=True,
            norm_cfg=dict(type='GN', num_groups=32),
            dcn_gather_mode=dcn_gather_mode,
            dcn_train_gather_mode=dcn_train_gather_mode,
            dcn_shift_radius=dcn_shift_radius,
            dcn_shift_budget=dcn_shift_budget)
        self.sampling_offset = nn.Conv2d(channels, J * Hd * 2, 1)
        self.sampling_conf = nn.Conv2d(channels, J * D, 1)
        self.update_weight = nn.Conv2d(channels, J * D, 1)
        self.update_offset_value = nn.Conv2d(channels, J * D, 1)

    def forward(self, feat: torch.Tensor, offset: torch.Tensor):
        feat = feat + self.update_feat_conv(feat)
        sampling_offset = _nhwc(conv2d(self.sampling_offset, feat))
        sampling_conf = _nhwc(conv2d(self.sampling_conf, feat))
        offset_weight = torch.sigmoid(_nhwc(conv2d(self.update_weight, feat)))
        next_offset = _nhwc(conv2d(self.update_offset_value, feat))
        offset = (1.0 - offset_weight) * offset + offset_weight * next_offset
        return feat, offset, sampling_offset, sampling_conf


class RecursiveUpdateLayer(nn.Module):

    def __init__(self, channels: int, num_joints: int, num_heads: int,
                 dim: int = 3, **dcn):
        super().__init__()
        self.num_joints, self.num_heads, self.dim = num_joints, num_heads, dim
        self.next_level_offset = NextLevelOffset(channels, num_joints,
                                                 num_heads, dim, **dcn)

    def forward(self, feat, prev_offset, select_idx=None):
        feat, offset, samp_off, samp_conf = self.next_level_offset(
            feat, prev_offset)
        if select_idx is None:
            return feat, _offset_sample(offset, samp_off, samp_conf,
                                        self.num_joints, self.num_heads,
                                        self.dim)
        # sparse path (eval: the decode's candidates; training: the assigned
        # positives): refine only the selected points; the dense gated field
        # is returned as the scatter base for the rest
        refined = _offset_sample_sparse(offset, samp_off, samp_conf,
                                        select_idx, self.num_joints,
                                        self.num_heads, self.dim)
        return feat, (offset, refined)


class RecursiveUpdateBranch(nn.Module):
    """1x1 reduction + stacked refinement layers (ref :238-255).

    ``select_idx`` (N, K) restricts the LAST layer's re-sampling to those
    flat spatial points; the return value is then
    ``(dense_base_field, (N, K, J*dim) refined)``; earlier layers stay
    dense, since the next layer's gated update reads the whole refined
    field (JAX recursive_update.py:418-429). ``remat`` makes each layer one
    rematerialised region under training (``layers.remat``). ``prev_loss``
    is read by the head's loss; ``gather_mode`` (a TPU lowering of the one
    bilinear sampler) is accepted so the configs build unchanged.
    """

    def __init__(self, num_joints: int, num_heads: int = 4,
                 in_channels: int = 256, feat_channels: int = 256,
                 num_layers: int = 1, dim: int = 3, prev_loss: bool = True,
                 remat: bool = False, gather_mode: str = 'auto',
                 dcn_gather_mode: str = 'patch',
                 dcn_train_gather_mode: str = 'auto',
                 dcn_shift_radius: int = 2, dcn_shift_budget: int = 2048):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        self.reduction = ConvModule(in_channels, feat_channels, 1, 1, 0,
                                    norm_cfg=dict(type='GN', num_groups=32))
        for i in range(num_layers):
            self.add_module(f'layer_{i}', RecursiveUpdateLayer(
                feat_channels, num_joints, num_heads, dim,
                dcn_gather_mode=dcn_gather_mode,
                dcn_train_gather_mode=dcn_train_gather_mode,
                dcn_shift_radius=dcn_shift_radius,
                dcn_shift_budget=dcn_shift_budget))
        self._graphs = Graphs('ru')
        self._body_modules = list(self.modules())[1:]

    def forward(self, feat: torch.Tensor, offset: torch.Tensor,
                select_idx: Optional[torch.Tensor] = None):
        """The body runs from a CUDA graph where ``graphs.Graphs`` allows
        (eval, no grad, on the card, no hook inside): this call, and any
        hook on this module, still runs. What it returns then is the
        graph's memory, which the next call at the same shapes overwrites:
        a hook that keeps it keeps a copy."""
        return self._graphs.run(self._body, (feat, offset, select_idx),
                                self, self._body_modules)

    def _body(self, feat, offset, select_idx):
        feat = self.reduction(feat)
        for i in range(self.num_layers):
            sel = select_idx if i == self.num_layers - 1 else None
            layer = getattr(self, f'layer_{i}')
            if self.remat and self.training:
                feat, offset = remat(layer, layer, feat, offset, sel)
            else:
                feat, offset = layer(feat, offset, sel)
        return offset
