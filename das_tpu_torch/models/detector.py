"""DAS detector: backbone + FPN + DASHead, port of
``das_tpu/models/detector.py``: the forward and the training loss.

Built from an mmdet3d-style model config by ``build_model`` (serving) or
``build_trainable_model`` (training), so the repo's configs build it
unchanged. Takes NHWC images like the JAX model and returns the head's
per-level NHWC outputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import wrap_cfg
from ..config.registry import BACKBONES, HEADS, MODELS, NECKS, \
    build_from_cfg
from ..utils.device import resolve_device
from ..utils.profiling import span
from .das_head import positives_first
from .layers import DeformConv2d, cast_compute, keep_master_weights, \
    lecun_normal_


@MODELS.register_module()
class DAS(nn.Module):
    """Single-stage multi-person 3D pose detector."""

    def __init__(self, backbone: dict, neck: dict, bbox_head: dict,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.backbone = build_from_cfg(_clean(backbone), BACKBONES)
        self.neck = build_from_cfg(_clean(neck), NECKS)
        head_cfg = _clean(bbox_head)
        head_cfg.setdefault('train_cfg', train_cfg)
        head_cfg.setdefault('test_cfg', test_cfg)
        self.bbox_head = build_from_cfg(head_cfg, HEADS)

    def extract_feat(self, img: torch.Tensor):
        """img (N,H,W,3) -> FPN maps (NCHW)."""
        with span('das.backbone'):
            x = img.permute(0, 3, 1, 2)
            if x.is_cuda:
                x = x.contiguous(memory_format=torch.channels_last)
            x = self.backbone(x)
        with span('das.neck'):
            return self.neck(x)

    def forward(self, img: torch.Tensor, select_idx=None):
        """Per-level head outputs (cls_scores, pose_preds, centernesses,
        ref_uvds), each a list over levels of NHWC tensors."""
        return self.bbox_head(self.extract_feat(img), select_idx)

    def loss(self, img: torch.Tensor, targets: Dict[str, torch.Tensor],
             max_pos: int = 1024, group=None) -> Dict[str, torch.Tensor]:
        """Training forward + loss (JAX detector.py:66-100); with a process
        group, this rank's share of the global batch's loss
        (``DASHead.loss``).

        With ``train_cfg.sparse_refine`` the RU re-sampling runs only at
        each level's first ``max_pos`` positives per image (by flat index);
        a level with at most ``max_pos`` points stays dense. The loss reads
        the refined field only at its own first ``max_pos`` positives, a
        subset of those, so losses and gradients are the dense ones.
        """
        select = None
        if self.train_cfg.get('sparse_refine'):
            head = self.bbox_head
            labels = targets['labels']
            N, H, W = img.shape[:3]
            select, begin = [], 0
            for i in range(len(head.strides)):
                n = (H // (4 * 2 ** i)) * (W // (4 * 2 ** i))
                lab = labels[begin:begin + N * n].reshape(N, n)
                begin += N * n
                select.append(None if n <= max_pos else positives_first(
                    lab < head.bg_label, max_pos))
        with span('das.train.forward'):
            cls_scores, pose_preds, centernesses, ref_uvds = self(img,
                                                                  select)
        with span('das.train.loss'):
            return self.bbox_head.loss(cls_scores, pose_preds, centernesses,
                                       ref_uvds, targets, max_pos=max_pos,
                                       group=group)

    def init_weights(self, seed: int = 0):
        """Seeded init: flax's defaults (LeCun-normal kernels, zero biases,
        unit norms) for the whole model, then the reference head init."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, DeformConv2d)):
                lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        self.bbox_head.init_weights(gen)
        return self


def _clean(cfg) -> dict:
    cfg = dict(cfg)
    cfg.pop('pretrained', None)
    return cfg


def build_model(cfg: dict, dtype: torch.dtype = torch.float32,
                device=None, seed: int = 0) -> DAS:
    """mmdet3d-style entry: ``build_model(cfg.model)``; an eval-mode model
    on ``device`` (the card unless the caller names another) computing in
    ``dtype``, initialised from ``seed``."""
    dev = resolve_device(device)
    model = build_from_cfg(dict(wrap_cfg(cfg)), MODELS)
    model.init_weights(seed)
    cast_compute(model, dtype)
    return _place(model, dev).eval()


def build_trainable_model(cfg: dict, dtype: torch.dtype = torch.float32,
                          device=None, seed: int = 0) -> DAS:
    """A model to train, in train mode on ``device`` (the card unless the
    caller names another), initialised from ``seed``: f32 master weights,
    each conv computing in ``dtype``."""
    dev = resolve_device(device)
    model = build_from_cfg(dict(wrap_cfg(cfg)), MODELS)
    model.init_weights(seed)
    keep_master_weights(model, dtype)
    return _place(model, dev).train()


def _place(model: DAS, dev: torch.device) -> DAS:
    model = model.to(dev)
    if dev.type == 'cuda':
        model = model.to(memory_format=torch.channels_last)
    return model
