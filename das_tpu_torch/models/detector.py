"""DAS detector: backbone + FPN + DASHead, port of
``das_tpu/models/detector.py`` (eval forward).

Built from an mmdet3d-style model config by ``build_model``, so the repo's
configs build it unchanged. Takes NHWC images like the JAX model and
returns the head's per-level NHWC outputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import wrap_cfg
from ..config.registry import BACKBONES, HEADS, MODELS, NECKS, \
    build_from_cfg
from ..utils.device import resolve_device
from .layers import DeformConv2d, cast_compute, lecun_normal_


@MODELS.register_module()
class DAS(nn.Module):
    """Single-stage multi-person 3D pose detector (eval)."""

    def __init__(self, backbone: dict, neck: dict, bbox_head: dict,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        self.backbone = build_from_cfg(_clean(backbone), BACKBONES)
        self.neck = build_from_cfg(_clean(neck), NECKS)
        head_cfg = _clean(bbox_head)
        head_cfg.setdefault('train_cfg', train_cfg)
        head_cfg.setdefault('test_cfg', test_cfg)
        self.bbox_head = build_from_cfg(head_cfg, HEADS)

    def extract_feat(self, img: torch.Tensor):
        """img (N,H,W,3) -> FPN maps (NCHW)."""
        x = img.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return self.neck(self.backbone(x))

    def forward(self, img: torch.Tensor, select_idx=None):
        """Per-level head outputs (cls_scores, pose_preds, centernesses,
        ref_uvds), each a list over levels of NHWC tensors."""
        return self.bbox_head(self.extract_feat(img), select_idx)

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
    model = model.to(dev).eval()
    if dev.type == 'cuda':
        model = model.to(memory_format=torch.channels_last)
    return model
