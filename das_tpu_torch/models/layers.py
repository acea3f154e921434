"""Building blocks shared by the DAS model family, port of
``das_tpu/models/layers.py``.

Modules work on NCHW tensors (``channels_last`` memory on the card). Their
parameter names are the reference's torch key names: a ``ConvModule`` holds
``conv`` and ``bn`` or ``gn``; a ``DeformConv2d`` holds ``weight``,
``bias`` and ``conv_offset``.

Types follow the JAX modules, which compute in the model dtype with f32
parameters: convolutions run in the dtype of their (cast) weights; norms
take their statistics and affine in f32 and return the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import modulated_deform_conv


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Fill ``t`` from N(0, std^2) drawn from ``gen`` (on the CPU)."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def lecun_normal_(t: torch.Tensor, gen: torch.Generator):
    """Normal with std 1/sqrt(fan_in), flax's default kernel init."""
    fan_in = t[0].numel()
    normal_(t, 1.0 / math.sqrt(fan_in), gen)


def he_normal_(t: torch.Tensor, gen: torch.Generator):
    """Normal with std sqrt(2/fan_in)."""
    fan_in = t[0].numel()
    normal_(t, math.sqrt(2.0 / fan_in), gen)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm (BN and SyncBN alike): running statistics, eps
    1e-5, f32 math. Its keys are those the reference checkpoints carry,
    less ``num_batches_tracked``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0,
                            1e-5).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over contiguous channel groups, eps 1e-5, f32 math."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, 1e-5).to(x.dtype)


def make_norm(norm_cfg: Optional[dict], channels: int):
    """(name, module) for an mmcv-style norm_cfg: BN/SyncBN -> 'bn',
    GN -> 'gn'; (None, None) without a norm."""
    if norm_cfg is None:
        return None, None
    kind = norm_cfg if isinstance(norm_cfg, str) else norm_cfg['type']
    if kind in ('BN', 'SyncBN'):
        return 'bn', BatchNorm(channels)
    if kind == 'GN':
        groups = 32 if isinstance(norm_cfg, str) \
            else norm_cfg.get('num_groups', 32)
        return 'gn', GroupNorm(groups, channels)
    raise ValueError(f'unsupported norm type {kind}')


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Run ``conv`` in the dtype of its weights, as flax casts its input."""
    return conv(x.to(conv.weight.dtype))


class DeformConv2d(nn.Module):
    """DCNv2 pack layer: zero-init offset conv + modulated deform conv.

    ``weight`` is (Cout, Cin, K, K) like the reference's; the deform conv
    itself runs in NHWC with the (K, K, Cin, Cout) kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1,
                 use_bias: bool = True, gather_mode: str = 'patch',
                 shift_radius: int = 2, shift_budget: int = 2048):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.padding = padding
        self.gather_mode = gather_mode
        self.shift_radius = shift_radius
        self.shift_budget = shift_budget
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) \
            if use_bias else None
        self.conv_offset = nn.Conv2d(in_channels, 3 * k * k, k,
                                     padding=padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.kernel_size ** 2
        dt = self.weight.dtype
        x = x.to(dt)
        raw = conv2d(self.conv_offset, x).permute(0, 2, 3, 1)   # NHWC
        offset = raw[..., :2 * kk]
        mask = torch.sigmoid(raw[..., 2 * kk:])
        out = modulated_deform_conv(
            x.permute(0, 2, 3, 1).contiguous(), offset, mask,
            self.weight.permute(2, 3, 1, 0), self.bias,
            kernel_size=self.kernel_size, padding=self.padding,
            gather_mode=self.gather_mode, shift_radius=self.shift_radius,
            shift_budget=self.shift_budget)
        return out.permute(0, 3, 1, 2)


class ConvModule(nn.Module):
    """conv -> norm -> act, matching mmcv ConvModule defaults.

    ``bias='auto'`` means bias iff there is no norm (mmcv behaviour).
    ``dcn=True`` makes the conv a ``DeformConv2d`` (3x3, stride 1).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 bias: Union[str, bool] = 'auto',
                 norm_cfg: Optional[dict] = None, act: Optional[str] = 'relu',
                 dcn: bool = False, dcn_gather_mode: str = 'patch',
                 dcn_shift_radius: int = 2, dcn_shift_budget: int = 2048):
        super().__init__()
        use_bias = (norm_cfg is None) if bias == 'auto' else bool(bias)
        if act not in (None, 'relu'):
            raise ValueError(f'unsupported act {act}')
        self.act = act
        if dcn:
            assert stride == 1
            self.conv = DeformConv2d(in_channels, out_channels, kernel_size,
                                     padding, use_bias, dcn_gather_mode,
                                     dcn_shift_radius, dcn_shift_budget)
        else:
            self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                                  stride, padding, bias=use_bias)
        name, norm = make_norm(norm_cfg, out_channels)
        self.norm_name = name
        if norm is not None:
            self.add_module(name, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.conv, DeformConv2d):
            x = self.conv(x)
        else:
            x = conv2d(self.conv, x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        if self.act == 'relu':
            x = F.relu(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (ref: mmcv Scale at das_head.py:171).
    The product is f32, as the JAX module's f32 parameter promotes it."""

    def __init__(self, init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() * self.scale


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1), NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


def cast_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype: every conv's (and deform conv's) weight and
    bias take ``dtype``; norms, ``Scale`` and the flows stay f32, as the
    JAX modules keep f32 parameters and compute norms in f32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, DeformConv2d)):
            for name, p in m.named_parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model
