"""Swin Transformer backbone (Liu et al., ICCV 2021, arXiv:2103.14030), as
mmdet's ``SwinTransformer`` (mmdet/models/backbones/swin.py) builds it
from its config. The JAX package has no Swin; the plain PyTorch reference
is ``dasbench/reference/backbones/SwinTransformer.py``.

A patch embedding (a ``patch_size`` stride convolution, then LayerNorm),
then four stages of blocks at strides 4 to 32, ``embed_dims * 2**i``
channels. A block is

    x = x + DropPath(ShiftWindowMSA(norm1(x)))
    x = x + DropPath(fc2(GELU(fc1(norm2(x)))))

where ShiftWindowMSA pads the map to whole windows after ``norm1`` (the
padded tokens are zero and are attended to), rolls it by ``window_size //
2`` on odd blocks (the shifted ones, with mmdet's -100 mask between the
rolled map's regions), attends within each window with a learned
relative-position bias (``ops.window_attn``), and undoes the roll and the
padding. Between stages a ``PatchMerging`` takes each 2 x 2 patch in
``nn.Unfold``'s order (a channel's four pixels together), LayerNorm and a
bias-free linear map to twice the channels. Each stage's map before its
merging goes through ``norm{i}`` to an output.

Key names are mmdet's: ``patch_embed.projection``, ``patch_embed.norm``,
``stages.{i}.blocks.{j}.{norm1, attn.w_msa.relative_position_bias_table,
attn.w_msa.qkv, attn.w_msa.proj, norm2, ffn.layers.0.0, ffn.layers.1}``,
``stages.{i}.downsample.{norm, reduction}``, ``norm{i}``;
``relative_position_index`` is a buffer outside the state dict.

Tokens stay channels-last, (B, H, W, C) in the compute dtype, from the
patch embedding to the four outputs, which are NCHW views of them. Where
autograd does not record, on the card, the attention is the hand-written
kernel (``ops.window_attn.window_attention``), which takes bf16 at 12 x 12
windows and 32-channel heads and raises otherwise; under autograd
(training) and on the CPU it is its plain version. DropPath (stochastic depth, rates rising linearly to
``drop_path_rate`` over the blocks) zeroes a whole sample's branch in
training and is the identity in eval.

``frozen_stages`` K >= 0 keeps the patch embedding and then, for i < K,
``norm{i}`` and stage i (with its merging) in eval, and
``frozen_prefixes`` names their parameters for the optimizer to hold still
(mmdet's ``_freeze_stages``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.registry import BACKBONES
from ..ops import window_attn
from ..utils.profiling import span
from .layers import LayerNorm, Linear, conv2d


def drop_path(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """mmcv's ``drop_path``: in training each sample's ``x`` is zeroed with
    probability ``p`` and otherwise scaled by 1 / (1 - p); the identity in
    eval or at p = 0."""
    if p == 0.0 or not training:
        return x
    keep = 1.0 - p
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    r = keep + torch.rand(shape, dtype=x.dtype, device=x.device)
    return x.div(keep) * r.floor()


class WindowMSA(nn.Module):
    """mmdet's ``WindowMSA``: the qkv projection, the windows' attention
    with the relative-position bias table, the output projection."""

    def __init__(self, dims: int, heads: int, window: int, qkv_bias: bool):
        super().__init__()
        self.heads = heads
        self.window = window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer(
            'relative_position_index',
            window_attn.relative_position_index(window), persistent=False)
        self.qkv = Linear(dims, dims * 3, bias=qkv_bias)
        self.proj = Linear(dims, dims)

    def fused(self, qkv: torch.Tensor) -> bool:
        """Whether the kernel takes the call: a ``qkv`` on the card that
        autograd does not record. The kernel raises for a dtype, window or
        head size it does not take; nothing falls back to the plain chain
        on the card outside autograd."""
        return qkv.is_cuda and not window_attn.records(
            qkv, self.relative_position_bias_table)

    def forward(self, x: torch.Tensor, grid: Sequence[int], shift: int
                ) -> torch.Tensor:
        """(B_, N, C) windows' tokens -> (B_, N, C)."""
        qkv = self.qkv(x)
        fn = window_attn.window_attention if self.fused(qkv) \
            else window_attn.window_attention_plain
        out = fn(qkv, self.relative_position_bias_table,
                 self.relative_position_index, self.heads, grid, shift)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """mmdet's ``ShiftWindowMSA``: pad to whole windows, roll (shifted
    blocks), partition, attend, reverse, roll back, crop; DropPath on the
    result."""

    def __init__(self, dims: int, heads: int, window: int, shift: bool,
                 qkv_bias: bool, drop_path_rate: float):
        super().__init__()
        self.window = window
        self.shift = window // 2 if shift else 0
        self.drop_path_rate = drop_path_rate
        self.w_msa = WindowMSA(dims, heads, window, qkv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C)."""
        B, H, W, C = x.shape
        ws = self.window
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), (1, 2))
        nwh, nww = Hp // ws, Wp // ws
        win = x.view(B, nwh, ws, nww, ws, C).permute(0, 1, 3, 2, 4, 5) \
            .reshape(B * nwh * nww, ws * ws, C)
        out = self.w_msa(win, (nwh, nww), self.shift)
        x = out.view(B, nwh, nww, ws, ws, C).permute(0, 1, 3, 2, 4, 5) \
            .reshape(B, Hp, Wp, C)
        if self.shift:
            x = torch.roll(x, (self.shift, self.shift), (1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W].contiguous()
        return drop_path(x, self.drop_path_rate, self.training)


class FFN(nn.Module):
    """mmcv's ``FFN`` of a Swin block: ``layers.0.0`` (C -> hidden), GELU,
    ``layers.1`` (hidden -> C); DropPath on the result, the identity
    added."""

    def __init__(self, dims: int, hidden: int, drop_path_rate: float):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(Linear(dims, hidden)),
                                    Linear(hidden, dims))
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, identity: torch.Tensor
                ) -> torch.Tensor:
        out = self.layers[1](F.gelu(self.layers[0][0](x)))
        return identity + drop_path(out, self.drop_path_rate, self.training)


class SwinBlock(nn.Module):

    def __init__(self, dims: int, heads: int, hidden: int, window: int,
                 shift: bool, qkv_bias: bool, drop_path_rate: float):
        super().__init__()
        self.norm1 = LayerNorm(dims)
        self.attn = ShiftWindowMSA(dims, heads, window, shift, qkv_bias,
                                   drop_path_rate)
        self.norm2 = LayerNorm(dims)
        self.ffn = FFN(dims, hidden, drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        with span('das.swin.attn'):
            y = self.attn(y)
        x = x + y
        return self.ffn(self.norm2(x), x)


class PatchMerging(nn.Module):
    """mmdet's ``PatchMerging`` (2 x 2, stride 2, 'corner' padding): each
    output pixel takes the input's 2 x 2 patch in ``nn.Unfold``'s order,
    channel-major (c's four pixels (0, 0), (0, 1), (1, 0), (1, 1) at 4c to
    4c + 3), then ``norm`` and the bias-free ``reduction``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = LayerNorm(4 * cin)
        self.reduction = Linear(4 * cin, cout, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, ceil(H / 2), ceil(W / 2), cout)."""
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = H + H % 2, W + W % 2
        x = x.view(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4) \
            .reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class SwinBlockSequence(nn.Module):
    """A stage: its blocks (every second one shifted) and, but for the
    last stage, the ``downsample`` that feeds the next."""

    def __init__(self, dims: int, heads: int, hidden: int, depth: int,
                 window: int, qkv_bias: bool, rates: Sequence[float],
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dims, heads, hidden, window, j % 2 == 1, qkv_bias,
                      rates[j]) for j in range(depth)])
        self.downsample = PatchMerging(dims, 2 * dims) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class PatchEmbed(nn.Module):
    """mmcv's ``PatchEmbed``: 'corner' padding to whole patches, the
    ``projection`` convolution (kernel and stride ``patch_size``), then
    ``norm`` over the tokens."""

    def __init__(self, cin: int, dims: int, patch: int, norm: bool):
        super().__init__()
        self.patch = patch
        self.projection = nn.Conv2d(cin, dims, patch, patch)
        self.norm = LayerNorm(dims) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW image -> (B, H / patch, W / patch, dims) tokens."""
        p = self.patch
        H, W = x.shape[2:]
        if H % p or W % p:
            x = F.pad(x, (0, (p - W % p) % p, 0, (p - H % p) % p))
        # channels-last on the card already, so no copy there
        x = conv2d(self.projection, x).permute(0, 2, 3, 1).contiguous()
        return self.norm(x) if self.norm is not None else x


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin Transformer (mmdet's config surface, no absolute position
    embedding, no dropout but DropPath): NCHW image in; the maps of
    ``out_indices`` out, lowest stride first, NCHW."""

    def __init__(self, embed_dims: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4,
                 qkv_bias: bool = True, patch_size: int = 4,
                 patch_norm: bool = True, pretrain_img_size: int = 224,
                 drop_path_rate: float = 0.1,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1):
        super().__init__()
        # pretrain_img_size sizes only an absolute position embedding,
        # which this configuration surface does not have
        self.pretrain_img_size = pretrain_img_size
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        n = len(depths)
        self.patch_embed = PatchEmbed(3, embed_dims, patch_size, patch_norm)
        total = sum(depths)
        rates = torch.linspace(0, drop_path_rate, total,
                               device='cpu').tolist()
        self.stages = nn.ModuleList()
        dims, begin = embed_dims, 0
        self.num_features = []
        for i, depth in enumerate(depths):
            self.stages.append(SwinBlockSequence(
                dims, num_heads[i], int(mlp_ratio * dims), depth, window_size,
                qkv_bias, rates[begin:begin + depth], i < n - 1))
            self.num_features.append(dims)
            begin += depth
            if i < n - 1:
                dims *= 2
        for i in self.out_indices:
            self.add_module(f'norm{i}', LayerNorm(self.num_features[i]))
        self.out_channels = [self.num_features[i] for i in self.out_indices]

    def frozen_modules(self) -> List[nn.Module]:
        """The patch embedding for K >= 0; ``norm{i}`` and stage i for
        i < K."""
        if self.frozen_stages < 0:
            return []
        out = [self.patch_embed]
        for i in range(min(self.frozen_stages, len(self.stages))):
            if i in self.out_indices:
                out.append(getattr(self, f'norm{i}'))
            out.append(self.stages[i])
        return out

    def frozen_prefixes(self, prefix: str = 'backbone.') -> Tuple[str, ...]:
        """The parameter prefixes the optimizer holds still, under the
        backbone's own ``prefix`` in the model."""
        if self.frozen_stages < 0:
            return ()
        names = ['patch_embed.']
        for i in range(min(self.frozen_stages, len(self.stages))):
            if i in self.out_indices:
                names.append(f'norm{i}.')
            names.append(f'stages.{i}.')
        return tuple(prefix + n for n in names)

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.frozen_modules():
            m.eval()
        return self

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        with span('das.swin.patch_embed'):
            x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            with span(f'das.swin.stage{i}'):
                if i > 0:
                    x = self.stages[i - 1].downsample(x)
                x = stage(x)
                if i in self.out_indices:
                    out = getattr(self, f'norm{i}')(x)
                    outs.append(out.permute(0, 3, 1, 2))
        return outs
