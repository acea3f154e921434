"""Swin Transformer (Liu et al., ICCV 2021, arXiv:2103.14030), as mmdet's
``SwinTransformer`` (mmdet/models/backbones/swin.py) builds it from its
config, with no absolute position embedding and no dropout but DropPath:

- ``patch_embed``: 'corner' zero padding to whole patches, the
  ``projection`` convolution (kernel and stride ``patch_size``), LayerNorm
  over the tokens (``norm``).
- Four stages (``stages.{i}``) of ``depths[i]`` blocks at ``embed_dims *
  2**i`` channels. A block: ``x + DropPath(ShiftWindowMSA(norm1(x)))``, then
  ``x + DropPath(ffn(norm2(x)))``. ShiftWindowMSA pads the map with zeros
  to whole windows of ``window_size`` (after norm1: the padded tokens are
  attended to), rolls it by ``-window_size // 2`` on odd blocks, cuts it
  into windows, attends within each (``w_msa``: the ``qkv`` projection,
  ``softmax((q / sqrt(d)) k^T + bias + mask) v`` a head, the ``proj``
  projection; the bias ``relative_position_bias_table[index]`` by mmdet's
  ``double_step_seq`` index; the mask, on shifted blocks, -100 between the
  nine regions mmdet's ``img_mask`` gives the padded map), puts the
  windows back, rolls back and crops. The FFN: ``layers.0.0``, GELU (erf),
  ``layers.1``.
- Between stages ``downsample`` (mmdet's ``PatchMerging``): 'corner'
  padding to even sides, ``nn.Unfold(2, stride=2)`` (a channel's four
  pixels together), LayerNorm, the bias-free ``reduction``.
- The map of each of ``out_indices``, before its merging, through
  ``norm{i}``, NCHW.

``drop_path_rate`` rises linearly over the blocks (mmdet's ``dpr``); a
block's DropPath zeroes a sample's branch with its rate in training (the
identity in eval). ``frozen_stages`` K >= 0 freezes the patch embedding,
and for i < K ``norm{i}`` and stage i (mmdet's ``_freeze_stages``), which
``train()`` keeps in eval. With ``remat`` each block is a checkpointed
region.

Departures from mmdet, none of which changes a served or trained number:
the tokens are kept as (B, H, W, C) maps rather than (B, H * W, C)
sequences with a separate shape; ``relative_position_index`` is a buffer
outside the state dict (it is derived, not learned), so that the seeded
weights do not draw it; the LayerNorm is written out here (mean and
biased variance over the channels, eps 1e-5) as a ``model.GroupNorm``, so
that the seeded weights and the training check find it as a norm; every
product (convolution, linear map, the two attention products) takes its
operands through ``precision.mm_operand``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..model import Conv, GroupNorm
from ..precision import mm_operand

# the keys of the backbone section that are the repo configuration's
REPO_KEYS = ('embed_dims', 'depths', 'num_heads', 'window_size', 'mlp_ratio',
             'qkv_bias', 'patch_size', 'patch_norm', 'pretrain_img_size',
             'drop_path_rate', 'out_indices', 'frozen_stages')


class LayerNorm(GroupNorm):
    """LayerNorm over the last dimension, eps 1e-5."""

    def __init__(self, c):
        super().__init__(1, c)

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class Linear(nn.Module):
    """A linear map holding ``weight`` (out, in) and ``bias``."""

    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.linear(mm_operand(x), mm_operand(self.weight), self.bias)


def drop_path(x, p, training):
    if p == 0.0 or not training:
        return x
    keep = 1.0 - p
    r = keep + torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                          dtype=x.dtype, device=x.device)
    return x.div(keep) * r.floor()


def double_step_seq(step1, len1, step2, len2):
    seq1 = torch.arange(0, step1 * len1, step1)
    seq2 = torch.arange(0, step2 * len2, step2)
    return (seq1[:, None] + seq2[None, :]).reshape(1, -1)


def window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C)


def window_reverse(windows, H, W, ws):
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


class WindowMSA(nn.Module):

    def __init__(self, dims, heads, ws, qkv_bias):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.scale = (dims // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, heads))
        coords = double_step_seq(2 * ws - 1, ws, 1, ws)
        self.register_buffer('relative_position_index',
                             (coords + coords.T).flip(1).contiguous(),
                             persistent=False)
        self.qkv = Linear(dims, 3 * dims, bias=qkv_bias)
        self.proj = Linear(dims, dims)

    def forward(self, x, mask=None):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = mm_operand(q) @ mm_operand(k).transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(N, N, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(B // nw, nw, self.heads, N, N) \
                + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, N, N)
        attn = attn.softmax(-1)
        x = (mm_operand(attn) @ mm_operand(v)).transpose(1, 2) \
            .reshape(B, N, C)
        return self.proj(x)


class ShiftWindowMSA(nn.Module):

    def __init__(self, dims, heads, ws, shift, qkv_bias, rate):
        super().__init__()
        self.ws, self.shift, self.rate = ws, ws // 2 if shift else 0, rate
        self.w_msa = WindowMSA(dims, heads, ws, qkv_bias)

    def forward(self, x):
        B, H, W, C = x.shape
        ws, s = self.ws, self.shift
        pad_r, pad_b = (ws - W % ws) % ws, (ws - H % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = x.shape[1], x.shape[2]
        mask = None
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
            img_mask = torch.zeros((1, Hp, Wp, 1), device=x.device)
            cnt = 0
            for h in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
                for w in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
                    img_mask[:, h, w, :] = cnt
                    cnt += 1
            mw = window_partition(img_mask, ws).view(-1, ws * ws)
            mask = mw.unsqueeze(1) - mw.unsqueeze(2)
            mask = mask.masked_fill(mask != 0, -100.0) \
                .masked_fill(mask == 0, 0.0)
        windows = window_partition(x, ws).view(-1, ws * ws, C)
        out = self.w_msa(windows, mask).view(-1, ws, ws, C)
        x = window_reverse(out, Hp, Wp, ws)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        return drop_path(x[:, :H, :W], self.rate, self.training)


class FFN(nn.Module):

    def __init__(self, dims, hidden, rate):
        super().__init__()
        self.rate = rate
        self.layers = nn.Sequential(nn.Sequential(Linear(dims, hidden)),
                                    Linear(hidden, dims))

    def forward(self, x, identity):
        out = self.layers[1](F.gelu(self.layers[0][0](x)))
        return identity + drop_path(out, self.rate, self.training)


class SwinBlock(nn.Module):

    def __init__(self, dims, heads, hidden, ws, shift, qkv_bias, rate):
        super().__init__()
        self.norm1 = LayerNorm(dims)
        self.attn = ShiftWindowMSA(dims, heads, ws, shift, qkv_bias, rate)
        self.norm2 = LayerNorm(dims)
        self.ffn = FFN(dims, hidden, rate)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return self.ffn(self.norm2(x), x)


class PatchMerging(nn.Module):

    def __init__(self, cin, cout):
        super().__init__()
        self.sampler = nn.Unfold(kernel_size=2, stride=2)
        self.norm = LayerNorm(4 * cin)
        self.reduction = Linear(4 * cin, cout, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x.permute(0, 3, 1, 2), (0, W % 2, 0, H % 2))
        Ho, Wo = (H + 1) // 2, (W + 1) // 2
        x = self.sampler(x).transpose(1, 2).reshape(B, Ho, Wo, 4 * C)
        return self.reduction(self.norm(x))


class Stage(nn.Module):

    def __init__(self, dims, heads, hidden, depth, ws, qkv_bias, rates,
                 downsample):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dims, heads, hidden, ws, j % 2 == 1, qkv_bias,
                      rates[j]) for j in range(depth)])
        self.downsample = PatchMerging(dims, 2 * dims) if downsample \
            else None


class PatchEmbed(nn.Module):

    def __init__(self, dims, patch, norm):
        super().__init__()
        self.patch = patch
        self.projection = Conv(3, dims, patch, patch)
        self.norm = LayerNorm(dims) if norm else None

    def forward(self, x):
        p = self.patch
        H, W = x.shape[2:]
        x = F.pad(x, (0, (p - W % p) % p, 0, (p - H % p) % p))
        x = self.projection(x).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class SwinTransformer(nn.Module):

    def __init__(self, b: Dict):
        super().__init__()
        depths, heads = b['depths'], b['num_heads']
        self.frozen_stages = b['frozen_stages']
        self.out_indices = tuple(b['out_indices'])
        self.patch_embed = PatchEmbed(b['embed_dims'], b['patch_size'],
                                      b['patch_norm'])
        rates = [x.item() for x in torch.linspace(
            0, b['drop_path_rate'], sum(depths), device='cpu')]
        self.stages = nn.ModuleList()
        dims, begin = b['embed_dims'], 0
        self.widths = []
        for i, depth in enumerate(depths):
            self.stages.append(Stage(
                dims, heads[i], int(b['mlp_ratio'] * dims), depth,
                b['window_size'], b['qkv_bias'], rates[begin:begin + depth],
                i < len(depths) - 1))
            self.widths.append(dims)
            begin += depth
            if i < len(depths) - 1:
                dims *= 2
        for i in self.out_indices:
            self.add_module(f'norm{i}', LayerNorm(self.widths[i]))

    def frozen(self) -> List[nn.Module]:
        if self.frozen_stages < 0:
            return []
        out = [self.patch_embed]
        for i in range(min(self.frozen_stages, len(self.stages))):
            if i in self.out_indices:
                out.append(getattr(self, f'norm{i}'))
            out.append(self.stages[i])
        return out

    def train(self, mode=True):
        super().train(mode)
        for m in self.frozen():
            m.eval()
        return self

    def forward(self, x, remat=False):
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = checkpoint(block, x, use_reentrant=False) if remat \
                    else block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def build(b: Dict) -> SwinTransformer:
    return SwinTransformer(b)


def out_channels(b: Dict) -> List[int]:
    return [b['embed_dims'] * 2 ** i for i in b['out_indices']]


def frozen_prefixes(b: Dict) -> Tuple[str, ...]:
    """The parameters ``frozen_stages`` holds still: the patch embedding,
    and for i < frozen_stages ``norm{i}`` and stage i."""
    k = b['frozen_stages']
    if k < 0:
        return ()
    out = ['backbone.patch_embed.']
    for i in range(min(k, len(b['depths']))):
        if i in b['out_indices']:
            out.append(f'backbone.norm{i}.')
        out.append(f'backbone.stages.{i}.')
    return tuple(out)
