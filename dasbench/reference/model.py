"""The plain reference model: a backbone found by its type, FPN neck and
the DAS head with its recursive update (RU), in plain PyTorch and float32.

It follows the published DAS recipe (wangzt-halo/das: the backbone as
its configuration names it, one module a type under ``backbones/``, FPN
from mmdet, the DAS head and RU) and owes nothing to the program: the
deformable convolutions and every re-sampling are four-corner bilinear
gathers written out here, the RU fuses its candidates with a softmax, and
the eval head computes the RU densely, giving both the gated field and
the re-sampled one at every point (the program re-samples only the
decode's candidates; ``dasbench.check`` picks the right one at each
point). Modules carry the reference's torch key names, so one state dict
loads ``strict=True`` into this model and into the program alike.

Images are NCHW here; head outputs are NHWC, as the program returns them.
``precision.mm_operand`` rounds the operands of every convolution and
product where the control asks it to. The layers below (``Conv``,
``BatchNorm``, ``GroupNorm``, ``ConvModule``) are the ones a backbone
builds from.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import backbones
from .precision import mm_operand


def conv(x, weight, bias=None, stride=1, padding=0):
    return F.conv2d(mm_operand(x), mm_operand(weight), bias, stride, padding)


class Conv(nn.Module):
    """A convolution holding ``weight`` (Cout, Cin, k, k) and ``bias``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Eval: the running statistics. Train: the batch's, biased variance;
    the buffers do not move (``dasbench.check`` folds ``moments`` into
    them where it compares them)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.empty(c))
        self.register_buffer('running_var', torch.empty(c))

    def forward(self, x):
        if self.training:
            mean = x.mean((0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
            self.moments = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5)
        return (x - mean[:, None, None]) * (inv * self.weight)[:, None, None] \
            + self.bias[:, None, None]


class GroupNorm(nn.Module):

    def __init__(self, groups, c):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        N, C, H, W = x.shape
        g = x.reshape(N, self.groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g - mean) ** 2).mean(-1, keepdim=True)
        g = (g - mean) * torch.rsqrt(var + 1e-5)
        return g.reshape(N, C, H, W) * self.weight[:, None, None] \
            + self.bias[:, None, None]


def bilinear(flat, x, y, H, W):
    """Zero-padded bilinear sample of ``flat`` (N, H*W, C) at pixel
    coordinates ``x``, ``y`` (N, P), pixel centres at integers. Returns
    (N, P, C)."""
    C = flat.shape[-1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        row = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        v = torch.gather(flat, 1, row[..., None].expand(*row.shape, C))
        out = out + v * (w * inside)[..., None]
    return out


def recomputed(fn, *args):
    """``fn(*args)``; where autograd records, as a checkpointed region
    that keeps only its inputs and recomputes the rest in the backward
    (the float32 reference's corner rows would not fit otherwise)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def sample(flat, x, y, H, W):
    """``bilinear``, recomputed in the backward."""
    return recomputed(bilinear, flat, x, y, H, W)


class DeformConv2d(nn.Module):
    """DCNv2 (mmcv's pack layer), 3x3, stride 1, padding 1: ``conv_offset``
    gives per tap (dy, dx) and a mask logit."""

    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.conv_offset = Conv(cin, 27, 3, 1, 1)

    @staticmethod
    def _tap(flat, raw, mask, weight, k, H, W):
        """Tap k's share of the output: the image sampled at the tap's
        offset positions, times its mask, times its weight."""
        kh, kw = divmod(k, 3)
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=flat.dtype, device=flat.device),
            torch.arange(W, dtype=flat.dtype, device=flat.device),
            indexing='ij')
        tap = bilinear(flat,
                       xs.reshape(1, -1) + (kw - 1) + raw[..., 2 * k + 1],
                       ys.reshape(1, -1) + (kh - 1) + raw[..., 2 * k], H, W)
        return mm_operand(tap * mask[..., k:k + 1]) \
            @ mm_operand(weight[:, :, kh, kw]).t()

    def forward(self, x):
        N, C, H, W = x.shape
        raw = self.conv_offset(x).permute(0, 2, 3, 1).reshape(N, H * W, 27)
        mask = torch.sigmoid(raw[..., 18:])
        flat = x.permute(0, 2, 3, 1).reshape(N, H * W, C)
        out = 0
        for k in range(9):
            out = out + recomputed(self._tap, flat, raw, mask, self.weight, k,
                                   H, W)
        if self.bias is not None:
            out = out + self.bias
        return out.reshape(N, H, W, -1).permute(0, 3, 1, 2)


class ConvModule(nn.Module):
    """conv -> norm -> relu, mmcv's ConvModule: ``bias`` defaults to
    "no norm"; ``norm`` is 'bn', 'gn' or None."""

    def __init__(self, cin, cout, k, stride=1, padding=0, norm='bn',
                 relu=True, bias=None, dcn=False):
        super().__init__()
        bias = norm is None if bias is None else bias
        self.conv = DeformConv2d(cin, cout, bias) if dcn \
            else Conv(cin, cout, k, stride, padding, bias)
        self.norm_name = norm
        if norm == 'bn':
            self.bn = BatchNorm(cout)
        elif norm == 'gn':
            self.gn = GroupNorm(32, cout)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        return F.relu(x) if self.relu else x


class FPN(nn.Module):

    def __init__(self, cin, cout):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, cout, 1, relu=False) for c in cin])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(cout, cout, 3, 1, 1, relu=False) for _ in cin])

    def forward(self, inputs):
        lat = [c(x) for c, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode='nearest')
        return [c(x) for c, x in zip(self.fpn_convs, lat)]


# ------------------------------------------------------------ DAS head

class RealNVP(nn.Module):
    """RealNVP log-density with six coupling layers (RLE's flow)."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        masks = [[0, 0, 1], [1, 1, 0]] * 3 if dim == 3 \
            else [[0, 1], [1, 0]] * 3
        self.register_buffer('mask', torch.tensor(masks, dtype=torch.float32),
                             persistent=False)

        def mlp(tanh):
            m = [nn.Linear(dim, 64), nn.LeakyReLU(0.01), nn.Linear(64, 64),
                 nn.LeakyReLU(0.01), nn.Linear(64, dim)]
            return nn.Sequential(*(m + [nn.Tanh()] if tanh else m))
        self.s = nn.ModuleList([mlp(True) for _ in masks])
        self.t = nn.ModuleList([mlp(False) for _ in masks])

    def forward(self, x):
        z, log_det = x, 0
        for i in reversed(range(len(self.mask))):
            m = self.mask[i]
            s = self.s[i](m * z) * (1 - m)
            t = self.t[i](m * z) * (1 - m)
            z = (1 - m) * (z - t) * torch.exp(-s) + m * z
            log_det = log_det - s.sum(1)
        return -0.5 * (z ** 2).sum(1) - 0.5 * self.dim * math.log(
            2 * math.pi) + log_det


class Scale(nn.Module):

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(()))

    def forward(self, x):
        return x * self.scale


class NextLevelOffset(nn.Module):

    def __init__(self, ch, J, heads, D):
        super().__init__()
        self.update_feat_conv = ConvModule(ch, ch, 3, 1, 1, norm='gn',
                                           dcn=True)
        self.sampling_offset = Conv(ch, J * heads * 2, 1)
        self.sampling_conf = Conv(ch, J * D, 1)
        self.update_weight = Conv(ch, J * D, 1)
        self.update_offset_value = Conv(ch, J * D, 1)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _fold(x, J, c):
    N, H, W, _ = x.shape
    return x.reshape(N, H, W, J, c).permute(0, 3, 1, 2, 4) \
        .reshape(N * J, H, W, c)


def offset_sample(uvd, samp, conf, J, heads, D):
    """The RU's re-sampling at every point: each joint's 2*heads candidate
    positions (from the proposed target and from the source), their
    [uvd, conf] sampled there, and a softmax over the candidates' conf,
    per dim. uvd, conf (N, H, W, J*D); samp (N, H, W, J*heads*2)."""
    N, H, W, _ = uvd.shape
    u, s, c = _fold(uvd, J, D), _fold(samp, J, heads * 2), _fold(conf, J, D)
    NJ = N * J
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=uvd.dtype, device=uvd.device),
        torch.arange(W, dtype=uvd.dtype, device=uvd.device), indexing='ij')
    to_target = u[..., :2]                                   # (NJ,H,W,2)
    from_target = sample(
        s.reshape(NJ, H * W, -1), (xs + to_target[..., 0]).reshape(NJ, -1),
        (ys + to_target[..., 1]).reshape(NJ, -1), H, W) \
        .reshape(NJ, H, W, heads, 2) + to_target[..., None, :]
    cand = torch.cat([from_target, s.reshape(NJ, H, W, heads, 2)], 3)
    sx = (xs[..., None] + cand[..., 0]).reshape(NJ, -1)
    sy = (ys[..., None] + cand[..., 1]).reshape(NJ, -1)
    vals = sample(torch.cat([u, c], -1).reshape(NJ, H * W, 2 * D), sx, sy,
                    H, W).reshape(NJ, H, W, 2 * heads, 2 * D)
    shift = cand if D == 2 else torch.cat(
        [cand, torch.zeros_like(cand[..., :1])], -1)
    w = torch.softmax(vals[..., D:], dim=3)
    fused = (w * (vals[..., :D] + shift)).sum(3)            # (NJ,H,W,D)
    return fused.reshape(N, J, H, W, D).permute(0, 2, 3, 1, 4) \
        .reshape(N, H, W, J * D)


class RULayer(nn.Module):

    def __init__(self, ch, J, heads, D):
        super().__init__()
        self.J, self.heads, self.D = J, heads, D
        self.next_level_offset = NextLevelOffset(ch, J, heads, D)

    def forward(self, feat, prev):
        m = self.next_level_offset
        feat = feat + m.update_feat_conv(feat)
        samp = _nhwc(m.sampling_offset(feat))
        conf = _nhwc(m.sampling_conf(feat))
        w = torch.sigmoid(_nhwc(m.update_weight(feat)))
        gated = (1 - w) * prev + w * _nhwc(m.update_offset_value(feat))
        return feat, gated, offset_sample(gated, samp, conf, self.J,
                                          self.heads, self.D)


class RecursiveUpdateBranch(nn.Module):

    def __init__(self, J, heads, cin, ch, layers, D):
        super().__init__()
        self.num_layers = layers
        self.reduction = ConvModule(cin, ch, 1, norm='gn')
        for i in range(layers):
            self.add_module(f'layer_{i}', RULayer(ch, J, heads, D))

    def forward(self, feat, offset):
        """(the last layer's gated field, its re-sampled field)."""
        feat = self.reduction(feat)
        gated = offset
        for i in range(self.num_layers):
            feat, gated, offset = getattr(self, f'layer_{i}')(feat, offset)
        return gated, offset


class DASHead(nn.Module):

    def __init__(self, cfg: Dict):
        super().__init__()
        J, ch = cfg['num_joints'], cfg['feat_channels']
        self.cfg = cfg
        kw = dict(norm='gn', bias=True)

        def tower():
            n = cfg['stacked_convs']
            return nn.ModuleList([
                ConvModule(ch, ch, 3, 1, 1, dcn=i == n - 1, **kw)
                for i in range(n)])

        def branch(chans):
            mods, cin = [], ch
            for c in chans:
                mods.append(ConvModule(cin, c, 3, 1, 1, **kw))
                cin = c
            return nn.ModuleList(mods)
        reg = cfg['reg_branch']
        self.cls_convs, self.reg_convs, self.pose_convs = \
            tower(), tower(), tower()
        self.conv_cls_prev = branch(cfg['cls_branch'])
        self.conv_cls = Conv(cfg['cls_branch'][-1], 1, 1)
        self.conv_reg_prevs = nn.ModuleList([branch(reg[i]) for i in (0, 1)])
        self.conv_regs = nn.ModuleList(
            [Conv(reg[0][-1], 2, 1), Conv(reg[1][-1], 1, 1)])
        self.conv_pose_prevs = nn.ModuleList([branch(reg[i]) for i in (2, 3)])
        self.conv_poses = nn.ModuleList(
            [Conv(reg[2][-1], 3 * J, 1), Conv(reg[3][-1], 3 * J, 1)])
        self.conv_centerness_prev = branch(cfg['centerness_branch'])
        self.conv_centerness = Conv(cfg['centerness_branch'][-1], 1, 1)
        self.scales = nn.ModuleList([
            nn.ModuleList([Scale() for _ in range(4)])
            for _ in cfg['strides']])
        ru = cfg['ru']
        self.recursive_update_branch = RecursiveUpdateBranch(
            J, ru['num_heads'], ch, ch, ru['num_layers'], ru['dim'])
        self.flow3d, self.flow2d = RealNVP(3), RealNVP(2)
        self.flow3d_update, self.flow2d_update = RealNVP(3), RealNVP(2)

    @staticmethod
    def _run(mods, x):
        for m in mods:
            x = m(x)
        return x

    def level(self, x, lvl):
        """One level's fields, NHWC: cls, ctr, offset, depth, the raw uvd
        and sigma (root pinned), the RU's gated and re-sampled uvd."""
        cfg, J, root = self.cfg, self.cfg['num_joints'], self.cfg['root_idx']
        cls_feat = self._run(self.cls_convs, x)
        reg_feat = self._run(self.reg_convs, x)
        pose_feat = self._run(self.pose_convs, x)
        cls = self.conv_cls(self._run(self.conv_cls_prev, cls_feat))
        preds = [self.conv_regs[i](self._run(self.conv_reg_prevs[i], reg_feat))
                 for i in (0, 1)] + [
            self.conv_poses[i](self._run(self.conv_pose_prevs[i], pose_feat))
            for i in (0, 1)]
        ctr = self.conv_centerness(self._run(self.conv_centerness_prev,
                                             reg_feat))
        s_off, s_depth, s_uv, s_d = self.scales[lvl]
        N, _, H, W = x.shape
        uvd = _nhwc(preds[2]).reshape(N, H, W, J, 3)
        uvd = torch.cat([s_uv(uvd[..., :2]), s_d(uvd[..., 2:])], -1)
        pin = torch.ones(J, 3, dtype=x.dtype, device=x.device)
        pin[root, 2] = 0
        uvd = uvd * pin
        sigma = _nhwc(preds[3]).reshape(N, H, W, J, 3) * pin \
            + (1 - pin)
        gated, refined = self.recursive_update_branch(
            pose_feat, uvd.reshape(N, H, W, 3 * J))
        return dict(
            cls=_nhwc(cls), ctr=_nhwc(ctr), offset=s_off(_nhwc(preds[0])),
            depth=s_depth(_nhwc(preds[1])), uvd=uvd.reshape(N, H, W, 3 * J),
            sigma=sigma.reshape(N, H, W, 3 * J),
            gated=(gated.reshape(N, H, W, J, 3) * pin).reshape(N, H, W, -1),
            refined=(refined.reshape(N, H, W, J, 3) * pin)
            .reshape(N, H, W, -1))


class DAS(nn.Module):
    """backbone -> FPN -> DAS head, built from a dasbench config's
    ``model`` section; the backbone by its ``type``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        b = cfg['backbone']
        kind = backbones.find(b)
        self.backbone = kind.build(b)
        self.neck = FPN(kind.out_channels(b), cfg['feat_channels'])
        self.bbox_head = DASHead(cfg)

    def forward(self, img, remat=False):
        """img (N, H, W, 3) normalised -> one dict of fields a level."""
        feats = self.neck(self.backbone(img.permute(0, 3, 1, 2), remat))
        if remat:
            return [checkpoint(self.bbox_head.level, f, i,
                               use_reentrant=False)
                    for i, f in enumerate(feats)]
        return [self.bbox_head.level(f, i) for i, f in enumerate(feats)]


def eval_outputs(levels: List[Dict], cfg: Dict) -> List[Dict]:
    """The eval head's outputs a level, in the program's units: depth over
    ``depth_factor``, uv times the stride and z times ``z_norm`` for both
    RU fields."""
    out = []
    for f, s in zip(levels, cfg['strides']):
        J = cfg['num_joints']
        unit = torch.tensor([s, s, cfg['z_norm']], dtype=f['cls'].dtype,
                            device=f['cls'].device).repeat(J)
        out.append(dict(cls=f['cls'], ctr=f['ctr'], offset=f['offset'],
                        depth=f['depth'] / cfg['depth_factor'],
                        sigma=f['sigma'], gated=f['gated'] * unit,
                        refined=f['refined'] * unit))
    return out


def build(cfg: Dict, device=None) -> DAS:
    """The reference model with uninitialised weights (load a state dict)."""
    with torch.device(device or 'cpu'):
        return DAS(cfg)


def sparse_select(cls: torch.Tensor, ctr: torch.Tensor, k: int
                  ) -> Optional[torch.Tensor]:
    """(N, H*W) bool: the points whose uvd the program re-samples at eval
    (the ``k`` best by sigmoid(cls) * sigmoid(ctr), as its decode ranks
    them), or None where a level has at most ``k`` points (all are)."""
    N = cls.shape[0]
    ranked = (torch.sigmoid(cls.float()) * torch.sigmoid(ctr.float())) \
        .reshape(N, -1)
    if ranked.shape[1] <= k:
        return None
    idx = torch.topk(ranked, k, dim=1).indices
    sel = torch.zeros_like(ranked, dtype=torch.bool)
    sel.scatter_(1, idx, True)
    return sel
