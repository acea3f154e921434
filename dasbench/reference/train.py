"""The reference training step: FCOS-style target assignment, the DAS
loss (focal classification, smooth-L1 depth, the RLE pose loss through
RealNVP flows, centerness BCE) and SGD as the recipe configures it (a
global-norm clip, coupled weight decay, momentum, linear warm-up, bias
learning-rate and decay multipliers, the backbone's frozen stages), in
float32.

The step is dense: every point's RU field is re-sampled, where the
program re-samples only the positives the loss reads, which gives the
same loss. Each of the backbone's regions and each head level is one
checkpointed region, so that the float32 step fits beside nothing else
on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from . import backbones
from .model import DAS, BatchNorm, GroupNorm


# ---------------------------------------------------------------- targets

def level_sizes(H: int, W: int, n: int) -> List[Tuple[int, int]]:
    return [(H // (4 * 2 ** i), W // (4 * 2 ** i)) for i in range(n)]


def assign(batch: Dict[str, torch.Tensor], sizes, cfg: Dict):
    """Per point of every level (level-major, then image, then row-major):
    label (0 person, 1 background), pose target [dx, dy, depth, duvd (3J),
    vis (J)] with dx, dy over the stride, centerness target, stride.

    A point takes the ground truth whose root lies within
    ``center_sample_radius`` strides (a box) and whose farthest visible
    joint lies in the level's regress range; of several, the nearest root
    (the first on a tie)."""
    J = cfg['num_joints']
    poses = batch['gt_poses_3d'].float()                       # (B, G, .)
    centers = batch['gt_centers2d'].float()
    depths = batch['gt_depths'].float()
    valid = batch['gt_valid'].bool()
    B, G = poses.shape[:2]
    dev = poses.device
    uvd = poses[..., 3:3 + 3 * J].reshape(B, G, J, 3)
    vis = poses[..., 3 + 3 * J:]
    duvd = torch.cat([uvd[..., :2] - poses[:, :, None, :2], uvd[..., 2:]], -1)
    reach = (torch.sqrt((duvd[..., :2] ** 2).sum(-1)) * vis).amax(-1)  # (B,G)
    out = dict(labels=[], pose=[], ctr=[], stride=[])
    for (h, w), s, (lo, hi) in zip(sizes, cfg['strides'],
                                   cfg['regress_ranges']):
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing='ij')
        px = (xs.reshape(-1) * s + s // 2).float()
        py = (ys.reshape(-1) * s + s // 2).float()
        dx = px[None, :, None] - centers[:, None, :, 0]        # (B, P, G)
        dy = py[None, :, None] - centers[:, None, :, 1]
        r = s * cfg['center_sample_radius']
        ok = (dx.abs() < r) & (dy.abs() < r) & valid[:, None] \
            & (reach >= lo)[:, None] & (reach <= hi)[:, None]
        dist = torch.where(ok, torch.sqrt(dx ** 2 + dy ** 2),
                           torch.full_like(dx, float('inf')))
        best, g = dist.min(-1)                                 # (B, P)
        pos = torch.isfinite(best)
        bidx = torch.arange(B, device=dev)[:, None]
        sdx = dx.gather(2, g[..., None])[..., 0]
        sdy = dy.gather(2, g[..., None])[..., 0]
        tgt = torch.cat([sdx[..., None] / s, sdy[..., None] / s,
                         depths[bidx, g][..., None],
                         duvd.reshape(B, G, 3 * J)[bidx, g], vis[bidx, g]], -1)
        ctr = torch.exp(-cfg['centerness_alpha'] * torch.sqrt(
            sdx ** 2 + sdy ** 2) / (1.414 * r))
        out['labels'].append(torch.where(pos, 0, 1).reshape(-1))
        out['pose'].append(tgt.reshape(-1, tgt.shape[-1]))
        out['ctr'].append(ctr.reshape(-1))
        out['stride'].append(torch.full((B * h * w,), float(s), device=dev))
    return {k: torch.cat(v) for k, v in out.items()}


# ------------------------------------------------------------------- loss

def _bce_logits(x, t):
    return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def das_loss(model: DAS, levels: List[Dict], tgt: Dict, cfg: Dict,
             max_pos: int) -> Dict[str, torch.Tensor]:
    """The four loss terms of the DAS head over the batch (the first
    ``max_pos`` positives by flat index enter the regression terms)."""
    head = model.bbox_head
    J, zn = cfg['num_joints'], cfg['z_norm']
    N = levels[0]['cls'].shape[0]
    cls = torch.cat([f['cls'].reshape(-1) for f in levels])
    ctr = torch.cat([f['ctr'].reshape(-1) for f in levels])
    pose = torch.cat([torch.cat([f['offset'], f['depth'], f['uvd'],
                                 f['sigma']], -1).reshape(-1, 3 + 6 * J)
                      for f in levels])
    aux = torch.cat([f['refined'].reshape(-1, 3 * J) for f in levels])
    pos = tgt['labels'] == 0
    n_pos = pos.sum().float()

    # focal loss, gamma 2, alpha 0.25, over every point
    t = pos.float()
    p = torch.sigmoid(cls)
    pt = (1 - p) * t + p * (1 - t)
    fw = (0.25 * t + 0.75 * (1 - t)) * pt ** 2
    loss_cls = (_bce_logits(cls, t) * fw).sum() / (n_pos + N)

    k = min(max_pos, pos.numel())
    idx = torch.cat([pos.nonzero()[:, 0], (~pos).nonzero()[:, 0]])[:k]
    sel = pos[idx].float()
    pp, pt_, st = pose[idx], tgt['pose'][idx], tgt['stride'][idx]
    gt_uvd = pt_[:, 3:3 + 3 * J].reshape(k, J, 3)
    is2d = (gt_uvd[..., 2] == 0).all(1)
    w3d = (~is2d).float() * sel
    n3d = w3d.sum()
    cw = cfg['code_weight']

    d = (pp[:, 2] - pt_[:, 2] * cfg['depth_factor']).abs()
    beta = 1.0 / 9.0
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    loss_depth = (sl1 * w3d * cw[2]).sum() / n3d.clamp_min(1.0)
    loss_depth = torch.where(n3d > 0, loss_depth, torch.zeros_like(n3d))

    zero_z = torch.tensor([1.0, 1.0, 0.0], device=pp.device)
    one_z = torch.tensor([0.0, 0.0, 1.0], device=pp.device)
    flat2d = is2d[:, None, None]
    uvd = pp[:, 3:3 + 3 * J].reshape(k, J, 3)
    upd = aux[idx].reshape(k, J, 3)
    uvd = torch.where(flat2d, uvd * zero_z, uvd)
    upd = torch.where(flat2d, upd * zero_z, upd)
    raw_sigma = pp[:, 3 + 3 * J:].reshape(k, J, 3)
    sigma = torch.sigmoid(torch.where(flat2d, raw_sigma * zero_z + one_z,
                                      raw_sigma)) + 1e-9
    shift = torch.cat([pt_[:, :2] * st[:, None],
                       torch.zeros_like(pt_[:, 2:3])], -1)
    real = gt_uvd - shift[:, None]
    real = torch.cat([real[..., :2] / st[:, None, None],
                      real[..., 2:] / zn], -1)
    vis_w = (pt_[:, 3 + 3 * J:] * sel[:, None])[..., None].expand(k, J, 3)

    def log_phi(mu, f3, f2):
        l3 = f3(mu.reshape(-1, 3)).reshape(k, J)
        l2 = f2(mu[..., :2].reshape(-1, 2)).reshape(k, J)
        return torch.where(is2d[:, None], l2, l3)

    if cfg['ru']['prev_loss']:
        lp = torch.cat([
            log_phi((upd - real) / sigma, head.flow3d_update,
                    head.flow2d_update),
            log_phi((uvd - real) / sigma, head.flow3d, head.flow2d)], 1)
        mu, gt, sg = torch.cat([upd, uvd], 1), real.repeat(1, 2, 1), \
            sigma.repeat(1, 2, 1)
        vw = vis_w.repeat(1, 2, 1)
    else:
        lp = log_phi((upd - real) / sigma, head.flow3d, head.flow2d)
        mu, gt, sg, vw = upd, real, sigma, vis_w
    nf = (torch.log(sg) - lp[..., None]) * vw
    res = (gt - mu).abs()
    log_q = torch.log(sg * math.sqrt(2 * math.pi)) + res / (
        math.sqrt(2.0) * sg + 1e-9)
    n_vis = vw[..., 0].sum()
    loss_pose = ((nf + log_q * vw) * cw[3]).sum() / n_vis.clamp_min(1e-9)
    loss_pose = torch.where(n_vis < 1, torch.zeros_like(loss_pose),
                            loss_pose)

    bce = _bce_logits(ctr[idx], tgt['ctr'][idx])
    loss_ctr = (bce * sel).sum() / sel.sum().clamp_min(1e-12)
    has = (n_pos > 0).float()
    return dict(loss_cls=loss_cls, loss_depth=loss_depth * has,
                loss_pose=loss_pose * has, loss_centerness=loss_ctr * has)


# -------------------------------------------------------------------- SGD

def multipliers(model: nn.Module, frozen: Tuple[str, ...]):
    """(lr_mult, wd_mult, trainable) a parameter name: biases outside the
    norms take lr x2 and no decay; frozen prefixes do not move."""
    lr, wd, tr = {}, {}, {}
    for mname, mod in model.named_modules():
        norm = isinstance(mod, (BatchNorm, GroupNorm))
        for pname, _ in mod.named_parameters(recurse=False):
            key = f'{mname}.{pname}' if mname else pname
            bias = pname == 'bias' and not norm
            lr[key] = 2.0 if bias else 1.0
            wd[key] = 0.0 if bias else 1.0
            tr[key] = 0.0 if key.startswith(frozen) else 1.0
    return lr, wd, tr


def learning_rate(opt: Dict, count: int) -> float:
    k = (1 - count / opt['warmup_iters']) * (1 - opt['warmup_ratio'])
    return opt['lr'] * (1 - k if count < opt['warmup_iters'] else 1.0)


def frozen_prefixes(cfg: Dict) -> Tuple[str, ...]:
    """The prefixes of the parameters that training holds still, by the
    rule of the backbone's type."""
    return backbones.find(cfg['backbone']).frozen_prefixes(cfg['backbone'])


class Trainer:
    """The reference's SGD over ``model`` in float32: ``step(batch)``
    returns the loss terms; ``momentum`` holds the optimizer's state."""

    def __init__(self, model: DAS, cfg: Dict, opt: Dict, max_pos: int):
        self.model, self.cfg, self.opt, self.max_pos = model, cfg, opt, \
            max_pos
        self.lr, self.wd, self.tr = multipliers(model, frozen_prefixes(cfg))
        self.momentum = {k: torch.zeros_like(p)
                         for k, p in model.named_parameters()}
        self.count = 0

    def loss(self, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        img = batch['img'].float().flip(-1)
        mean = torch.tensor(cfg['img_norm']['mean'], device=img.device)
        std = torch.tensor(cfg['img_norm']['std'], device=img.device)
        img = (img - mean) / std
        N, H, W, _ = img.shape
        tgt = assign(batch, level_sizes(H, W, len(cfg['strides'])), cfg)
        levels = self.model.train()(img, remat=True)
        return das_loss(self.model, levels, tgt, cfg, self.max_pos)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        params = dict(self.model.named_parameters())
        for p in params.values():
            p.grad = None
        terms = self.loss(batch)
        sum(terms.values()).backward()
        opt = self.opt
        with torch.no_grad():
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in params.items()}
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values())).float()
            clip = torch.clamp(opt['grad_clip'] / (norm + 1e-6), max=1.0)
            rate = learning_rate(opt, self.count)
            for k, p in params.items():
                g = grads[k] * clip + opt['weight_decay'] * self.wd[k] * p
                m = self.momentum[k].mul_(opt['momentum']).add_(g)
                p.sub_(rate * self.lr[k] * self.tr[k] * m)
        self.count += 1
        self.grad_norm = float(norm)
        return {k: float(v.detach()) for k, v in terms.items()}
