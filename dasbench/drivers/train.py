"""Training driver: the program's train step, set up as ``train_model``
sets it (``make_trainer``, glue copied from the program's
``tools/profile_train.py``: the recipe's SGD, schedule and positive
budget, and the frozen stages by the reference backbone's rule), stepped
back to back on a pool of synthetic batches on the device, with no
loader and no synchronise between steps: the window closes with one.

Set-up loads the seed's weights, then drives the step's first steps
through the same call and feed as the window, each on another batch,
and keeps what the reference follows: each step's loss terms, the
momentum after step 1 and the parameters after the last (on the host),
and, of step 1, the call of the program's bilinear sampler backward with
the most points: its arguments and what it returned (recorded by
wrapping the program's launcher for that step only).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from .. import check, weights
from ..reference import train as ref_train

# one person in every four reaches this far (px) from its root: a
# positive in each of the shipped head's regress ranges
REACH = (40.0, 120.0, 240.0, 480.0)


def synthetic_batch(B: int, H: int, W: int, J: int, root: int, people: int,
                    gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A batch in the loader's format, made on the device: raw pixels in
    [0, 255] and ``people`` ground truths an image, whose farthest
    visible joint lies ``REACH[g % 4]`` px from the root; the root joint
    on the center, about 10% of the other joints invisible, depths 2-6."""
    G = people

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=device)
    lo = torch.tensor([0.1 * W, 0.1 * H], device=device)
    centers = lo + u(B, G, 2) * torch.tensor([0.8 * W, 0.8 * H],
                                             device=device)
    reach = torch.tensor(REACH, device=device)[torch.arange(G) % len(REACH)]
    radius = (0.2 + 0.8 * u(B, G, J)) * reach[None, :, None]
    far = (root + 1) % J
    radius[..., root] = 0.0
    radius[..., far] = reach[None, :]
    ang = u(B, G, J) * (2 * math.pi)
    joints = centers[:, :, None] + radius[..., None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], -1)
    dz = torch.randn(B, G, J, generator=gen, device=device) * 0.3
    dz[..., root] = 0.0
    vis = (u(B, G, J) > 0.1).float()
    vis[..., root] = 1.0
    vis[..., far] = 1.0
    depths = 2.0 + 4.0 * u(B, G)
    poses = torch.cat([centers, depths[..., None], torch.cat(
        [joints, dz[..., None]], -1).reshape(B, G, 3 * J), vis], -1)
    # a smooth scene a frame, each with its own brightness and contrast,
    # plus pixel noise, in [0, 255]
    scene = torch.nn.functional.interpolate(
        u(B, 3, max(1, H // 32), max(1, W // 32)), size=(H, W),
        mode='bilinear', align_corners=False)
    level, spread = 255 * u(B, 1, 1, 1), 255 * u(B, 1, 1, 1)
    img = (level + (scene - 0.5) * spread
           + 8 * torch.randn(B, 3, H, W, generator=gen, device=device))
    img = img.clamp(0, 255).permute(0, 2, 3, 1).contiguous()
    return dict(img=img, gt_poses_3d=poses,
                gt_centers2d=centers, gt_depths=depths,
                gt_valid=torch.ones(B, G, dtype=torch.bool, device=device))


def make_trainer(cfg, dtype, device, batch: int, hw):
    """(model, tx_init, step, max_pos) as ``train_model`` sets them up for
    ``cfg`` (the program's ``tools/profile_train.make_trainer``, one
    process, 1000 steps an epoch). The parameters held still are those of
    the reference's rule for ``cfg``'s backbone (``reference.train.
    frozen_prefixes``), the tuple the reference's trainer takes."""
    from das_tpu_torch.models import build_trainable_model
    from das_tpu_torch.parallel import (make_lr_fn, make_optimizer,
                                        make_train_step)
    model = build_trainable_model(cfg.model, dtype=dtype, device=device)
    head = cfg.model.bbox_head
    opt = dict(cfg.get('optimizer') or {})
    lr_cfg = dict(cfg.get('lr_config') or {})
    clip = (cfg.get('optimizer_config') or {}).get('grad_clip') or {}
    lr_fn = make_lr_fn(float(opt.get('lr', 2e-3)),
                       warmup_iters=int(lr_cfg.get('warmup_iters', 250)),
                       warmup_ratio=float(lr_cfg.get('warmup_ratio', 1 / 3)),
                       step_epochs=tuple(lr_cfg.get('step', (16, 20))))
    tx_init, tx_update = make_optimizer(
        model, lr_fn, momentum=float(opt.get('momentum', 0.9)),
        weight_decay=float(opt.get('weight_decay', 1e-4)),
        grad_clip=float(clip.get('max_norm', 35.0)),
        frozen_prefixes=ref_train.frozen_prefixes(cfg.model))
    H, W = hw
    featmaps = [(H // (4 * 2 ** i), W // (4 * 2 ** i))
                for i in range(len(head.strides))]
    max_pos = int((cfg.model.get('train_cfg') or {}).get('max_pos',
                                                          128 * batch))
    step = make_train_step(
        tx_update, featmaps, tuple(head.strides),
        tuple(tuple(r) for r in head.regress_ranges), int(head.num_joints),
        center_sample_radius=float(head.get('center_sample_radius', 1.5)),
        max_pos=max_pos, img_norm=cfg.get('img_norm_cfg'))
    return model, tx_init, step, max_pos


class LargestSamplerBackward:
    """While active, the program's sampler backward (its card launcher and
    its CPU closed form) records, of the calls whose incoming gradient is
    not all zero, the one with the most points times channels an image
    (the 'clip' DCN's on the largest level that has positives; the RU's
    calls have more rows of a few channels): its arguments and its
    results, cloned. What the call returns is unchanged."""

    NAMES = ('sample_rows_bilinear_backward_cuda',
             'sample_rows_bilinear_backward_plain')

    def __enter__(self):
        from das_tpu_torch.ops import gather
        self.gather, self.kept = gather, None
        self.real = {n: getattr(gather, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(gather, n, self._recording(self.real[n]))
        return self

    def _recording(self, fn):
        def recorded(grad, flat, x, y, H, W, needs=(True, True, True)):
            out = fn(grad, flat, x, y, H, W, needs)
            key = (bool(grad.any()), grad[0].numel())
            if self.kept is None or key > self.kept['key']:
                self.kept = dict(
                    key=key,
                    grad=grad.clone(), flat=flat.clone(), x=x.clone(),
                    y=y.clone(), H=H, W=W, needs=tuple(needs),
                    out=[None if t is None else t.clone() for t in out])
            return out
        return recorded

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.gather, n, fn)

    def on_host(self):
        k = self.kept
        if k is None:
            return None
        return dict(k, **{n: k[n].cpu() for n in ('grad', 'flat', 'x', 'y')},
                    out=[None if t is None else t.cpu() for t in k['out']])


class Cell:
    """The program's train step for one configuration and mix."""

    def __init__(self, ctx):
        from das_tpu_torch.config import Config
        self.ctx, self.cfg, self.p = ctx, ctx.config, ctx.traffic['params']
        self.B = int(self.p['batch'])
        self.hw = tuple(self.cfg['train_hw'])
        cfg = Config.fromfile(str(ctx.root / self.cfg['repo_config']))
        self.model, self.tx_init, self.step, self.max_pos = make_trainer(
            cfg, getattr(torch, self.cfg['compute_dtype']), ctx.device, self.B,
            self.hw)

    def load(self, seed: int):
        """The seed's weights, a fresh optimizer state, the seed's pool."""
        from das_tpu_torch.parallel import TrainState
        ctx, m = self.ctx, self.cfg['model']
        self.model.load_state_dict(weights.make_state(
            m, self.cfg['assumed']['weights'], seed, ctx.device), strict=True)
        self.state = TrainState(0, self.model, self.tx_init(
            dict(self.model.named_parameters())))
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed((int(seed) * 40503 + 7) % 2 ** 63)
        self.pool = [synthetic_batch(self.B, *self.hw, m['num_joints'],
                                     m['root_idx'], int(self.p['people']),
                                     gen, ctx.device)
                     for _ in range(int(self.p['pool']))]

    def first_steps(self) -> Dict:
        """The first steps, each on another batch of the pool: their loss
        terms, the momentum and the running statistics after step 1, the
        parameters after the last, step 1's largest sampler backward."""
        losses, m1 = [], None
        for i in range(int(self.p['first_steps'])):
            if i == 0:
                with LargestSamplerBackward() as rec:
                    self.state, metrics = self.step(self.state, self.pool[i])
                sampler = rec.on_host()
            else:
                self.state, metrics = self.step(self.state, self.pool[i])
            losses.append({k: float(v) for k, v in metrics.items()
                           if k.startswith('loss_')})
            if m1 is None:
                m1 = {k: v.detach().to('cpu', copy=True) for k, v in
                      self.state.opt_state['momentum'].items()}
                grad_norm = float(metrics['grad_norm'])
                bn1 = {k: v.to('cpu', copy=True) for k, v in
                       self.model.named_buffers() if k.endswith(
                           ('running_mean', 'running_var'))}
        p3 = {k: v.detach().to('cpu', copy=True)
              for k, v in self.model.named_parameters()}
        return dict(losses=losses, m1=m1, p3=p3, grad_norm=grad_norm,
                    bn1=bn1, sampler=sampler)

    def window(self, seconds: float, opened=None):
        """Steps back to back for ``seconds`` (the host's clock), then one
        synchronise. Returns (steps, seconds, steps whose loss is not
        finite)."""
        n, first = 0, int(self.p['first_steps'])
        losses: List[torch.Tensor] = []
        t0 = opened() if opened else time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.state, metrics = self.step(
                self.state, self.pool[(first + n) % len(self.pool)])
            losses.append(metrics['loss'])
            n += 1
        self.ctx.sync()
        secs = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return n, secs, bad

    def free(self):
        del self.model, self.state, self.step


def run(ctx) -> Dict:
    from das_tpu_torch.ops import gather

    cell = Cell(ctx)
    cell.load(ctx.seed)
    first = cell.first_steps()
    batches = [cell.pool[i] for i in range(int(cell.p['first_steps']))]
    ctx.sync()
    setup_peak = ctx.memory_peak()
    ctx.reset_peak()

    def counts():
        return (gather.launches, gather.backward_launches,
                gather.sampler_launches, gather.sampler_backward_launches)
    before = counts()
    n, secs, bad = cell.window(ctx.seconds, ctx.open_window)
    ctx.close_window()
    peak = ctx.memory_peak()
    per = [(a - b) / n for a, b in zip(counts(), before)]
    names = ('gather', 'adjoint', 'sampler', 'sampler_backward')
    expect = [float(ctx.config['launches']['train'][k]) for k in names]
    ctx.log(f'window: {n} steps in {secs:.4f} s; launches a step: '
            f'{dict(zip(names, per))} (expected {expect}); peak '
            f'{peak} bytes; first steps {first["losses"]}')
    out = dict(
        e2e=dict(train_img_s=cell.B * n / secs,
                 train_peak_gib=peak / 2 ** 30, setup_s=ctx.setup_s),
        samples=dict(train_img_s=n, train_peak_gib=n),
        attempted=n, failed=bad, memory_peak_bytes=max(peak, setup_peak))
    if ctx.trace:
        def traced(i):
            cell.state, _ = cell.step(cell.state,
                                      cell.pool[i % len(cell.pool)])
        tr = ctx.profile(traced, int(cell.p['profile_steps']))
        out.update(trace=tr, record=dict(
            kind='train', config=ctx.config, batch=cell.B, hw=cell.hw,
            max_pos=cell.max_pos, trace=tr,
            window=dict(units=n, seconds=secs), launches_ok=per == expect))
    cell.free()
    ctx.empty_cache()
    out['checks'] = check.train(ctx.config, ctx.seed, first, batches,
                                ctx.device)
    return out

