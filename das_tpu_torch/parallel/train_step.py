"""The training step, port of ``das_tpu/parallel/train_step.py``.

Optimizer of the reference recipe (ref exp_panoptic.py:201-212,
mmdet_schedule_1x.py), with the JAX step's semantics exactly: a global-norm
gradient clip at 35 over all gradients, frozen ones included; the coupled
weight decay ``g + wd * wd_mult * p``; momentum ``m = 0.9 m + g``; the
update ``p -= lr(count) * lr_mult * trainable * m`` with ``count`` from 0.
Non-norm biases take ``bias_lr_mult=2`` and ``bias_decay_mult=0``; the
learning rate warms up linearly over 250 iterations from 1/3 and drops by
10x at epochs 16 and 20. The backbone's frozen parameters (the prefixes
its ``frozen_prefixes`` gives) are held still by masking their updates;
their gradients still count in the clip, as in the JAX step.

The parameters and batch statistics live in the model, which the step
updates in place (the JAX step returns new trees); ``TrainState`` carries
the model, the step count and the optimizer state. One call does
``(state, batch) -> (state, metrics)``.

With a process group (``make_train_step(..., group)``) each rank steps on
its shard of the global batch, as the JAX step's SPMD program does over its
mesh: BatchNorm and the loss take their moments and normalisers over the
global batch (``parallel/mesh.py``), so each rank's loss is its share of
the global loss, and the gradients are SUMMED over the ranks
(``all_reduce_grads``) before the global-norm clip. ``DistributedDataParallel``
is not used: it averages gradients (the loss would have to be scaled by the
world size) and overlaps its buckets with the backward where this step
needs every gradient summed before the clip anyway.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.targets import get_targets
from ..models.layers import BatchNorm, GroupNorm, LayerNorm
from ..models.mspn import mspn_frozen_prefixes  # noqa: F401 (exported)
from ..utils.profiling import span
from .mesh import all_reduce_grads, sum_over


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Dict


# ------------------------------------------------------------------ sched

def make_lr_fn(base_lr: float, warmup_iters: int = 250,
               warmup_ratio: float = 1.0 / 3,
               step_epochs: Sequence[int] = (16, 20), gamma: float = 0.1,
               steps_per_epoch: int = 1000) -> Callable[[int], float]:
    """mmcv StepLrUpdater + linear warmup (ref exp_panoptic.py:207-212)."""
    milestones = [e * steps_per_epoch for e in step_epochs]

    def lr_fn(step: int) -> float:
        step = float(step)
        k = (1.0 - step / warmup_iters) * (1.0 - warmup_ratio)
        warm = 1.0 - k if step < warmup_iters else 1.0
        decay = gamma ** sum(step >= m for m in milestones)
        return base_lr * warm * decay

    return lr_fn


# -------------------------------------------------------------- optimizer

def param_groups(model: nn.Module, bias_lr_mult: float = 2.0,
                 bias_decay_mult: float = 0.0
                 ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(lr_mult, wd_mult) per parameter name, as mmcv's
    DefaultOptimizerConstructor: a bias outside a norm gets
    ``bias_lr_mult`` / ``bias_decay_mult``. A norm is told by its module
    type (the reference's names ``bn1``..``bn3`` say it too)."""
    lr_mult, wd_mult = {}, {}
    for mod_name, mod in model.named_modules():
        is_norm = isinstance(mod, (BatchNorm, GroupNorm, LayerNorm))
        for name, _ in mod.named_parameters(recurse=False):
            key = f'{mod_name}.{name}' if mod_name else name
            bias = name == 'bias' and not is_norm
            lr_mult[key] = bias_lr_mult if bias else 1.0
            wd_mult[key] = bias_decay_mult if bias else 1.0
    return lr_mult, wd_mult


def frozen_mask(model: nn.Module, frozen_prefixes: Sequence[str]
                ) -> Dict[str, float]:
    """1.0 for trainable parameters, 0.0 for frozen ones."""
    return {k: 0.0 if any(k.startswith(f) for f in frozen_prefixes) else 1.0
            for k, _ in model.named_parameters()}


def make_optimizer(model: nn.Module, lr_fn: Callable[[int], float],
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   grad_clip: float = 35.0, bias_lr_mult: float = 2.0,
                   bias_decay_mult: float = 0.0,
                   frozen_prefixes: Sequence[str] = ()):
    """``(tx_init, tx_update)`` over the model's named parameters.

    ``tx_update(grads, opt_state, params)`` returns ``(updates, opt_state,
    grad_norm)``: dicts by parameter name, the new state, and the global
    norm before the clip (a 0-d tensor; no host sync).
    """
    lr_mult, wd_mult = param_groups(model, bias_lr_mult, bias_decay_mult)
    trainable = frozen_mask(model, frozen_prefixes)

    def tx_init(params: Dict[str, torch.Tensor]) -> Dict:
        return dict(momentum={k: torch.zeros_like(p)
                              for k, p in params.items()}, count=0)

    def tx_update(grads, opt_state, params):
        keys = list(params)
        g = [grads[k] for k in keys]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
        g = torch._foreach_mul(g, scale)
        decayed = [i for i, k in enumerate(keys) if wd_mult[k] != 0.0]
        for i in decayed:
            g[i].add_(params[keys[i]], alpha=weight_decay * wd_mult[keys[i]])
        mom = [opt_state['momentum'][k] for k in keys]
        torch._foreach_mul_(mom, momentum)
        torch._foreach_add_(mom, g)
        lr = lr_fn(opt_state['count'])
        updates = {k: m * (-lr * lr_mult[k] * trainable[k])
                   for k, m in zip(keys, mom)}
        return updates, dict(momentum=dict(zip(keys, mom)),
                             count=opt_state['count'] + 1), gnorm

    return tx_init, tx_update


# ------------------------------------------------------------- train step

def make_train_step(tx_update, featmap_sizes, strides, regress_ranges,
                    num_joints: int, center_sample_radius: float = 1.5,
                    centerness_alpha: float = 2.5, bg_label: int = 1,
                    max_pos: int = 1024, img_norm=None, group=None):
    """The step ``(state, batch) -> (state, metrics)``.

    ``batch`` is the TrainLoader's: NHWC images plus padded GT arrays,
    img (B,H,W,3), gt_poses_3d (B,G,3+4J), gt_centers2d (B,G,2),
    gt_depths (B,G), gt_valid (B,G); numpy arrays or tensors, moved to the
    model's device. ``img_norm`` (mean, std, to_rgb) normalises the images
    there. Only ``loss*`` terms are summed and optimised; ``metrics`` holds
    the total, ``grad_norm`` and every term the loss returns (``pos_overflow``
    too), as 0-d tensors on the device.

    With ``group`` the batch is this rank's shard, ``max_pos`` the global
    budget, and the metrics are sums over the ranks (``grad_norm``, of the
    summed gradients, is the same on every rank); the model must have been
    ``replicate``d over ``group``.
    """
    featmap_sizes = [tuple(s) for s in featmap_sizes]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with span('das.train.step'):
            return step(state, batch)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.model.train()
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        img = batch['img'].float()
        if img_norm is not None:
            if img_norm.get('to_rgb', False):
                img = img.flip(-1)
            mean = torch.tensor(img_norm['mean'], dtype=torch.float32,
                                device=dev)
            std = torch.tensor(img_norm['std'], dtype=torch.float32,
                               device=dev)
            img = (img - mean) / std
        with span('das.train.targets'):
            targets = get_targets(
                featmap_sizes, strides, regress_ranges, batch['gt_poses_3d'],
                batch['gt_centers2d'], batch['gt_depths'], batch['gt_valid'],
                num_joints, center_sample_radius, centerness_alpha, bg_label)
        for p in params.values():
            p.grad = None
        losses = model.loss(img, targets, max_pos, group=group)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        with span('das.train.backward'):
            total.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        if group is not None:
            all_reduce_grads(grads.values(), group)
        with torch.no_grad(), span('das.train.optimizer'):
            updates, opt_state, gnorm = tx_update(grads, state.opt_state,
                                                  params)
            for k, p in params.items():
                p.add_(updates[k])
        summed = dict(loss=total.detach(),
                      **{k: v.detach() for k, v in losses.items()})
        summed = dict(zip(summed, sum_over(group, *summed.values())))
        metrics = dict(loss=summed.pop('loss'), grad_norm=gnorm, **summed)
        return TrainState(state.step + 1, model, opt_state), metrics

    return train_step
