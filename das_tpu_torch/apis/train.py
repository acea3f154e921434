"""The training loop, port of ``das_tpu/apis/train.py`` (ref:
mmdet3d/apis/train.py:6-35 + mmcv EpochBasedRunner with its hook set —
SURVEY.md §1 layer 3).

The mmcv runner/hook machinery collapses into one explicit loop: the LR
schedule and the gradient clip live in the optimizer; logging,
checkpointing, the DCN-offset check and evaluation are plain host-side
calls between steps. State is checkpointed by ``checkpoint/manager.py``
(replacing mmcv CheckpointHook).

On one card, or data-parallel over a process group (``group``; one process
a card, as ``torchrun`` starts them): each rank loads its shard of every
epoch, steps on ``samples_per_gpu`` images of the global batch of
``samples_per_gpu x world size``, and keeps a bit-equal replica of the
model (``parallel/mesh.py``). Rank 0 writes the checkpoints, ``meta.json``
and the logs; every rank runs the DCN-offset check and its shard of the
eval hook. Every rank enters the same collectives in the same order.

The loop keeps the card fed as the JAX one does: the step counter lives on
the host (reading ``state.step`` from the card every step would wait for
the step), metrics become floats only on the log interval, and each batch
goes onto the card one step ahead (``prefetch_to_device``: a ring of pinned
host buffers copied on a side stream while the current step computes).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from .. import __version__
from ..checkpoint import (CheckpointManager, load_checkpoint_report,
                          load_mspn_pretrained)
from ..config import Config
from ..datasets import build_dataset
from ..datasets.loader import TrainLoader, train_pad_hw_from_cfg
from ..models import MSPN2, build_model, build_trainable_model
from ..parallel.mesh import replicate, shard_args
from ..parallel.train_step import (TrainState, make_lr_fn, make_optimizer,
                                   make_train_step)
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger, NullLogger


def device_normalize(train_data_cfg):
    """Strip ``Normalize`` from the train pipelines: ``(data config,
    img_norm)``, where ``img_norm`` (mean, std, to_rgb) is what the step
    then applies on the card (loader_bench.py shows Normalize is ~20% of
    the per-image host cost)."""
    ds_list = train_data_cfg if isinstance(
        train_data_cfg, (list, tuple)) else [train_data_cfg]
    img_norm, new_list = None, []
    for ds_cfg in ds_list:
        ds_cfg = dict(ds_cfg)
        pipe = []
        for t in ds_cfg['pipeline']:
            if t.get('type') == 'Normalize':
                img_norm = dict(mean=t['mean'], std=t['std'],
                                to_rgb=t.get('to_rgb', False))
            else:
                pipe.append(t)
        ds_cfg['pipeline'] = pipe
        new_list.append(ds_cfg)
    assert img_norm is not None, \
        'device_normalize=True but no Normalize in the train pipeline'
    return (new_list if isinstance(train_data_cfg, (list, tuple))
            else new_list[0]), img_norm


class _PinnedRing:
    """``slots`` pinned host copies of a batch, each copied to the card on a
    side stream; a slot is filled again only after the event of its last
    copy has completed."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.n = 0

    def put(self, batch: Dict[str, np.ndarray]):
        i = self.n % len(self.bufs)
        self.n += 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        if self.bufs[i] is None:
            self.bufs[i] = {k: torch.empty(
                v.shape, dtype=torch.from_numpy(v).dtype, pin_memory=True)
                for k, v in batch.items()}
        buf = self.bufs[i]
        for k, v in batch.items():
            buf[k].numpy()[...] = v
        with torch.cuda.stream(self.stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in buf.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return out, event


def _ready(out, event):
    """The copied batch, once the compute stream has waited for its
    copy; its tensors are marked as used there (the allocator then keeps
    them until that stream is past them)."""
    stream = torch.cuda.current_stream(next(iter(out.values())).device)
    stream.wait_event(event)
    for t in out.values():
        t.record_stream(stream)
    return out


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]], device,
                       depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Each host batch (a dict of numpy arrays) as tensors on ``device``.
    On a card, batch n+1's copy (``depth`` - 1 batches ahead) is under way
    on a side stream, from a ring of ``depth`` pinned buffers, while batch n
    is used; on the CPU the arrays are wrapped as they are."""
    device = torch.device(device)
    if device.type != 'cuda':
        for b in batches:
            yield {k: torch.from_numpy(v) for k, v in b.items()}
        return
    ring = _PinnedRing(device, depth)
    queue = deque()
    for b in batches:
        queue.append(ring.put(b))
        if len(queue) >= depth:
            yield _ready(*queue.popleft())
    while queue:
        yield _ready(*queue.popleft())


def load_pretrained_backbone(model, path: str) -> Dict:
    """Load a pretrained backbone checkpoint into ``model.backbone`` by
    the backbone's loader; only MSPN2 has one (``load_mspn_pretrained``)."""
    if not isinstance(model.backbone, MSPN2):
        raise NotImplementedError(
            f'no pretrained loader for a {type(model.backbone).__name__} '
            f'backbone ({path}): only MSPN2 has one, load_mspn_pretrained')
    return load_mspn_pretrained(model, path)


def train_model(cfg: Config,
                work_dir: str = 'work_dirs/exp',
                resume_from: Optional[str] = None,
                load_from: Optional[str] = None,
                pretrained: Optional[str] = None,
                max_steps: Optional[int] = None,
                log_interval: Optional[int] = None,
                seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device=None, group=None) -> TrainState:
    """A whole training run of the config's recipe (``device``: the card
    unless the caller names another; this rank's device with a ``group``):
    ``dtype`` compute on f32 master weights. Returns the final state;
    checkpoints go to ``work_dir/ckpts``, logs to ``work_dir``.

    With a process group (``parallel.init_distributed``), the run is
    data-parallel over its ranks; without one it is this process's alone,
    whatever else the process has joined."""
    dev = resolve_device(device)
    rank_, world = shard_args(group) if group is not None else (0, 1)
    os.makedirs(work_dir, exist_ok=True)
    interval = log_interval or int(cfg.get('log_config', {}).get(
        'interval', 50))
    logger = MetricLogger(work_dir, interval=interval) if rank_ == 0 \
        else NullLogger()

    # ---------------- data
    img_norm = None
    train_data_cfg = cfg.data['train']
    if cfg.data.get('device_normalize'):
        train_data_cfg, img_norm = device_normalize(train_data_cfg)
    dataset = build_dataset(train_data_cfg)
    train_pipe = train_data_cfg[0]['pipeline'] if isinstance(
        train_data_cfg, (list, tuple)) else train_data_cfg['pipeline']
    pad_hw = train_pad_hw_from_cfg(train_pipe)
    batch_size = int(cfg.data.get('samples_per_gpu', 4))   # this rank's
    global_batch = batch_size * world
    J = int(cfg.model.bbox_head.num_joints)
    loader = TrainLoader(dataset, batch_size, pad_hw, J,
                         num_workers=int(cfg.data.get('workers_per_gpu', 4)),
                         seed=seed, shard_id=rank_, num_shards=world,
                         worker_type=cfg.data.get('worker_type', 'thread'),
                         dataset_cfg=train_data_cfg)
    steps_per_epoch = loader.steps_per_epoch

    # ---------------- model + state
    model = build_trainable_model(cfg.model, dtype=dtype, device=dev,
                                  seed=seed)
    ckpt_path = pretrained or cfg.model.get('pretrained')
    if load_from:
        load_checkpoint_report(model, load_from, strict=False)
    elif ckpt_path and os.path.exists(ckpt_path):
        report = load_pretrained_backbone(model, ckpt_path)
        logger.text(f'loaded pretrained backbone {ckpt_path}; '
                    f'{len(report["missing"])} leaves left at init')

    opt_cfg = cfg.get('optimizer', {})
    lr_cfg = cfg.get('lr_config', {})
    runner_cfg = cfg.get('runner', {})
    clip_cfg = (cfg.get('optimizer_config') or {}).get('grad_clip') or {}
    lr_fn = make_lr_fn(
        base_lr=float(opt_cfg.get('lr', 2e-3)),
        warmup_iters=int(lr_cfg.get('warmup_iters', 250)),
        warmup_ratio=float(lr_cfg.get('warmup_ratio', 1 / 3)),
        step_epochs=tuple(lr_cfg.get('step', [16, 20])),
        steps_per_epoch=steps_per_epoch)
    pw = opt_cfg.get('paramwise_cfg', {}) or {}
    tx_init, tx_update = make_optimizer(
        model, lr_fn,
        momentum=float(opt_cfg.get('momentum', 0.9)),
        weight_decay=float(opt_cfg.get('weight_decay', 1e-4)),
        grad_clip=float(clip_cfg.get('max_norm', 35.0)),
        bias_lr_mult=float(pw.get('bias_lr_mult', 2.0)),
        bias_decay_mult=float(pw.get('bias_decay_mult', 0.0)),
        frozen_prefixes=model.backbone.frozen_prefixes())
    state = TrainState(0, model, tx_init(dict(model.named_parameters())))

    manager = CheckpointManager(
        os.path.join(work_dir, 'ckpts'),
        max_keep=int(cfg.get('checkpoint_config', {}).get(
            'max_keep_ckpts', 20)), group=group)
    # checkpoint meta (ref tools/train.py:200-210: version + config text +
    # CLASSES embedded in every checkpoint); one sidecar per run dir
    classes = getattr(dataset, 'CLASSES', None)
    if rank_ == 0:
        with open(os.path.join(work_dir, 'ckpts', 'meta.json'), 'w') as f:
            json.dump(dict(
                das_tpu_torch_version=__version__,
                time=time.asctime(),
                CLASSES=list(classes) if classes else None,
                config=cfg.dump()), f, indent=1)
    if resume_from:
        state = manager.restore(state, resume_from)
        logger.text(f'resumed from {resume_from} at step {state.step}')
    if group is not None:
        replicate(model, group)

    head = cfg.model.bbox_head
    featmap_sizes = [(pad_hw[0] // (4 * 2 ** i), pad_hw[1] // (4 * 2 ** i))
                     for i in range(4)]
    # positive budget: ~9 center-sampled points per person per level;
    # generous default scaled by the global batch, overridable via
    # train_cfg.max_pos; with a group each rank takes it from its own points
    max_pos = int((cfg.model.get('train_cfg') or {}).get(
        'max_pos', 128 * global_batch))
    step_fn = make_train_step(
        tx_update, featmap_sizes, tuple(head.strides),
        tuple(tuple(r) for r in head.regress_ranges), J,
        center_sample_radius=float(head.get('center_sample_radius', 1.5)),
        max_pos=max_pos, img_norm=img_norm, group=group)

    total_epochs = int(runner_cfg.get('max_epochs', 22))
    total_steps = max_steps or total_epochs * steps_per_epoch
    eval_interval = int((cfg.get('evaluation') or {}).get('interval', 0))
    eval_dataset = None
    if eval_interval and 'val' in cfg.data and \
            cfg.data['val'].get('ann_file') and \
            os.path.exists(cfg.data['val']['ann_file']):
        eval_dataset = build_dataset(cfg.data['val'])

    # DCN exactness monitor: when training runs a shift/hybrid lowering
    # (dcn_gather_mode or dcn_train_gather_mode), bound the learned offsets
    # at every checkpoint — 'hybrid' is exact DCNv2 only while the flagged
    # pixel count stays within the repair budget (ops/deform_conv.py); a
    # drifting run must be loud.
    head_cfg = dict(cfg.model.bbox_head)
    modes = (str(head_cfg.get('dcn_gather_mode', 'patch')),
             str(head_cfg.get('dcn_train_gather_mode', 'auto')))
    monitor_dcn = any(m.startswith(('shift', 'hybrid')) for m in modes)

    # the eval hook and the offset check run the served model: one eval
    # model, built once, takes the training model's state at each save, so
    # the training model's mode and master weights are never touched
    eval_model = None

    def served():
        nonlocal eval_model
        if eval_model is None:
            eval_model = build_model(cfg.model, dtype=dtype, device=dev,
                                     seed=seed)
        eval_model.load_state_dict(state.model.state_dict())
        return eval_model

    def save_and_check(step, evaluate):
        manager.save(state, step)
        if not (monitor_dcn or evaluate):
            return
        m = served()
        if monitor_dcn:
            from .inference import validate_dcn_offsets
            shift_ok, hybrid_ok, worst = validate_dcn_offsets(
                m, int(head_cfg.get('dcn_shift_radius', 2)),
                int(head_cfg.get('dcn_shift_budget', 2048)))
            logger.text(
                f'dcn offsets @ step {step}: max|off|={worst[0]:.2f} '
                f'flagged/img={worst[1]} shift_exact={shift_ok} '
                f'hybrid_exact={hybrid_ok}'
                + ('' if hybrid_ok else
                   '  <-- WARNING: repair budget exceeded, hybrid lowering '
                   'is now approximate'))
        if evaluate:
            # EvalHook equivalent (ref exp_panoptic.py:218): each rank
            # sweeps its shard, rank 0 evaluates the gathered results
            from .test import run_test
            outputs = run_test(m, eval_dataset, cfg, progress=False,
                               group=group)
            if rank_ == 0:
                metrics = eval_dataset.evaluate(outputs)
                logger.text(f'eval @ step {step}: ' + ', '.join(
                    f'{k} {v}' for k, v in metrics.items()))

    # ---------------- loop
    host_step = state.step              # resume-aware
    logger.start(host_step)
    batches = iter(loader)
    on_card = prefetch_to_device(batches, dev)
    try:
        for batch in on_card:
            if host_step >= total_steps:
                break
            state, metrics = step_fn(state, batch)
            host_step += 1
            logger.log(host_step, metrics, global_batch)
            if host_step % steps_per_epoch == 0:
                epoch = host_step // steps_per_epoch
                save_and_check(host_step, eval_dataset is not None and
                               epoch % eval_interval == 0)
        save_and_check(host_step, False)
    finally:
        on_card.close()
        batches.close()
        logger.close()
    return state
