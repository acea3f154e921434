"""Where a training step's time goes, on the card.

    python -m das_tpu_torch.tools.profile_train [--config PATH]
        [--batch 4] [--steps 5] [--out DIR]

Builds ``--config`` (default ``configs/das/exp_panoptic_tpu.py``) as a
trainable model: f32 master weights, bf16 compute, random weights from a
seed, on the card. Trains ``--steps`` steps on one synthetic batch in the
TrainLoader's format at the config's train bucket (640x1344 for the shipped
pipeline) and prints one JSON line: each step's time from CUDA events and on
the host clock, the peak device memory, K4's launches per step (row
gathers, their adjoints, samples, sample backwards) and the DCN kernel's
(K1's, forward and backward), and, for one more step under
``torch.profiler``, its device busy ms (the sum of its kernels' device
time), the kernels with the most device time, and PyTorch's elementwise
kernels' launches and device ms. The profiler's table and trace go to ``--out`` (default
``build/profile_train``).

The trainer is ``apis/train.py``'s ``make_trainer``, as ``train_model``
sets it up, at 1000 steps an epoch; ``synthetic_batch`` is what the card
tests train on too.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

from ..apis.train import make_trainer
from ..config import Config
from ..datasets.loader import train_pad_hw_from_cfg
from ..models import build_trainable_model
from ..ops import dcn_shift, gather

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs', 'das', 'exp_panoptic_tpu.py')
# one person per regress range of the shipped head, (-1, 80), (80, 160),
# (160, 320), (320, inf) (configs/das/exp_panoptic.py:40): the farthest
# joint lies this far from the root, in pixels
REACH = (40.0, 120.0, 240.0, 480.0)


def train_pad_hw(pipeline) -> Tuple[int, int]:
    """The fixed train bucket of a train pipeline, as the loader's
    ``train_pad_hw_from_cfg`` gives it: the largest short side and long
    side of its resize scales, each padded to a multiple of 32. A pipeline
    without a ``Resize``/``ResizePose`` step with ``img_scale`` raises
    ``ValueError`` where the loader falls back to 640x1344: a profile at a
    guessed size would report the shipped config's numbers under another
    config's name."""
    if not any(t.get('type') in ('ResizePose', 'Resize') and 'img_scale' in t
               for t in pipeline):
        raise ValueError('the train pipeline has no Resize/ResizePose step '
                         'with img_scale, so no train bucket')
    return train_pad_hw_from_cfg(pipeline)


def synthetic_batch(B: int, H: int, W: int, num_joints: int,
                    root_idx: int = 2, people: int = 8,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """A TrainLoader batch made from a numpy seed: raw pixels in [0, 255]
    and ``people`` GTs per image. Person g's farthest visible joint lies
    ``REACH[g % 4]`` pixels from its root, so each image has positives in
    every level's regress range; the root joint sits on the center, about
    10% of the other joints are invisible, and the depths are 2-6."""
    rng = np.random.RandomState(seed)
    J, G = num_joints, people
    centers = rng.uniform([0.1 * W, 0.1 * H], [0.9 * W, 0.9 * H],
                          (B, G, 2)).astype(np.float32)
    reach = np.asarray(REACH, np.float32)[np.arange(G) % len(REACH)]
    radius = rng.uniform(0.2, 1.0, (B, G, J)) * reach[None, :, None]
    far = (root_idx + 1) % J
    radius[..., root_idx] = 0.0
    radius[..., far] = reach[None, :]
    ang = rng.uniform(0.0, 2 * np.pi, (B, G, J))
    joints = centers[:, :, None, :] + radius[..., None] * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    dz = rng.randn(B, G, J) * 0.3
    dz[..., root_idx] = 0.0
    vis = (rng.rand(B, G, J) > 0.1).astype(np.float32)
    vis[..., root_idx] = vis[..., far] = 1.0
    depths = rng.uniform(2.0, 6.0, (B, G)).astype(np.float32)
    poses = np.concatenate(
        [centers, depths[..., None],
         np.concatenate([joints, dz[..., None]], -1).reshape(B, G, 3 * J),
         vis], -1).astype(np.float32)
    return dict(
        img=rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
        gt_poses_3d=poses, gt_centers2d=centers, gt_depths=depths,
        gt_valid=np.ones((B, G), bool))


def k4_launches():
    """K4's launches so far: (row gathers, their adjoints, samples, sample
    backwards)."""
    return [gather.launches, gather.backward_launches,
            getattr(gather, 'sampler_launches', 0),
            getattr(gather, 'sampler_backward_launches', 0)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default=CFG)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--out', default=os.path.join('build', 'profile_train'))
    args = ap.parse_args()
    cfg = Config.fromfile(args.config)
    H, W = train_pad_hw(cfg.train_pipeline)
    head = cfg.model.bbox_head
    model = build_trainable_model(cfg.model, dtype=torch.bfloat16,
                                  device='cuda')
    state, step, _, max_pos = make_trainer(
        cfg, model, (H, W), args.batch, img_norm=cfg.get('img_norm_cfg'))
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        args.batch, H, W, int(head.num_joints), int(head.root_idx)).items()}
    state, _ = step(state, batch)                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    steps, host, launches, k1 = [], [], [], []
    for _ in range(args.steps):
        before = k4_launches()
        k1_before = dcn_shift.launches, dcn_shift.backward_launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev[0].record()
        state, metrics = step(state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        steps.append(ev[0].elapsed_time(ev[1]))
        launches.append([b - a for a, b in zip(before, k4_launches())])
        k1.append([dcn_shift.launches - k1_before[0],
                   dcn_shift.backward_launches - k1_before[1]])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t) * 1e3
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, 'train_trace.json'))
    ka = prof.key_averages()
    with open(os.path.join(args.out, 'train_kernels.txt'), 'w') as f:
        f.write(ka.table(sort_by='self_device_time_total', row_limit=50))

    def dev_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0.0))
    kernels = [e for e in ka if e.device_type != DeviceType.CPU]
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    elementwise = [e for e in kernels if 'elementwise' in e.key]
    print(json.dumps(dict(
        config=os.path.relpath(args.config), batch=args.batch, hw=[H, W],
        max_pos=max_pos, device=torch.cuda.get_device_name(0),
        step_ms_cuda_events=steps, step_ms_host=host,
        peak_memory_gib=peak, k4_launches_per_step=launches,
        dcn_shift_launches_per_step=k1,
        loss={k: float(v) for k, v in metrics.items()},
        profiled_step_ms=profiled_ms,
        profiled_device_busy_ms=sum(dev_us(e) for e in kernels) / 1e3,
        elementwise_launches=sum(e.count for e in elementwise),
        elementwise_ms=sum(dev_us(e) for e in elementwise) / 1e3,
        top_kernels=[dict(name=e.key[:90], ms=dev_us(e) / 1e3,
                          calls=e.count) for e in top])))


if __name__ == '__main__':
    main()
