"""A sustained training run and its artifact, port of
``tools/analysis_tools/train_run.py``.

    python -m das_tpu_torch.tools.train_run [--config PATH] [--steps 300]
        [--batch 4] [--images 160] [--workers 8] [--hw 512 960]
        [--device cuda|cpu] [--dtype bfloat16|float32] [--data-dir DIR]
        [--work-dir DIR] [--out FILE]

Drives the real ``apis/train.py::train_model`` loop (loader workers, the
normalisation on the device, the step, the LR schedule, checkpoints every
epoch, the metric log) for ``--steps`` steps of ``--config`` (default
``configs/das/exp_panoptic.py``) from random weights, on synthetic
Panoptic-style JPEGs written with cv2 at ``--hw`` (3 people an image). The
recipe is the config's, with its Panoptic train pipeline's ``ResizePose``
fixed at ``--hw`` (one train bucket) and the metrics logged every step.
It writes one JSON artifact with the JAX tool's keys (the loss curve, its
first-10 and last-10 means, the steady-state step time, the last grad
norm, the checkpoints, ``finite``, ``decreasing``), read from the run's own
``*.metrics.jsonl``, plus ``config`` and the card's ``device`` name and
``power_limit`` as ``nvidia-smi`` gives them (``cpu`` and null on the
CPU). Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
J = 15


def make_dataset(data_dir: str, n_images: int, hw=(512, 960),
                 n_people: int = 3, seed: int = 0) -> str:
    """Panoptic-style COCO json and JPEGs of ``hw``: each image a roll of one
    random base image, with ``n_people`` people whose roots keep clear of
    the border. At 512x960 the people are drawn as the JAX tool draws them;
    other sizes scale the margins and spreads. Returns the json's path."""
    import cv2
    H, W = hw
    su, sv = W / 960.0, H / 512.0
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    aid = 1
    os.makedirs(data_dir, exist_ok=True)
    base_img = rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
    for i in range(n_images):
        fname = f'synth_{i:04d}.jpg'
        img = np.roll(base_img, (i * 13) % H, axis=0)
        cv2.imwrite(os.path.join(data_dir, fname), img)
        images.append(dict(
            id=i + 1, file_name=fname, width=W, height=H,
            cam=dict(K=[[1000., 0, W / 2], [0, 1000., H / 2], [0, 0, 1]],
                     R=np.eye(3).tolist(), t=[[0.], [0.], [0.]])))
        for _ in range(n_people):
            base = np.array([rng.uniform(120 * su, W - 120 * su),
                             rng.uniform(100 * sv, H - 100 * sv),
                             rng.uniform(200, 400)])
            joints = base + rng.randn(J, 3) * [30 * su, 45 * sv, 12]
            u, v = joints[:, 0], joints[:, 1]
            bbox = [float(u.min()), float(v.min()),
                    float(u.max() - u.min() + 4),
                    float(v.max() - v.min() + 4)]
            annotations.append(dict(
                id=aid, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0,
                joints3d_img=joints.tolist(), joints3d=joints.tolist(),
                joints2d_vis=[[1, 1]] * J, joints3d_vis=[[1, 1, 1]] * J))
            aid += 1
    path = os.path.join(data_dir, 'train.json')
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=1, name='person')]), f)
    return path


def run_config(cfg, ann: str, data_dir: str, batch: int, workers: int,
               hw=(512, 960)):
    """``cfg`` with its data replaced by the synthetic set: the first train
    pipeline (the Panoptic one) with ``ResizePose`` fixed at ``hw``,
    normalisation on the device, no pretrained backbone, a log line every
    step."""
    if int(cfg.model.bbox_head.num_joints) != J:
        raise ValueError(f'the synthetic set is Panoptic-style ({J} joints); '
                         f'the config has {cfg.model.bbox_head.num_joints}')
    train = cfg.data['train']
    first = train[0] if isinstance(train, (list, tuple)) else train
    pipeline = []
    for t in first['pipeline']:
        t = dict(t)
        if t['type'] == 'ResizePose':
            t['img_scale'] = (hw[1], hw[0])
        pipeline.append(t)
    cfg.data = dict(
        samples_per_gpu=batch, workers_per_gpu=workers,
        device_normalize=True,
        train=dict(type='CMUPanopticDataset', ann_file=ann,
                   img_prefix=data_dir, pipeline=pipeline, norm_depth=True,
                   abs_dz=True, depth_factor=1))
    cfg.model = dict(cfg.model, pretrained=None)
    cfg.log_config = dict(interval=1)
    return cfg


def card(device: torch.device):
    """(name, power limit) of the card as ``nvidia-smi`` gives them; ('cpu',
    None) off the card."""
    if device.type != 'cuda':
        return 'cpu', None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', str(index)], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()
    name, limit = (s.strip() for s in line.rsplit(',', 1))
    return name, limit


def artifact(work_dir: str, steps: int, batch: int, hw, wall: float,
             config: str, device: torch.device) -> dict:
    """The JAX tool's artifact from the run's metrics jsonl, plus the config
    and the card."""
    streams = sorted(glob.glob(os.path.join(work_dir, '*.metrics.jsonl')))
    with open(streams[-1]) as f:
        rows = [json.loads(ln) for ln in f]
    rows = [r for r in rows if 'loss' in r][:steps]
    losses = [r['loss'] for r in rows]
    ips = [r['img_per_s'] for r in rows]
    # steady-state step time: the first 3 dropped (the kernels' builds and
    # the loader's start)
    steady = sorted(batch / np.maximum(np.asarray(ips[3:]), 1e-9))
    k = len(steady)
    ckpts = sorted(os.listdir(os.path.join(work_dir, 'ckpts')))
    n5 = max(1, len(losses) // 20)
    name, limit = card(device)
    return dict(
        steps=len(rows), batch=batch, hw=list(hw), wall_s=round(wall, 1),
        loss_first10=round(float(np.mean(losses[:10])), 4),
        loss_last10=round(float(np.mean(losses[-10:])), 4),
        loss_curve=[round(float(np.mean(losses[i:i + n5])), 3)
                    for i in range(0, len(losses), n5)],
        step_s_min=round(float(steady[0]), 3) if k else None,
        step_s_p50=round(float(steady[k // 2]), 3) if k else None,
        step_s_p90=round(float(steady[int(k * 0.9)]), 3) if k else None,
        grad_norm_last=round(rows[-1].get('grad_norm', float('nan')), 2),
        checkpoints=ckpts,
        finite=bool(np.all(np.isfinite(losses))),
        decreasing=bool(np.mean(losses[-10:]) < np.mean(losses[:10])),
        config=config, device=name, power_limit=limit)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--config', default=os.path.join(
        ROOT, 'configs', 'das', 'exp_panoptic.py'))
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--images', type=int, default=160)
    ap.add_argument('--workers', type=int, default=8)
    ap.add_argument('--hw', type=int, nargs=2, default=(512, 960))
    ap.add_argument('--device', default=None,
                    help='the card unless given (e.g. cpu)')
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('bfloat16', 'float32'))
    ap.add_argument('--data-dir', default=os.path.join(
        ROOT, 'build', 'train_run', 'data'))
    ap.add_argument('--work-dir', default=os.path.join(
        ROOT, 'build', 'train_run', 'work'))
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'build', 'train_run', 'train_run.json'))
    args = ap.parse_args(argv)

    from ..apis.train import train_model
    from ..config import Config
    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    hw = tuple(args.hw)
    ann = os.path.join(args.data_dir, 'train.json')
    if not os.path.exists(ann):
        print(f'writing {args.images} synthetic {hw[0]}x{hw[1]} images',
              flush=True)
        ann = make_dataset(args.data_dir, args.images, hw)
    cfg = run_config(Config.fromfile(args.config), ann, args.data_dir,
                     args.batch, args.workers, hw)

    t0 = time.time()
    state = train_model(cfg, work_dir=args.work_dir, max_steps=args.steps,
                        log_interval=1, dtype=getattr(torch, args.dtype),
                        device=device)
    wall = time.time() - t0
    if state.step != args.steps:
        raise RuntimeError(f'the run stopped at step {state.step} of '
                           f'{args.steps}')
    out = artifact(args.work_dir, args.steps, args.batch, hw, wall,
                   os.path.relpath(os.path.abspath(args.config), ROOT),
                   device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
