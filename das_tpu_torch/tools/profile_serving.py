"""Where a serving request's time goes, on the card.

    python -m das_tpu_torch.tools.profile_serving [--config PATH]
        [--requests 3] [--out DIR] [--fuse-conv-bn]

Builds ``--config`` (default ``configs/das/exp_panoptic_tpu.py``; e.g.
``configs/das/exp_panoptic_tpu_fused_gn.py`` for the fused conv+GN head) in
bf16 on the card (random weights from a seed, conv_offset zero as at
init), serves B=4 640x1152
requests and prints one JSON line: per-stage device times from CUDA events
(backbone, neck, head, decode), the request times on the host clock with
their median, least, greatest and standard deviation, the decode's span
(the device-side time from the head's last kernel to the decode's last,
waits for the host included), K4's launches in one request (row gathers and
fused samples) and K3's (the decode's OKS-NMS kernel), and,
for one request under ``torch.profiler``, its host time, the sum of its
kernels' device time in all and per stage (busy / host time is the
device's busy share) and the kernels with the most device time. The
profiler's table and trace go to ``--out`` (default
``build/profile_serving``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..apis import init_model
from ..core.decode import decode_batch
from ..models.fuse import fuse_conv_bn
from ..models.layers import cast_compute
from ..ops import gather, oks_nms

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs', 'das', 'exp_panoptic_tpu.py')
STAGES = ('backbone', 'neck', 'head', 'decode')


def stage_times(model, cfg, img, sf):
    """Device ms of each stage of one request, from CUDA events."""
    head = cfg.model.bbox_head
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        ev[0].record()
        x = img.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = model.backbone(x)
        ev[1].record()
        feats = model.neck(feats)
        ev[2].record()
        cls, pose, ctr, _ = model.bbox_head(feats)
        ev[3].record()
        decode_batch(cls, pose, ctr, tuple(head.strides), sf,
                     int(head.num_joints), dict(cfg.model.test_cfg))
        ev[4].record()
    torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(STAGES)}


def k4_launches() -> int:
    """K4's launches so far: row gathers, their adjoints, fused samples."""
    return gather.launches + gather.backward_launches \
        + getattr(gather, 'sampler_launches', 0)


def stage_busy_ms(trace_path, names):
    """Device busy ms of each stage of the profiled request, from its
    exported trace: the device events (kernels, copies, sets) whose launch
    falls between two of the request's CUDA event records."""
    with open(trace_path) as f:
        ev = json.load(f)['traceEvents']
    marks = sorted(e['ts'] for e in ev
                   if e.get('name', '').startswith('cudaEventRecord'))
    launched = {e['args']['correlation']: e['ts'] for e in ev
                if e.get('cat') == 'cuda_runtime'
                and 'correlation' in e.get('args', {})}
    busy = dict.fromkeys(names, 0.0)
    for e in ev:
        if e.get('cat') not in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            continue
        t = launched.get(e['args'].get('correlation'))
        for i, n in enumerate(names):
            if t is not None and marks[i] <= t < marks[i + 1]:
                busy[n] += e['dur'] / 1e3
    return busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default=CFG)
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--out',
                    default=os.path.join('build', 'profile_serving'))
    ap.add_argument('--fuse-conv-bn', action='store_true',
                    help='fold the BatchNorms into their convs (built in '
                         'f32, fused, then cast to bf16)')
    args = ap.parse_args()
    if args.fuse_conv_bn:
        model, cfg = init_model(args.config, device='cuda')
        model, _ = fuse_conv_bn(model)
        cast_compute(model, torch.bfloat16)
    else:
        model, cfg = init_model(args.config, dtype=torch.bfloat16,
                                device='cuda')
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(4, 640, 1152, 3).astype(np.float32)) \
        .cuda()
    sf = torch.ones(4, 2, device='cuda')
    stage_times(model, cfg, img, sf)                      # warm-up
    stages, wall = [], []
    before, before_k3 = k4_launches(), oks_nms.launches
    for _ in range(args.requests):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stages.append(stage_times(model, cfg, img, sf))
        wall.append((time.perf_counter() - t) * 1e3)
    k4 = (k4_launches() - before) / max(1, args.requests)
    k3 = (oks_nms.launches - before_k3) / max(1, args.requests)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        stage_times(model, cfg, img, sf)
        profiled_ms = (time.perf_counter() - t) * 1e3
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, 'serving_trace.json')
    prof.export_chrome_trace(trace)
    ka = prof.key_averages()
    table = ka.table(sort_by='self_device_time_total', row_limit=40)
    with open(os.path.join(args.out, 'serving_kernels.txt'), 'w') as f:
        f.write(table)

    def dev_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0.0))
    # the device's own events (kernels, copies): an operator's self device
    # time is its kernels' time again, so operators are left out of the sum
    kernels = [e for e in ka if e.device_type != DeviceType.CPU]
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    print(json.dumps(dict(
        config=os.path.relpath(args.config),
        fuse_conv_bn=args.fuse_conv_bn,
        device=torch.cuda.get_device_name(0),
        stages_ms={k: float(np.median([s[k] for s in stages]))
                   for k in stages[0]},
        request_ms=wall,
        request_ms_median=float(np.median(wall)),
        request_ms_min=float(np.min(wall)),
        request_ms_max=float(np.max(wall)),
        request_ms_std=float(np.std(wall)),
        decode_span_ms=float(np.median([s['decode'] for s in stages])),
        k4_launches_per_request=k4, k3_launches_per_request=k3,
        profiled_request_ms=profiled_ms,
        profiled_device_busy_ms=busy,
        profiled_stage_busy_ms=stage_busy_ms(trace, STAGES),
        top_kernels=[dict(name=e.key[:90], ms=dev_us(e) / 1e3,
                          calls=e.count) for e in top])))


if __name__ == '__main__':
    main()
