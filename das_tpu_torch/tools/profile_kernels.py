"""Where the time of the port's kernels goes, on the card.

    python -m das_tpu_torch.tools.profile_kernels
        [--what dcn dcn_backward oks_nms conv_gn wrapper]

``dcn``: the DCNv2 shift kernel (K1) at the four levels of a B=4 640x1152
bf16 request (Cin = Cout = 256, r=1) under ``torch.profiler``: the device
time of its launch per call, one JSON line per level.

``dcn_backward``: K1's backward kernels at the four levels of a B=4
640x1344 train step (Cin = 256, r=1), on its tiled pass and on its lane
pass (the two share the dx kernel), with generic offsets and with all
offsets 0 (a step from the zero-initialised ``conv_offset``), under
``torch.profiler``: the device time of each kernel per call when the
library is asked for every output, for
the tap kernel's outputs alone, for dmask and doffset alone (no tile
written), for the tile alone (no U read) and for dx alone. One JSON line
per (level, offsets, pass).

``oks_nms``: the OKS-NMS keep mask (K3) on the candidates of one served
``exp_panoptic_tpu_fused_gn`` request (B=4, M=3720, J=15), under
``torch.profiler``: the mask kernel and the scan kernel apart, per call,
with and without ``max_keep`` where the wrapper takes it. One JSON line.

``conv_gn``: the fused conv+GN+relu (K2) at the four levels of a B=4
640x1152 bf16 request, for Cout 256 and 64, under ``torch.profiler``: the
device time of each of its launches (the conv, the statistics and the apply
pass) apart, per call, one JSON line per shape.

``wrapper``: what one call of the row gather's wrapper (K4) costs the host,
piece by piece, with ``time.perf_counter`` over 1,000 calls of each (the
least of 5 such batches): the
checks, ``torch.empty``, the device guard, the stream handle, the ctypes
array, the ctypes call (the launch), and the whole wrappers. One JSON line.
It works on any version of ``ops/gather.py`` that has ``gather_rows_cuda``;
pieces that a version lacks are left out.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import math
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType

from ..ops import conv_gn, dcn_shift, gather, oks_nms

LEVELS = [(160, 288), (80, 144), (40, 72), (20, 36)]
FUSED_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs', 'das',
    'exp_panoptic_tpu_fused_gn.py')


def kernel_ms(fn, calls: int = 10, warmup: int = 3):
    """{kernel name: device ms per call} of ``fn`` under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        name = e.key.replace('void ', '').replace(
            '(anonymous namespace)::', '')[:48]
        kernels[name] = kernels.get(name, 0.0) + us / 1e3 / calls
    return kernels


def dcn_levels():
    """K1's launch at each level."""
    gen = torch.Generator().manual_seed(7)
    for lvl, (h, w) in enumerate(LEVELS):
        x = torch.randn(4, h, w, 256, generator=gen).cuda().bfloat16()
        off = ((torch.rand(4, h, w, 18, generator=gen) * 2 - 1) * 0.8).cuda()
        mask = torch.sigmoid(torch.randn(4, h, w, 9, generator=gen)) \
            .cuda().bfloat16()
        wt = (torch.randn(3, 3, 256, 256, generator=gen) * 0.05) \
            .cuda().bfloat16()
        b = torch.randn(256, generator=gen).cuda().bfloat16()
        ms = kernel_ms(lambda: dcn_shift.deform_conv_shift(
            x, off, mask, wt, b, radius=1))
        print(json.dumps(dict(
            what='dcn', level=lvl, shape=f'4x{h}x{w}x256 bf16 r=1',
            ms_per_call=ms, sum_ms=sum(ms.values()))), flush=True)


TRAIN_LEVELS = [(160, 336), (80, 168), (40, 84), (20, 42)]


def dcn_backward_parts():
    """K1's backward kernels, each pass and part apart."""
    gen = torch.Generator().manual_seed(7)
    fn = dcn_shift.LIB.load().dcn_shift_backward_pass
    parts = dict(all=('u', 'tile', 'doffset', 'dmask', 'dx'),
                 tap=('u', 'tile', 'doffset', 'dmask'),
                 sums=('u', 'doffset', 'dmask'), tile=('tile',),
                 dx=('u', 'dx'))
    for lvl, (h, w) in enumerate(TRAIN_LEVELS):
        P = 4 * h * w
        x = torch.randn(4, h, w, 256, generator=gen).cuda().bfloat16()
        mask = torch.sigmoid(torch.randn(4, h, w, 9, generator=gen)) \
            .cuda().bfloat16()
        u = torch.randn(P, 9 * 256, generator=gen).cuda().bfloat16()
        out = dict(u=u, tile=torch.empty_like(u),
                   doffset=torch.empty(P, 18, device='cuda'),
                   dmask=torch.empty_like(mask), dx=torch.empty_like(x))
        for offsets in ('generic', 'zero'):
            off = torch.zeros(4, h, w, 18) if offsets == 'zero' else \
                (torch.rand(4, h, w, 18, generator=gen) * 2 - 1) * 1.2
            off = off.cuda()
            for lanes in (0, 1):
                ms = {}
                for part, names in parts.items():
                    ptr = [out[k].data_ptr() if k in names else None
                           for k in ('u', 'tile', 'doffset', 'dmask', 'dx')]

                    def call():
                        err = fn(x.data_ptr(), off.data_ptr(),
                                 mask.data_ptr(), *ptr, 4, h, w, 256, 1, 1,
                                 lanes, None, torch.cuda.current_stream()
                                 .cuda_stream)
                        if err != 0:
                            raise RuntimeError(f'K1 backward: error {err}')
                    ms[part] = kernel_ms(call, calls=5, warmup=2)
                print(json.dumps(dict(
                    what='dcn_backward', level=lvl, offsets=offsets,
                    shape=f'4x{h}x{w}x256 bf16 r=1',
                    path='lanes' if lanes else 'tiled', ms_per_call=ms)),
                    flush=True)


def pose_template(model, radius=12.0):
    """Every candidate's joints on a circle of ``radius`` grid steps around
    its point (the uvd prediction conv's bias), so that candidates at
    neighbouring points overlap at OKS > 0.9 and the NMS suppresses some:
    random head weights alone give poses of a few pixels, which never
    overlap."""
    head = model.bbox_head
    J = head.num_joints
    ang = torch.arange(J, dtype=torch.float32) * (2 * math.pi / J)
    uvd = torch.stack([radius * torch.cos(ang), radius * torch.sin(ang),
                       torch.zeros(J)], dim=-1).reshape(-1)
    with torch.no_grad():
        head.conv_cls.bias.zero_()          # let poses pass score_thr
        bias = head.conv_poses[0].bias
        bias.copy_(uvd.to(bias.device, bias.dtype))


def served_candidates(model, cfg, img, sf):
    """One served request up to its NMS: the head's outputs (``heads``), the
    candidate set the decode hands to its NMS (``cand``), the stable sort
    order by score (``order``) and the sorted ``kpts``, ``areas`` and
    ``valid`` that ``oks_nms_keep`` takes, with ``thr``, ``sigmas`` and
    ``nms_post`` from the config."""
    from ..core.decode import decode_candidates
    head = cfg.model.bbox_head
    test_cfg = dict(cfg.model.test_cfg)
    J = int(head.num_joints)
    with torch.inference_mode():
        cls, pose, ctr, _ = model(img)
        c = decode_candidates(cls, pose, ctr, tuple(head.strides), sf, J,
                              test_cfg)
        order = torch.sort(c['nms_scores'], dim=1, descending=True,
                           stable=True).indices
        nidx = torch.arange(order.shape[0], device=order.device)[:, None]
        return dict(
            heads=(cls, pose, ctr), cand=c, order=order,
            kpts=c['xy'][nidx, order].contiguous(),
            areas=c['areas'][nidx, order].contiguous(),
            valid=c['valid'][nidx, order].contiguous(),
            thr=float(test_cfg['nms_thr']), sigmas=oks_nms.default_sigmas(J),
            nms_post=int(test_cfg['nms_post']))


def oks_nms_passes():
    """K3's kernels apart on a served request's candidates."""
    import numpy as np
    from ..apis import init_model
    model, cfg = init_model(FUSED_CFG, dtype=torch.bfloat16, device='cuda')
    pose_template(model)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(4, 640, 1152, 3).astype(np.float32)) \
        .cuda()
    r = served_candidates(model, cfg, img, torch.ones(4, 2, device='cuda'))
    del model
    kpts, areas, valid = r['kpts'], r['areas'], r['valid']
    thr, sig, post = r['thr'], r['sigmas'], r['nms_post']
    B, M, J, _ = kpts.shape
    out = dict(what='oks_nms', shape=f'B={B} M={M} J={J} served candidates',
               valid=int(valid.sum()))
    keep = oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig)
    out['kept_per_image'] = keep.sum(1).tolist()
    out['ms_per_call'] = kernel_ms(
        lambda: oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig), 20)
    if 'max_keep' in inspect.signature(oks_nms.oks_nms_keep).parameters:
        out[f'ms_per_call_max_keep_{post}'] = kernel_ms(
            lambda: oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig,
                                         max_keep=post), 20)
    print(json.dumps(out), flush=True)


def conv_gn_passes(calls: int = 10):
    gen = torch.Generator().manual_seed(11)
    for lvl, (h, w) in enumerate(LEVELS):
        for cout in (256, 64):
            x = torch.randn(4, h, w, 256, generator=gen).cuda().bfloat16()
            wt = (torch.randn(3, 3, 256, cout, generator=gen) * 0.05) \
                .cuda().bfloat16()
            gamma = (torch.rand(cout, generator=gen) + 0.5).cuda()
            beta = (torch.randn(cout, generator=gen) * 0.1).cuda()
            kernels = kernel_ms(lambda: conv_gn.conv_gn_relu(
                x, wt, gamma, beta, groups=32), calls)
            print(json.dumps(dict(
                what='conv_gn', level=lvl, shape=f'4x{h}x{w}x256->{cout}',
                ms_per_call=kernels, sum_ms=sum(kernels.values()))),
                flush=True)


def per_call_us(fn, calls: int = 1000, batches: int = 5) -> float:
    """Host microseconds per call: the least of ``batches`` batches of
    ``calls`` calls (the host is shared; a batch that was interrupted
    reads high)."""
    for _ in range(10):
        fn()
    best = float('inf')
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t) * 1e6 / calls)
    torch.cuda.synchronize()
    return best


def wrapper_split():
    """Host microseconds per call of each piece of K4's wrapper, at the RU
    level-0 take_at shape (60 x 46080 x 8 bf16, 1000 points)."""
    dev = torch.device('cuda', torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(60, 46080, 8, generator=gen).to(dev).bfloat16()
    idx = torch.randint(0, 46080, (60, 1000), generator=gen).to(dev)
    out = {}
    if hasattr(gather, '_check_cuda'):
        out['checks'] = per_call_us(lambda: gather._check_cuda(table, idx))
    else:
        out['checks'] = per_call_us(
            lambda: gather._check_segment('table', table, idx, dev))
    out['torch.empty'] = per_call_us(lambda: torch.empty(
        (60, 1000, 8), dtype=table.dtype, device=dev))
    out['table.new_empty'] = per_call_us(
        lambda: table.new_empty((60, 1000, 8)))

    def guard():
        with torch.cuda.device(dev):
            pass
    out['with torch.cuda.device'] = per_call_us(guard)
    out['torch.cuda.current_device'] = per_call_us(torch.cuda.current_device)
    out['current_stream().cuda_stream'] = per_call_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if get is not None:
        out['_cuda_getCurrentRawStream'] = per_call_us(
            lambda: get(dev.index))
    out['data_ptr x3'] = per_call_us(
        lambda: (table.data_ptr(), idx.data_ptr(), table.data_ptr()))
    desc = [table.data_ptr(), idx.data_ptr(), table.data_ptr(), 46080, 1000,
            16, 1]
    out['ctypes array of 7'] = per_call_us(
        lambda: (ctypes.c_longlong * 7)(*desc))
    lib = gather.LIB.load()
    o = torch.empty((60, 1000, 8), dtype=table.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if hasattr(lib, 'gather_rows_grouped'):
        d = [table.data_ptr(), idx.data_ptr(), o.data_ptr(), 46080, 1000, 16,
             1]
        arr = (ctypes.c_longlong * 7)(*d)
        out['ctypes call (launch)'] = per_call_us(
            lambda: lib.gather_rows_grouped(arr, 1, 60, 0, stream))
    else:
        out['ctypes call (launch)'] = per_call_us(
            lambda: lib.gather_rows_forward(
                table.data_ptr(), idx.data_ptr(), o.data_ptr(), 60, 46080,
                1000, 16, 1, stream))
    out['gather_rows_cuda (whole wrapper)'] = per_call_us(
        lambda: gather.gather_rows_cuda(table, idx))
    out['gather_rows (dispatch + wrapper)'] = per_call_us(
        lambda: gather.gather_rows(table, idx))
    if hasattr(gather, 'gather_grouped_cuda'):
        t3 = table[..., :3].contiguous()
        out['gather_grouped_cuda, 2 segments'] = per_call_us(
            lambda: gather.gather_grouped_cuda([t3, table], [idx, idx]))
    if hasattr(gather, 'sample_rows_bilinear_cuda'):
        x = torch.rand(60, 1000, generator=gen).to(dev) * 287
        y = torch.rand(60, 1000, generator=gen).to(dev) * 159
        out['sample_rows_bilinear_cuda (whole wrapper)'] = per_call_us(
            lambda: gather.sample_rows_bilinear_cuda(table, x, y, 160, 288))
    out['table[nidx, idx] (indexing call)'] = per_call_us(
        lambda: table[torch.arange(60, device=dev)[:, None], idx])
    print(json.dumps(dict(what='wrapper', unit='host us per call',
                          shape='60x46080x8 bf16, P=1000 int64', **out)),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--what', nargs='+',
                    default=['dcn', 'oks_nms', 'conv_gn', 'wrapper'],
                    choices=['dcn', 'dcn_backward', 'oks_nms', 'conv_gn',
                             'wrapper'])
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if 'dcn' in args.what:
        dcn_levels()
    if 'dcn_backward' in args.what:
        dcn_backward_parts()
    if 'oks_nms' in args.what:
        oks_nms_passes()
    if 'conv_gn' in args.what:
        conv_gn_passes()
    if 'wrapper' in args.what:
        wrapper_split()


if __name__ == '__main__':
    main()
