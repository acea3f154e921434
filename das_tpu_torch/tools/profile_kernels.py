"""Where the time of the port's kernels goes, on the card: each kernel
alone, under ``torch.profiler`` (the device time of each of its launches
per call), beside its bound where the formula lives here (K1, K2, the row
gather: the larger of operations over the peak rate and bytes over the
peak bandwidth of an H100 SXM). The bounds of K3 and of K4's sampler are
the benchmark's (``dasbench/roofline``); those cases print times only.

    python -m das_tpu_torch.tools.profile_kernels
        [--what dcn dcn_backward oks_nms conv_gn wrapper gather sampler
                sampler_backward dcn_im2col]

``dcn``: the DCNv2 shift kernel (K1) at the four levels of a B=4 640x1152
bf16 request (Cin = Cout = 256, r=1), and at level 1 at r=2: its wgmma
pass, and the WMMA pass it took the place of (called by name), per call,
with the bound; one JSON line per (level, radius).

``dcn_backward``: K1's backward kernels at the four levels of a B=4
640x1344 train step (Cin = 256, r=1), on its tiled pass and on its lane
pass (the two share the dx kernel), with generic offsets and with all
offsets 0 (a step from the zero-initialised ``conv_offset``), under
``torch.profiler``: the device time of each kernel per call when the
library is asked for every output, for
the tap kernel's outputs alone, for dmask and doffset alone (no tile
written), for the tile alone (no U read) and for dx alone. One JSON line
per (level, offsets, pass), with the bound of the whole backward (its two
products and its bytes) and the kernels' own bytes bounds (both kernels,
the tap kernel's, the dx kernel's).

``oks_nms``: the OKS-NMS keep mask (K3) on the candidates of one served
``exp_panoptic_tpu_fused_gn`` request (B=4, M=3720, J=15), under
``torch.profiler``: the mask kernel and the scan kernel apart, per call,
with and without ``max_keep`` where the wrapper takes it. One JSON line.

``conv_gn``: the fused conv+GN+relu (K2) at the four levels of a B=4
640x1152 bf16 request, for Cout 256 and 64, under ``torch.profiler``: the
device time of each of its launches (the conv, the statistics and the apply
pass) apart, per call, beside the unfused cuDNN conv + the port's
GroupNorm + relu on the same inputs, with the bound; one JSON line per
shape.

``wrapper``: what one call of the row gather's wrapper (K4) costs the host,
piece by piece, with ``time.perf_counter`` over 1,000 calls of each (the
least of 5 such batches): the
checks, ``torch.empty``, the device guard, the stream handle, the ctypes
array, the ctypes call (the launch), and the whole wrappers. One JSON line.
It works on any version of ``ops/gather.py`` that has
``gather_grouped_cuda``; pieces that a version lacks are left out.

``gather``: K4's row gather (one segment of the grouped launch) and its
adjoint in bf16 at the RU's shapes of a served request (levels 0 and 1)
and of a train step (level 0), the repair's level-0 corners and the
probe's shape (tools/analysis_tools/pallas_gather_probe.py:26-28): the
kernels per call beside plain indexing and ``index_add_`` into a zeroed
f32 table then the cast, with the bounds. One JSON line per shape.

``sampler``: K4's fused bilinear sampler in bf16 at the RU's level-0
shapes of a served request and the repair's nine taps, beside
``F.grid_sample``; and at exp_panoptic's level-0 DCN (4x160x288x256, nine
taps a pixel), masked (the served DCN's im2col rows) and unmasked. One
JSON line per shape.

``sampler_backward``: the sampler's backward kernel in bf16 at the
'clip' DCN's level-0 shapes of exp_panoptic's and exp_mupots' train
buckets and the RU's train shapes: all gradients, the image's alone and
the coordinates' alone, beside ``aten.grid_sampler_2d_backward``. One JSON
line per shape.

``dcn_im2col``: one served bf16 DCN call at exp_panoptic's level 0
(4x160x288x256; offsets, mask and bias as the layer passes them) by the
per-tap route (nine samples, products and matmuls) and by the im2col
route (one masked sample, one matmul), under ``torch.profiler``, with
K1's bound of the same contraction. One JSON line.
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

from ..ops import conv_gn, dcn_shift, deform_conv, gather, oks_nms

LEVELS = [(160, 288), (80, 144), (40, 72), (20, 36)]
# an H100 SXM's data-sheet peaks (dense, 700 W): bf16 on the tensor cores,
# f32 outside them, HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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


def bound_ms(flops: float, peak_flops: float, nbytes: float):
    """(ms, 'operations' or 'bytes'): the larger of the two least times."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        'operations' if t_ops >= t_bytes else 'bytes'


def dcn_bound_ms(N, H, W, Cin, Cout, elt_bytes, peak_flops):
    """Least time for one shift-DCN call: the contraction's operations or
    the compulsory bytes (x, f32 offsets, mask, weight, bias, out)."""
    px = N * H * W
    flops = 2.0 * px * 9 * Cin * Cout
    nbytes = elt_bytes * (px * Cin + px * 9 + 9 * Cin * Cout + Cout
                          + px * Cout) + 4 * px * 18
    return bound_ms(flops, peak_flops, nbytes)


def dcn_backward_bound_ms(N, H, W, Cin, Cout, elt_bytes, peak_flops):
    """Least time for the backward of one shift-DCN call: the operations of
    its two products, U = G W^T and dW = A^T G (2 x 2*NHW*9*Cin*Cout), or
    the compulsory bytes (x, f32 offsets, mask, weight and the output
    gradient read; dx, f32 doffset, dmask, dweight and dbias written)."""
    px = N * H * W
    flops = 2 * 2.0 * px * 9 * Cin * Cout
    nbytes = elt_bytes * (2 * px * Cin + 2 * px * 9 + 2 * 9 * Cin * Cout
                          + px * Cout + Cout) + 2 * 4 * px * 18
    return bound_ms(flops, peak_flops, nbytes)


def dcn_backward_kernels_bound_ms(P, Cin, elt_bytes):
    """The bytes bounds of K1's backward kernels at P pixels: both (U read
    and the tile written, x read and dx written, the offsets, mask and
    their gradients), the tap kernel's (U, x, offsets and mask read; the
    tile, doffset and dmask written) and the dx kernel's (U, offsets and
    mask read, dx written)."""
    e = elt_bytes
    return dict(
        kernels=bound_ms(0.0, PEAK_F32_FLOPS, e * (
            2 * P * 9 * Cin + 2 * P * Cin + 2 * P * 9) + 2 * 4 * P * 18)[0],
        tap=bound_ms(0.0, PEAK_F32_FLOPS, e * (
            2 * P * 9 * Cin + P * Cin + 2 * P * 9) + 2 * 4 * P * 18)[0],
        dx=bound_ms(0.0, PEAK_F32_FLOPS, e * (
            P * 9 * Cin + P * Cin + P * 9) + 4 * P * 18)[0])


def convgn_bound_ms(N, H, W, Cin, Cout, elt_bytes, peak_flops):
    """Least time for one fused conv+GN+relu call: the conv's operations
    (the GroupNorm adds a few per output element) or the compulsory bytes
    (x, weight, f32 gamma and beta, out)."""
    px = N * H * W
    flops = 2.0 * px * 9 * Cin * Cout + 6.0 * px * Cout
    nbytes = elt_bytes * (px * Cin + 9 * Cin * Cout + px * Cout) + 8 * Cout
    return bound_ms(flops, peak_flops, nbytes)


def gather_bound_ms(N, R, P, C, elt, idx_bytes, backward=False):
    """Least time for one row gather (K4) or its adjoint: no arithmetic in
    the forward, so the bytes, each output row read once and written once
    and each index read once; the adjoint reads the output gradient and the
    indices and writes the table gradient once, with N*P*C f32 additions
    on the CUDA cores."""
    if not backward:
        return bound_ms(0.0, PEAK_F32_FLOPS,
                        2 * N * P * C * elt + N * P * idx_bytes)
    return bound_ms(N * P * C, PEAK_F32_FLOPS,
                    N * P * C * elt + N * P * idx_bytes + N * R * C * elt)


def dcn_levels():
    """K1's launch at each level, on its wgmma pass and on the WMMA pass
    (the library's ``dcn_shift_forward_pass`` with ``wmma`` set)."""
    gen = torch.Generator().manual_seed(7)
    wmma = dcn_shift.LIB.load().dcn_shift_forward_pass
    for lvl, (h, w) in enumerate(LEVELS):
        for r in (1, 2) if lvl == 1 else (1,):
            x = torch.randn(4, h, w, 256, generator=gen).cuda().bfloat16()
            off = ((torch.rand(4, h, w, 18, generator=gen) * 2 - 1)
                   * 0.8 * r).cuda()
            mask = torch.sigmoid(torch.randn(4, h, w, 9, generator=gen)) \
                .cuda().bfloat16()
            wt = (torch.randn(3, 3, 256, 256, generator=gen) * 0.05) \
                .cuda().bfloat16()
            b = torch.randn(256, generator=gen).cuda().bfloat16()
            out = torch.empty_like(x)
            ms = kernel_ms(lambda: dcn_shift.deform_conv_shift(
                x, off, mask, wt, b, radius=r))

            def old():
                err = wmma(x.data_ptr(), off.data_ptr(), mask.data_ptr(),
                           wt.data_ptr(), b.data_ptr(), out.data_ptr(),
                           4, h, w, 256, 256, r, 1, 1,
                           torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f'K1 WMMA pass: error {err}')
            old_ms = kernel_ms(old)
            bound, by = dcn_bound_ms(4, h, w, 256, 256, 2, PEAK_BF16_FLOPS)
            print(json.dumps(dict(
                what='dcn', level=lvl, shape=f'4x{h}x{w}x256 bf16 r={r}',
                ms_per_call=ms, sum_ms=sum(ms.values()),
                wmma_pass_ms_per_call=old_ms,
                wmma_pass_sum_ms=sum(old_ms.values()), bound_ms=bound,
                bound_by=by)), flush=True)


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
                    path='lanes' if lanes else 'tiled', ms_per_call=ms,
                    bound_ms=dcn_backward_bound_ms(
                        4, h, w, 256, 256, 2, PEAK_BF16_FLOPS),
                    kernels_bound_ms=dcn_backward_kernels_bound_ms(
                        P, 256, 2))), flush=True)


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
    import torch.nn.functional as F
    from ..models.layers import GroupNorm
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
            # the unfused module: cuDNN conv2d on the NCHW (channels_last)
            # view, the port's GroupNorm, relu
            xn = x.permute(0, 3, 1, 2)
            wn = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            gn = GroupNorm(32, cout).cuda()
            with torch.no_grad():
                gn.weight.copy_(gamma)
                gn.bias.copy_(beta)
            with torch.inference_mode():
                unfused = kernel_ms(lambda: F.relu(gn(F.conv2d(
                    xn, wn, padding=1))), calls)
            bound, by = convgn_bound_ms(4, h, w, 256, cout, 2,
                                        PEAK_BF16_FLOPS)
            print(json.dumps(dict(
                what='conv_gn', level=lvl, shape=f'4x{h}x{w}x256->{cout}',
                ms_per_call=kernels, sum_ms=sum(kernels.values()),
                unfused_sum_ms=sum(unfused.values()), bound_ms=bound,
                bound_by=by)), flush=True)


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
    out['gather_grouped_cuda, 1 segment (whole wrapper)'] = per_call_us(
        lambda: gather.gather_grouped_cuda([table], [idx]))
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


# (N, R, C, P): the RU's gathers at levels 0 and 1 of a B=4 640x1152
# request (60 = B x J tables: take_at of the offsets C=8 at K=1000 points,
# the [uvd, conf] corners C=6 at 8000) and at level 0 of a B=4 640x1344
# train step (K = max_pos = 512, and all four corners at once), the
# repair's corners at budget 2048 on 256-channel maps, the probe's shape
GATHER_SHAPES = [(60, 46080, 8, 1000), (60, 46080, 6, 8000),
                 (60, 11520, 8, 1000), (60, 11520, 6, 8000),
                 (60, 53760, 8, 512), (60, 53760, 6, 4 * 4096),
                 (4, 46080, 256, 2048), (1, 11520, 128, 11520)]


def gather_passes():
    """K4's row gather and its adjoint, bf16, int64 indices."""
    gen = torch.Generator().manual_seed(13)
    for N, R, C, P in GATHER_SHAPES:
        idx = torch.randint(0, R, (N, P), generator=gen).cuda()
        table = torch.randn(N, R, C, generator=gen).cuda().bfloat16()
        g = torch.randn(N, P, C, generator=gen).cuda().bfloat16()
        nidx = torch.arange(N, device='cuda')[:, None]
        flat = (idx + nidx * R).reshape(-1)
        g2 = g.reshape(-1, C)
        out = dict(what='gather', shape=f'{N}x{R}x{C} bf16, P={P} int64')
        out['ms_per_call'] = kernel_ms(
            lambda: gather.gather_grouped_cuda([table], [idx]), 20)
        out['indexing_ms_per_call'] = kernel_ms(lambda: table[nidx, idx], 20)
        out['adjoint_ms_per_call'] = kernel_ms(
            lambda: gather.scatter_grouped_cuda([g], [idx], [0], [R],
                                                [torch.bfloat16]), 20)
        # the adjoint's work by PyTorch calls: the f32 zero table,
        # index_add_ of the gradient in f32, the cast
        out['index_add_ms_per_call'] = kernel_ms(
            lambda: torch.zeros(N * R, C, device='cuda')
            .index_add_(0, flat, g2.float()).to(torch.bfloat16), 20)
        out['bound_ms'] = gather_bound_ms(N, R, P, C, 2, 8)[0]
        out['adjoint_bound_ms'] = gather_bound_ms(N, R, P, C, 2, 8,
                                                  backward=True)[0]
        print(json.dumps(out), flush=True)


def sample_points(N, H, W, P, gen):
    """(x, y) (N, P) f32 on the card, anywhere in and just around the
    image."""
    x = torch.rand(N, P, generator=gen) * (W + 3) - 2
    y = torch.rand(N, P, generator=gen) * (H + 3) - 2
    return x.cuda(), y.cuda()


def dcn_points(N, H, W, gen):
    """A 3x3 DCN's nine taps of every pixel of an H x W map, taps outermost
    (N, 9 H W): the pixel, the tap's shift and an offset in (-1, 1), a
    third of them whole numbers and 15% five times farther."""
    tap = torch.arange(9, dtype=torch.float32)
    ys = torch.arange(H, dtype=torch.float32)[None, :, None] \
        + (tap // 3 - 1)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32)[None, None, :] \
        + (tap % 3 - 1)[:, None, None]
    off = torch.rand(2, N, 9, H, W, generator=gen) * 2 - 1
    off[:, :, ::3] = off[:, :, ::3].round()
    off = torch.where(torch.rand(off.shape, generator=gen) < 0.15, off * 5,
                      off)
    return ((xs + off[0]).reshape(N, -1).contiguous().cuda(),
            (ys + off[1]).reshape(N, -1).contiguous().cuda())


def sampler_passes():
    """K4's fused sampler, bf16: the RU's level-0 samples and the repair's
    nine taps against ``F.grid_sample``; exp_panoptic's level-0 DCN masked
    and unmasked."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(19)
    for N, H, W, C, P in [(60, 160, 288, 8, 1000), (60, 160, 288, 6, 8000),
                          (4, 160, 288, 256, 9 * 2048)]:
        x, y = sample_points(N, H, W, P, gen)
        flat = torch.randn(N, H * W, C, generator=gen).cuda().bfloat16()
        grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1],
                           dim=-1)[:, None].bfloat16()
        nchw = flat.reshape(N, H, W, C).permute(0, 3, 1, 2)
        print(json.dumps(dict(
            what='sampler', shape=f'{N}x{H}x{W}x{C} bf16, P={P}',
            ms_per_call=kernel_ms(lambda: gather.sample_rows_bilinear(
                flat, x, y, H, W), 20),
            grid_sample_ms_per_call=kernel_ms(lambda: F.grid_sample(
                nchw, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True), 20))), flush=True)
    N, H, W, C = 4, 160, 288, 256
    x, y = sample_points(N, H, W, 9 * H * W, gen)
    flat = torch.randn(N, H * W, C, generator=gen).cuda().bfloat16()
    mask = torch.sigmoid(torch.randn(N, 9 * H * W, generator=gen)).cuda() \
        .bfloat16()
    print(json.dumps(dict(
        what='sampler', shape=f'{N}x{H}x{W}x{C} bf16, P={9 * H * W} '
        '(exp_panoptic level-0 DCN)',
        masked_ms_per_call=kernel_ms(lambda: gather.sample_rows_bilinear(
            flat, x, y, H, W, mask), 10),
        ms_per_call=kernel_ms(lambda: gather.sample_rows_bilinear(
            flat, x, y, H, W), 10))), flush=True)


def sampler_backward_passes():
    """The sampler's backward kernel, bf16, at the train shapes."""
    gen = torch.Generator().manual_seed(23)
    for N, H, W, C, P in [(4, 160, 336, 256, 9 * 53760),
                          (4, 200, 320, 256, 9 * 64000),
                          (60, 160, 336, 8, 512), (60, 160, 336, 6, 4096),
                          (84, 200, 320, 6, 4096), (84, 25, 40, 6, 8000)]:
        if C == 256:
            x, y = dcn_points(N, H, W, gen)
        else:
            x, y = sample_points(N, H, W, P, gen)
        flat = torch.randn(N, H * W, C, generator=gen).cuda().bfloat16()
        ct = torch.randn(N, P, C, generator=gen).cuda().bfloat16()
        out = dict(what='sampler_backward',
                   shape=f'{N}x{H}x{W}x{C} bf16, P={P}')
        for name, needs in (('all', (True, True, True)),
                            ('image', (True, False, False)),
                            ('coordinates', (False, True, True))):
            out[f'{name}_ms_per_call'] = kernel_ms(
                lambda: gather.sample_rows_bilinear_backward_cuda(
                    ct, flat, x, y, H, W, needs), 10)
        nchw = flat.reshape(N, H, W, C).permute(0, 3, 1, 2)
        grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1],
                           dim=-1)[:, None].bfloat16()
        gout = ct.permute(0, 2, 1)[:, :, None]        # (N, C, 1, P) view
        out['grid_sampler_2d_backward_ms_per_call'] = kernel_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                gout, nchw, grid, 0, 0, True, [True, True]), 10)
        print(json.dumps(out), flush=True)
        del flat, ct, x, y
        torch.cuda.empty_cache()


def dcn_im2col_routes():
    """One served DCN call at exp_panoptic's level 0, by each route."""
    gen = torch.Generator().manual_seed(29)
    N, H, W, C = 4, 160, 288, 256
    raw = torch.randn(N, 27, H, W, generator=gen).cuda().permute(0, 2, 3, 1)
    img = torch.randn(N, H, W, C, generator=gen).cuda().bfloat16()
    off = raw[..., :18] * 1.4
    mask = torch.sigmoid(raw[..., 18:]).bfloat16()
    kernel = (torch.randn(C, C, 3, 3, generator=gen) * 0.02).cuda() \
        .bfloat16().permute(2, 3, 1, 0)
    bias = torch.randn(C, generator=gen).cuda().bfloat16()
    args = (img, off, mask, kernel, bias, 3, 1)
    with torch.inference_mode():
        per_tap = kernel_ms(lambda: deform_conv._deform_conv_per_tap(*args))
        im2col = kernel_ms(lambda: deform_conv._deform_conv_im2col(*args))
    bound, by = dcn_bound_ms(N, H, W, C, C, 2, PEAK_BF16_FLOPS)
    print(json.dumps(dict(
        what='dcn_im2col', shape=f'{N}x{H}x{W}x{C} bf16',
        per_tap_ms_per_call=per_tap, per_tap_sum_ms=sum(per_tap.values()),
        im2col_ms_per_call=im2col, im2col_sum_ms=sum(im2col.values()),
        bound_ms=bound, bound_by=by)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--what', nargs='+',
                    default=['dcn', 'oks_nms', 'conv_gn', 'wrapper'],
                    choices=['dcn', 'dcn_backward', 'oks_nms', 'conv_gn',
                             'wrapper', 'gather', 'sampler',
                             'sampler_backward', 'dcn_im2col'])
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
    if 'gather' in args.what:
        gather_passes()
    if 'sampler' in args.what:
        sampler_passes()
    if 'sampler_backward' in args.what:
        sampler_backward_passes()
    if 'dcn_im2col' in args.what:
        dcn_im2col_routes()


if __name__ == '__main__':
    main()
