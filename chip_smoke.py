#!/usr/bin/env python3
"""Drive the das_tpu_torch serving path on one NVIDIA H100 and check it.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, one line of output each (``[phase] ...``); any failure exits
nonzero and prints no result:

1. environment: torch/CUDA versions, the card and its capability (9, 0)
   required, ``nvidia-smi`` name and power limit, nvcc and triton;
2. build: every kernel of the path from the repository's sources, one
   ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the card, and timed at
   the serving shapes against its bound: ``dcn_shift`` (K1), ``conv_gn``
   (K2, also against the unfused cuDNN conv + GroupNorm + relu), and
   ``oks_nms`` (K3);
4. the main paths at full width, B=4 640x1152 bf16 requests through
   ``make_predict_fn``, each with the kernels' launch counts set to 0 just
   before and read just after: ``configs/das/exp_panoptic_tpu.py`` (16
   ``dcn_shift`` launches per request), then
   ``configs/das/exp_panoptic_tpu_fused_gn.py`` (16 ``dcn_shift`` and 36
   ``conv_gn``); then K3 on the NMS candidates of one fused-GN request,
   against ``oks_nms_fixed`` and the plain version;
5. for each config, the kernel path on the card against the plain path on
   the CPU, fp32, on one small image, same weights.

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SERVING_CFG = os.path.join(HERE, 'configs', 'das', 'exp_panoptic_tpu.py')
FUSED_CFG = os.path.join(HERE, 'configs', 'das',
                         'exp_panoptic_tpu_fused_gn.py')
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
LEVELS = [(160, 288), (80, 144), (40, 72), (20, 36)]   # B=4 640x1152 maps


def phase(name, msg):
    print(f'[{name}] {msg}', flush=True)


def check(ok, what):
    """Fail the run (nonzero exit, no result line) unless ``ok``."""
    if not ok:
        raise SystemExit(f'chip_smoke: FAILED: {what}')


def cuda_ms(fn, iters, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dcn_bound_ms(N, H, W, Cin, Cout, elt_bytes, peak_flops):
    """Least time for one shift-DCN call: the contraction's operations or
    the compulsory bytes (x, f32 offsets, mask, weight, bias, out), the
    larger."""
    px = N * H * W
    flops = 2.0 * px * 9 * Cin * Cout
    nbytes = elt_bytes * (px * Cin + px * 9 + 9 * Cin * Cout + Cout
                          + px * Cout) + 4 * px * 18
    return bound_ms(flops, peak_flops, nbytes)


def bound_ms(flops, peak_flops, nbytes):
    """(ms, 'operations' or 'bytes'): the larger of the two least times."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        'operations' if t_ops >= t_bytes else 'bytes'


def convgn_bound_ms(N, H, W, Cin, Cout, elt_bytes, peak_flops):
    """Least time for one fused conv+GN+relu call: the conv's operations
    (the GroupNorm adds a few per output element) or the compulsory bytes
    (x, weight, f32 gamma and beta, out), the larger."""
    px = N * H * W
    flops = 2.0 * px * 9 * Cin * Cout + 6.0 * px * Cout
    nbytes = elt_bytes * (px * Cin + 9 * Cin * Cout + px * Cout) + 8 * Cout
    return bound_ms(flops, peak_flops, nbytes)


def nms_bound_ms(B, M, J):
    """Least time for one OKS-NMS keep mask: the pairwise similarities, 9
    f32 operations per joint (2 subtractions, 2 products, a sum, 2
    divisions, an exp, an accumulation) and 5 per pair (scale, mean,
    compare) over M(M-1)/2 pairs per image, on the CUDA cores; or the bytes
    (kpts, areas, valid read once, keep written once), the larger."""
    flops = B * M * (M - 1) / 2.0 * (9.0 * J + 5.0)
    nbytes = B * M * (J * 2 * 4 + 4 + 1 + 1)
    return bound_ms(flops, PEAK_F32_FLOPS, nbytes)


def environment():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available()'
                         ' is False)')
    sys.path.insert(0, HERE)
    try:
        import das_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f'chip_smoke: das_tpu_torch is not beside this '
                         f'script ({e})')
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    phase('env', f'python {sys.version.split()[0]} torch {torch.__version__}'
          f' cuda {torch.version.cuda} device {name!r} capability {cap} '
          f'count {torch.cuda.device_count()}')
    if tuple(cap) != (9, 0):
        raise SystemExit(f'chip_smoke: needs compute capability (9, 0), '
                         f'got {cap}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    nvcc = subprocess.run(['bash', '-lc', 'command -v nvcc || ls '
                           '/usr/local/cuda/bin/nvcc'], capture_output=True,
                          text=True).stdout.strip()
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = 'absent'
    phase('env', f'nvcc {nvcc or "absent"}; triton {tri}')
    return name, smi[0]


def build():
    from das_tpu_torch.ops import conv_gn, cuda_build, dcn_shift, oks_nms
    libs = [dcn_shift.LIB, conv_gn.LIB, oks_nms.LIB]
    secs = cuda_build.build_all(libs)
    phase('build', ', '.join(lib.source.name for lib in libs)
          + f' built (one nvcc each, in parallel) and loaded in {secs:.2f} s')
    for lib in libs:
        phase('build', f'{lib.source.name}: {lib.registers()}')


def dcn_vs_plain():
    """Returns the dcn_shift entry of the kernel table."""
    import torch
    from das_tpu_torch.ops import dcn_shift
    from das_tpu_torch.ops.deform_conv import modulated_deform_conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)

    def inputs(n, h, w, cin, cout, dt, spread=1.4, wscale=0.2, far=False):
        x = torch.randn(n, h, w, cin, generator=gen)
        off = (torch.rand(n, h, w, 18, generator=gen) * 2 - 1) * spread
        if far:     # the recipe of tests/test_ops.py:243-251
            off = off.reshape(n, h, w, 9, 2)
            sel = torch.rand(n, h, w, 9, generator=gen) < 0.15
            off[sel] *= 5.0
            off = off.reshape(n, h, w, 18)
        mask = torch.sigmoid(torch.randn(n, h, w, 9, generator=gen))
        wt = torch.randn(3, 3, cin, cout, generator=gen) * wscale
        b = torch.randn(cout, generator=gen)
        return (x.cuda().to(dt), off.cuda(), mask.cuda().to(dt),
                wt.cuda().to(dt), b.cuda().to(dt))

    worst = 0.0
    for shape in [(2, 8, 6, 3, 5), (2, 8, 11, 4, 6)]:
        for r in (1, 2):
            a = inputs(*shape, torch.float32)
            got = dcn_shift.deform_conv_shift(*a, radius=r)
            want = dcn_shift.deform_conv_shift_plain(*a, radius=r)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            check(err <= 1e-4, (shape, r, err))
    phase('kernel', f'dcn_shift fp32 at the test_ops shapes, r=1,2: max abs '
          f'err {worst:.3g} (atol 1e-4) ok')

    a = inputs(1, 160, 288, 256, 256, torch.bfloat16, spread=0.8,
               wscale=0.05)
    got = dcn_shift.deform_conv_shift(*a, radius=1).float()
    want = dcn_shift.deform_conv_shift_plain(*a, radius=1).float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel <= 1e-2, rel)
    phase('kernel', f'dcn_shift bf16 1x160x288x256 r=1: max err / max|ref| '
          f'{rel:.3g} (<= 1e-2) ok')

    n, h, w = 2, 8, 6
    a = inputs(n, h, w, 3, 5, torch.float32, far=True)
    got = modulated_deform_conv(*a, gather_mode='hybrid_pallas',
                                shift_radius=1, shift_budget=h * w)
    want = modulated_deform_conv(*a, gather_mode='patch')
    err = (got - want).abs().max().item()
    check(err <= 1e-4, err)
    phase('kernel', f"hybrid_pallas (kernel + repair) vs exact 'patch', far "
          f'offsets, fp32: max abs err {err:.3g} (atol 1e-4) ok')

    entry = None
    for lvl, (h, w) in enumerate(LEVELS):
        a = inputs(4, h, w, 256, 256, torch.bfloat16, spread=0.8,
                   wscale=0.05)
        got = dcn_shift.deform_conv_shift(*a, radius=1).float()
        want = dcn_shift.deform_conv_shift_plain(*a, radius=1).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        check(rel <= 1e-2, (lvl, rel))
        ms = cuda_ms(lambda: dcn_shift.deform_conv_shift(*a, radius=1), 20)
        plain_ms = cuda_ms(
            lambda: dcn_shift.deform_conv_shift_plain(*a, radius=1), 3)
        bound, by = dcn_bound_ms(4, h, w, 256, 256, 2, PEAK_BF16_FLOPS)
        phase('kernel', f'dcn_shift level {lvl} 4x{h}x{w}x256 bf16 r=1: '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{bound:.4f} ms ({by}), max abs err {err:.4g}')
        if lvl == 0:
            entry = dict(
                name='dcn_shift', route='cuda',
                source='das_tpu_torch/csrc/dcn_shift.cu',
                replaces='das_tpu/ops/pallas_dcn.py:111', launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None,
                shape=f'4x{h}x{w}x256 bf16 r=1')
    return entry


def conv_gn_vs_plain():
    """Returns the conv_gn entry of the kernel table (level 0, Cout 256)."""
    import torch
    import torch.nn.functional as F
    from das_tpu_torch.models.layers import GroupNorm
    from das_tpu_torch.ops import conv_gn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(11)

    def inputs(n, h, w, cin, cout, dt):
        x = torch.randn(n, h, w, cin, generator=gen)
        wt = torch.randn(3, 3, cin, cout, generator=gen) * 0.05
        gamma = torch.rand(cout, generator=gen) + 0.5
        beta = torch.randn(cout, generator=gen) * 0.1
        return (x.cuda().to(dt), wt.cuda().to(dt), gamma.cuda(),
                beta.cuda())

    worst = 0.0
    # tests/test_ops.py:474-475, then element-path shapes (Cin or Cout not
    # a multiple of 8)
    for (h, w, cin, cout, g) in [(8, 16, 8, 8, 4), (10, 18, 32, 64, 8),
                                 (20, 36, 64, 64, 32), (9, 7, 3, 6, 3),
                                 (5, 11, 12, 130, 13)]:
        a = inputs(2, h, w, cin, cout, torch.float32)
        got = conv_gn.conv_gn_relu(*a, groups=g)
        want = conv_gn.conv_gn_relu_plain(*a, groups=g)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        check(err <= 2e-5, ('conv_gn fp32', h, w, cin, cout, g, err))
    phase('kernel', f'conv_gn fp32 at the test_ops shapes and element-path '
          f'shapes: max abs err {worst:.3g} (atol 2e-5) ok')

    def library(x, wt, gamma, beta):
        """The unfused module: cuDNN conv2d in x's type on the NCHW
        (channels_last) view, the port's GroupNorm, relu."""
        xn = x.permute(0, 3, 1, 2)
        w = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        gn = GroupNorm(32, wt.shape[-1]).cuda()
        with torch.no_grad():
            gn.weight.copy_(gamma)
            gn.bias.copy_(beta)
        return lambda: F.relu(gn(F.conv2d(xn, w, padding=1)))

    entry, rows = None, []
    for lvl, (h, w) in enumerate(LEVELS):
        for cout in (256, 64):
            a = inputs(4, h, w, 256, cout, torch.bfloat16)
            got = conv_gn.conv_gn_relu(*a, groups=32).float()
            want = conv_gn.conv_gn_relu_plain(*a, groups=32).float()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            check(rel <= 1e-2, ('conv_gn bf16', lvl, cout, rel))
            lib = library(*a)
            lib_err = (lib().permute(0, 2, 3, 1).float() - want).abs().max()
            ms = cuda_ms(lambda: conv_gn.conv_gn_relu(*a, groups=32), 20)
            lib_ms = cuda_ms(lib, 20)
            plain_ms = cuda_ms(
                lambda: conv_gn.conv_gn_relu_plain(*a, groups=32), 3)
            bound, by = convgn_bound_ms(4, h, w, 256, cout, 2,
                                        PEAK_BF16_FLOPS)
            rows.append((ms, lib_ms))
            phase('kernel', f'conv_gn level {lvl} 4x{h}x{w}x256->{cout} bf16'
                  f' G=32: kernel {ms:.4f} ms, unfused cuDNN conv+GN+relu '
                  f'{lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{bound:.4f} ms ({by}); max err / max|ref| {rel:.3g} '
                  f'(<= 1e-2), unfused vs plain max abs '
                  f'{lib_err.item():.4g}')
            if lvl == 0 and cout == 256:
                entry = dict(
                    name='conv_gn', route='cuda',
                    source='das_tpu_torch/csrc/conv_gn.cu',
                    replaces='das_tpu/ops/pallas_convgn.py:95', launches=0,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=lib_ms,
                    shape=f'4x{h}x{w}x256->256 bf16 G=32')
    # a request runs, per level, 8 launches at Cout 256 and 1 at Cout 64
    per_request = [sum(8 * rows[2 * i][j] + rows[2 * i + 1][j]
                       for i in range(len(LEVELS))) for j in (0, 1)]
    phase('kernel', f'conv_gn summed over the 36 launches of a request '
          f'(8 x Cout 256 + 1 x Cout 64 per level): kernel '
          f'{per_request[0]:.4f} ms, unfused cuDNN conv+GN+relu '
          f'{per_request[1]:.4f} ms')
    return entry


def nms_inputs(B, M, J, seed=0):
    """Candidates with near duplicates (every third pose a jittered copy of
    one before it), areas of the poses' boxes, ~90% valid."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    kpts = rng.rand(B, M, J, 2).astype(np.float32) * 60
    kpts[:, 1::3] = kpts[:, 0::3][:, :kpts[:, 1::3].shape[1]] + \
        rng.randn(*kpts[:, 1::3].shape).astype(np.float32)
    areas = ((kpts[..., 0].max(-1) - kpts[..., 0].min(-1)) *
             (kpts[..., 1].max(-1) - kpts[..., 1].min(-1)))
    valid = rng.rand(B, M) < 0.9
    return (torch.from_numpy(kpts).cuda(), torch.from_numpy(areas).cuda(),
            torch.from_numpy(valid).cuda())


def oks_nms_vs_plain():
    import torch
    from das_tpu_torch.ops import oks_nms
    # the shapes of tests/test_pallas_nms.py, then one request's M
    for B, M, J in [(1, 48, 15), (1, 16, 4), (4, 3720, 15)]:
        a = nms_inputs(B, M, J)
        sig = oks_nms.default_sigmas(J)
        got = oks_nms.oks_nms_keep(*a, 0.9, sig)
        want = oks_nms.oks_nms_keep_plain(*a, 0.9, sig)
        check(torch.equal(got, want), ('oks_nms keep mask', B, M, J))
        check(0 < int(got.sum()) < B * M, ('oks_nms kept', B, M, J))
    phase('kernel', 'oks_nms keep mask == plain, bit for bit, at the '
          'test_pallas_nms shapes (M=48 J=15, M=16 J=4) and at B=4 M=3720 '
          'J=15, near-duplicate candidates ok')


def pose_template(model, radius=12.0):
    """Every candidate's joints on a circle of ``radius`` grid steps around
    its point (the uvd prediction conv's bias), so that candidates at
    neighbouring points overlap at OKS > 0.9 and the NMS suppresses some:
    random head weights alone give poses of a few pixels, which never
    overlap."""
    import torch
    head = model.bbox_head
    J = head.num_joints
    ang = torch.arange(J, dtype=torch.float32) * (2 * math.pi / J)
    uvd = torch.stack([radius * torch.cos(ang), radius * torch.sin(ang),
                       torch.zeros(J)], dim=-1).reshape(-1)
    with torch.no_grad():
        head.conv_cls.bias.zero_()          # let poses pass score_thr
        bias = head.conv_poses[0].bias
        bias.copy_(uvd.to(bias.device, bias.dtype))


def same_up_to_ties(a, b, scores, cut):
    """Index lists ``a`` and ``b`` pick the same scores in the same order
    and, within each run of equal scores, the same indices; a run that
    reaches the ``cut`` of the list may hold different members."""
    if len(a) != len(b) or scores[a].tolist() != scores[b].tolist():
        return False
    sa = scores[a].tolist()
    last = sa[-1] if len(a) == cut else None
    return all(set(a[[i for i, s in enumerate(sa) if s == v]].tolist()) ==
               set(b[[i for i, s in enumerate(sa) if s == v]].tolist())
               for v in set(sa) if v != last)


def nms_on_served_request(model, cfg, img, sf):
    """K3 on the NMS candidates of one served request. Returns the oks_nms
    entry of the kernel table."""
    import torch
    from das_tpu_torch.core.decode import decode_candidates
    from das_tpu_torch.ops import oks_nms
    head = cfg.model.bbox_head
    test_cfg = dict(cfg.model.test_cfg)
    J, thr = int(head.num_joints), float(test_cfg['nms_thr'])
    post = int(test_cfg['nms_post'])
    sig = oks_nms.default_sigmas(J)
    pose_template(model)
    with torch.inference_mode():
        cls, pose, ctr, _ = model(img)
        c = decode_candidates(cls, pose, ctr, tuple(head.strides), sf, J,
                              test_cfg)
        B, M = c['nms_scores'].shape
        check(bool(c['valid'].any()), 'no valid candidate')
        order = torch.sort(c['nms_scores'], dim=1, descending=True,
                           stable=True).indices
        nidx = torch.arange(B, device=order.device)[:, None]
        kpts = c['xy'][nidx, order].contiguous()
        areas = c['areas'][nidx, order].contiguous()
        valid = c['valid'][nidx, order].contiguous()
        torch.cuda.synchronize()
        oks_nms.launches = 0
        keep = oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig)
        torch.cuda.synchronize()
        launches = oks_nms.launches
        plain = oks_nms.oks_nms_keep_plain(kpts, areas, valid, thr, sig)
        check(torch.equal(keep, plain), 'served keep mask != plain')
        gather, out_valid = oks_nms.oks_nms_fixed(
            c['xy'], c['nms_scores'], c['areas'], c['valid'], thr, sig,
            max_dets=post)
        kept = keep.sum(1).tolist()
        check(all(0 < k < M for k in kept), ('kept per image', kept, M))
        for b in range(B):
            mine = order[b][keep[b]][:post].cpu()
            fixed = gather[b][out_valid[b]].cpu()
            check(same_up_to_ties(mine, fixed, c['nms_scores'][b].cpu(),
                                  post), ('oks_nms_keep != oks_nms_fixed',
                                          b))
        ms = cuda_ms(lambda: oks_nms.oks_nms_keep(kpts, areas, valid, thr,
                                                  sig), 20)
        plain_ms = cuda_ms(lambda: oks_nms.oks_nms_keep_plain(
            kpts, areas, valid, thr, sig), 1)
        fixed_ms = cuda_ms(lambda: oks_nms.oks_nms_fixed(
            c['xy'], c['nms_scores'], c['areas'], c['valid'], thr, sig,
            max_dets=post), 3)
    bound, by = nms_bound_ms(B, M, J)
    phase('nms', f'served fused-GN request, B={B} M={M} J={J}: '
          f'{int(valid.sum())} valid, kept per image {kept}; keep mask == '
          f'plain; first {post} kept == oks_nms_fixed (up to equal-score '
          f'swaps); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'oks_nms_fixed {fixed_ms:.4f} ms, bound {bound:.4f} ms ({by}); '
          f'{launches} launch')
    return dict(name='oks_nms', route='cuda',
                source='das_tpu_torch/csrc/oks_nms.cu',
                replaces='das_tpu/ops/pallas_nms.py:88', launches=launches,
                max_abs_err=float((keep != plain).sum().item()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, oks_nms_fixed_ms=fixed_ms,
                shape=f'B={B} M={M} J={J} served candidates')


def perturb_offsets(model, seed=1, spread=0.3, shift=0.5):
    """Seeded conv_offset weights at spread/sqrt(fan_in), so that offsets
    are O(spread), and ``shift`` added to tap 0's dy bias, so that a few of
    those pass radius 1: the shift base and the exact repair both run, and
    the flagged pixels stay within the repair budget."""
    import torch
    from das_tpu_torch.models.layers import DeformConv2d
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                wt = m.conv_offset.weight
                fan_in = wt[0].numel()
                noise = torch.randn(wt.shape, generator=gen) \
                    * spread / math.sqrt(fan_in)
                wt.copy_(noise.to(wt.device, wt.dtype))
                m.conv_offset.bias[0] += shift


def flagged_per_layer(model, img):
    """Per DCN layer, the pixels with a tap offset beyond radius 1."""
    import torch
    from das_tpu_torch.models.layers import DeformConv2d
    from das_tpu_torch.ops.deform_conv import deform_offset_overflow
    counts = []
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, DeformConv2d):
            def hook(mod, inp, out, name=name):
                off = out[:, :18].permute(0, 2, 3, 1)
                counts.append((name, int(deform_offset_overflow(
                    off, 1, 0).sum())))
            hooks.append(m.conv_offset.register_forward_hook(hook))
    with torch.inference_mode():
        model(img)
    for h in hooks:
        h.remove()
    return counts


def main_path(cfg_path, requests, expect):
    """Serve ``requests`` B=4 640x1152 bf16 requests of ``cfg_path``. Every
    count of ``expect`` ({kernel module: launches per request}) is set to 0
    just before the requests and read just after; each request must launch
    exactly its share. Returns (model, cfg, {name: launches}, last image,
    scale factors)."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    name = os.path.basename(cfg_path)[:-3]
    t0 = time.perf_counter()
    model, cfg = init_model(cfg_path, dtype=torch.bfloat16, device='cuda')
    perturb_offsets(model)
    head = cfg.model.bbox_head
    predict = make_predict_fn(model, cfg.model.test_cfg, head.num_joints,
                              head.strides, device='cuda')
    torch.cuda.synchronize()
    phase('main', f"{name} (dcn_gather_mode={head.dcn_gather_mode!r}, "
          f"r={head.dcn_shift_radius}, conv_bias={head.conv_bias!r}, "
          f"fused_gn={head.get('fused_gn', False)}, "
          f"sparse_refine={cfg.model.test_cfg.sparse_refine}) built in bf16 "
          f'on the card in {time.perf_counter() - t0:.1f} s, '
          f'{sum(p.numel() for p in model.parameters())} parameters')

    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.randn(4, 640, 1152, 3).astype(np.float32))
            .cuda() for _ in range(requests + 1)]
    sf = torch.ones(4, 2, device='cuda')
    flagged = flagged_per_layer(model, imgs[0].to(torch.float32))
    total = sum(c for _, c in flagged)
    phase('main', 'pixels beyond radius 1 per DCN layer (request 0, B=4, '
          'all levels): ' + ', '.join(
              f'{n.replace("bbox_head.", "")}={c}' for n, c in flagged))
    check(total > 0, 'no offset left radius 1: the repair never ran')
    predict(imgs[0], sf)                     # warm-up request
    torch.cuda.synchronize()

    for mod in expect:
        mod.launches = 0
    times = []
    for i in range(1, requests + 1):
        before = {mod: mod.launches for mod in expect}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict(imgs[i], sf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        got = {mod: mod.launches - before[mod] for mod in expect}
        for k, v in out.items():
            if v.is_floating_point():
                check(torch.isfinite(v).all(), k)
        check(out['poses'].shape == (4, 100, head.num_joints, 3),
              tuple(out['poses'].shape))
        counts = ', '.join(f'{n} {mod.__name__.rsplit(".", 1)[-1]}'
                           for mod, n in got.items())
        phase('main', f'{name} request {i}: B=4 640x1152 in '
              f'{times[-1]:.2f} ms, {int(out["valid"].sum())} valid poses, '
              f'launches: {counts}')
        check(all(got[mod] == n for mod, n in expect.items()),
              (name, 'launches per request', counts))
    totals = {mod.__name__.rsplit('.', 1)[-1]: mod.launches
              for mod in expect}
    phase('main', f'{name}: {requests} requests ok, mean '
          f'{np.mean(times):.2f} ms, median {np.median(times):.2f} ms, '
          f'launches {totals}, outputs finite')
    return model, cfg, totals, imgs[-1], sf


def kernel_path_vs_plain_path(cfg_path, expect):
    """Same fp32 weights on the card (kernel) and on the CPU (plain); the
    card's forward launches ``expect`` = (dcn_shift, conv_gn) kernels."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    from das_tpu_torch.ops import conv_gn, dcn_shift
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_name = os.path.basename(cfg_path)[:-3]
    cpu, cfg = init_model(cfg_path, device='cpu', seed=3)
    perturb_offsets(cpu, seed=2)
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()   # let poses pass score_thr
    gpu, _ = init_model(cfg_path, device='cuda', seed=3)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    img = torch.from_numpy(np.random.RandomState(5).randn(1, 128, 160, 3)
                           .astype(np.float32))
    test_cfg = cfg.model.test_cfg
    nms_pre = int(test_cfg.nms_pre)
    with torch.inference_mode():
        outs_c = cpu(img)
        # both sides refine the same points: the top-nms_pre set is taken
        # once, from the CPU outputs
        sel = []
        for c, t in zip(outs_c[0], outs_c[2]):
            r = (torch.sigmoid(c) * torch.sigmoid(t)).reshape(1, -1)
            sel.append(torch.topk(r, nms_pre, dim=1).indices
                       if r.shape[1] > nms_pre else None)
        outs_c = cpu(img, sel)
        before = (dcn_shift.launches, conv_gn.launches)
        outs_g = gpu(img.cuda(), [None if s is None else s.cuda()
                                  for s in sel])
        ran = (dcn_shift.launches - before[0], conv_gn.launches - before[1])
    check(ran == expect,
          (cfg_name, 'fp32 launches (dcn_shift, conv_gn)', ran))
    worst = 0.0
    for name, lc, lg in zip(('cls', 'pose', 'ctr', 'ref_uvd'), outs_c,
                            outs_g):
        for lvl, (c, g) in enumerate(zip(lc, lg)):
            err = (g.cpu() - c).abs().max().item() / \
                max(1.0, c.abs().max().item())
            worst = max(worst, err)
            check(err <= 1e-3, (name, lvl, err))
    head = cfg.model.bbox_head
    args = (test_cfg, head.num_joints, head.strides)
    sf = np.ones((1, 2), np.float32)
    dc = make_predict_fn(cpu, *args, device='cpu')(img, sf)
    dg = {k: v.cpu() for k, v in
          make_predict_fn(gpu, *args, device='cuda')(img, sf).items()}
    nv = int(dc['valid'].sum())
    check(int(dg['valid'].sum()) == nv and nv > 0, (nv, dg['valid'].sum()))
    # entry by entry up to swaps of near-equal scores: each card pose must
    # match a CPU pose whose score is within 1e-4; the lowest-scored
    # entries, where a near tie can cross the nms_post cut, are skipped
    sc, sg = dc['scores'][0][:nv], dg['scores'][0][:nv]
    pc, pg = dc['poses'][0][:nv], dg['poses'][0][:nv]
    check((sc - sg).abs().max().item() <= 1e-4, 'decoded scores differ')
    cut = sc.min().item() + 1e-4
    pose_err = 0.0
    for i in range(nv):
        if sg[i] <= cut:
            continue
        near = (sc - sg[i]).abs() <= 1e-4
        d = (pc[near] - pg[i]).abs().amax(dim=(1, 2)).min().item()
        pose_err = max(pose_err, d / max(1.0, pg[i].abs().max().item()))
    check(pose_err <= 1e-3, pose_err)
    phase('plain', f'{cfg_name} B=1 128x160 fp32 kernel path (card: '
          f'{ran[0]} dcn_shift, {ran[1]} conv_gn launches) vs plain path '
          f'(CPU): head outputs max err / max|ref| {worst:.3g} (<= 1e-3); '
          f'decode: {nv} valid on both, scores within 1e-4, poses max err '
          f'/ max|pose| {pose_err:.3g} (<= 1e-3) ok')


def main():
    import torch
    name, smi = environment()
    from das_tpu_torch.ops import conv_gn, dcn_shift
    build()
    k1 = dcn_vs_plain()
    k2 = conv_gn_vs_plain()
    oks_nms_vs_plain()
    model, _, n1, _, _ = main_path(SERVING_CFG, 2,
                                   {dcn_shift: 16, conv_gn: 0})
    del model
    model, cfg, n2, img, sf = main_path(FUSED_CFG, 3,
                                        {dcn_shift: 16, conv_gn: 36})
    k3 = nms_on_served_request(model, cfg, img, sf)
    del model
    k1['launches'] = n1['dcn_shift'] + n2['dcn_shift']
    k2['launches'] = n2['conv_gn']
    for k in (k1, k2, k3):
        check(k['launches'] > 0, f'the main path launched no {k["name"]}')
    kernel_path_vs_plain_path(SERVING_CFG, (16, 0))
    kernel_path_vs_plain_path(FUSED_CFG, (16, 36))
    print(json.dumps({'kernels': [k1, k2, k3]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
