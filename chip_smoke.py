#!/usr/bin/env python3
"""Drive the das_tpu_torch serving path on one NVIDIA H100 and check it.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, one line of output each (``[phase] ...``); any failure exits
nonzero and prints no result:

1. environment: torch/CUDA versions, the card and its capability (9, 0)
   required, ``nvidia-smi`` name and power limit, nvcc and triton;
2. build: every kernel of the path from the repository's sources;
3. each kernel against its plain PyTorch version on the card, and timed at
   the serving shapes against its bound;
4. the main path at full width: ``configs/das/exp_panoptic_tpu.py`` in
   bf16, B=4 640x1152 requests through ``make_predict_fn``, with the
   kernels' launch counts read around the requests;
5. the kernel path on the card against the plain path on the CPU, fp32,
   on one small image, same weights.

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
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
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
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        'operations' if t_ops >= t_bytes else 'bytes'


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
    from das_tpu_torch.ops import dcn_shift
    secs = dcn_shift.load_seconds()
    regs = [ln.strip() for ln in dcn_shift.build_log.splitlines()
            if 'registers' in ln]
    phase('build', f'dcn_shift.cu built and loaded in {secs:.2f} s; '
          + ' | '.join(regs))


def kernels_vs_plain():
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


def main_path(requests=4):
    import numpy as np
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    from das_tpu_torch.ops import dcn_shift
    t0 = time.perf_counter()
    model, cfg = init_model(SERVING_CFG, dtype=torch.bfloat16, device='cuda')
    perturb_offsets(model)
    head = cfg.model.bbox_head
    predict = make_predict_fn(model, cfg.model.test_cfg, head.num_joints,
                              head.strides, device='cuda')
    torch.cuda.synchronize()
    phase('main', f"exp_panoptic_tpu (dcn_gather_mode="
          f"{head.dcn_gather_mode!r}, r={head.dcn_shift_radius}, "
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

    dcn_shift.launches = 0
    times, launches = [], []
    for i in range(1, requests + 1):
        before = dcn_shift.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict(imgs[i], sf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        launches.append(dcn_shift.launches - before)
        for k, v in out.items():
            if v.is_floating_point():
                check(torch.isfinite(v).all(), k)
        check(out['poses'].shape == (4, 100, head.num_joints, 3),
              tuple(out['poses'].shape))
        phase('main', f'request {i}: B=4 640x1152 in {times[-1]:.2f} ms, '
              f'{int(out["valid"].sum())} valid poses, '
              f'{launches[-1]} dcn_shift launches')
    total_launches = dcn_shift.launches
    check(all(n == 16 for n in launches), launches)
    phase('main', f'{requests} requests ok: mean {np.mean(times):.2f} ms, '
          f'median {np.median(times):.2f} ms, {total_launches} dcn_shift '
          f'launches (16 per request), outputs finite')
    return model, cfg, total_launches


def kernel_path_vs_plain_path(cfg):
    """Same fp32 weights on the card (kernel) and on the CPU (plain)."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, _ = init_model(SERVING_CFG, device='cpu', seed=3)
    perturb_offsets(cpu, seed=2)
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()   # let poses pass score_thr
    gpu, _ = init_model(SERVING_CFG, device='cuda', seed=3)
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
        outs_g = gpu(img.cuda(), [None if s is None else s.cuda()
                                  for s in sel])
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
    phase('plain', f'B=1 128x160 fp32 kernel path (card) vs plain path '
          f'(CPU): head outputs max err / max|ref| {worst:.3g} (<= 1e-3); '
          f'decode: {nv} valid on both, scores within 1e-4, poses max err '
          f'/ max|pose| {pose_err:.3g} (<= 1e-3) ok')


def main():
    import torch
    name, smi = environment()
    build()
    entry = kernels_vs_plain()
    _, cfg, launches = main_path()
    check(launches > 0, 'the main path launched no dcn_shift kernel')
    entry['launches'] = launches
    kernel_path_vs_plain_path(cfg)
    print(json.dumps({'kernels': [entry]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
