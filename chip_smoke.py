#!/usr/bin/env python3
"""Drive the das_tpu_torch serving and training paths on one NVIDIA H100
and check them.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, one line of output each (``[phase +seconds since the start] ...``);
any failure exits nonzero and prints no result:

1. environment: torch/CUDA versions, the card and its capability (9, 0)
   required, ``nvidia-smi`` name and power limit, nvcc and triton, and
   ``utils/collect_env.py``'s report;
2. build: the host library with g++, then every kernel of the path from
   the repository's sources, one ``nvcc`` per source, all started
   together;
3. each kernel against its plain PyTorch version on the card, and timed at
   the serving shapes against its bound: ``dcn_shift`` (K1: its wgmma pass
   at the four levels at r=1 and at level 1 at r=2, two runs equal bit for
   bit, and timed beside the WMMA pass it took the place of; its backward,
   every output against the closed form at small f32 and bf16 shapes with
   offsets all 0, exactly +-r and generic, and at the four train levels,
   timed beside the closed form and its bound; its tiled pass's tile equal
   to the lane pass's and its dx the same bits, run to run and as the lane
   pass's, and the two passes' tap kernels and the dx kernel they share
   timed side by side with their bytes bound), ``conv_gn``
   (K2, also against the unfused cuDNN conv + GroupNorm + relu),
   ``oks_nms`` (K3: the keep mask bit for bit, with and without
   ``max_keep``, also where M is no multiple of 64 or below 64), and K4:
   ``gather_rows`` (the row gather of every
   bilinear sample that takes a gradient and of the RU ``take_at``, forward
   and backward, also against plain indexing and ``index_add_``), the
   grouped gather (several gathers, and all their gradients, in one launch
   each) and ``sample_rows_bilinear`` (a whole bilinear sample in one
   launch where no gradient is asked for, bit for bit against the plain
   composition and timed against ``F.grid_sample``);
4. the main paths at full width, B=4 640x1152 bf16 requests through
   ``make_predict_fn``, each with the kernels' launch counts set to 0 just
   before and read just after: ``configs/das/exp_panoptic_tpu.py`` (per
   request 16 ``dcn_shift`` launches, 3 grouped row gathers, 8 fused
   samples and one more per DCN call that repairs), then
   ``configs/das/exp_panoptic_tpu_fused_gn.py`` (the same and 36
   ``conv_gn``); then K3 on the NMS candidates of
   one fused-GN request, against ``oks_nms_fixed`` and the plain version;
5. for each config, the kernel path on the card against the plain path on
   the CPU, fp32, on one small image, same weights;
6. training at full width: 5 steps of ``make_train_step`` on
   ``configs/das/exp_panoptic_tpu.py`` at B=4 640x1344 (its train bucket),
   bf16 compute on f32 master weights, on a synthetic TrainLoader batch,
   with the counts set to 0 just before and read just after (per step, as
   ``train_step_launches`` derives them from the config: under the head's
   ``remat`` 24 row gathers (12 and their recompute) and 12 adjoint
   launches, 32 K1 forward (16 and their recompute) and 16 K1 backward,
   all 16 on its tiled pass and timed inside each step by CUDA events, no
   plain shift expansion); then that
   step's gradient pass, full depth, in bf16 and in f32, with K4 (each
   launch also held against the plain version on its own inputs) and with
   the plain pair in its place on the card, gradients compared leaf by
   leaf; the same pass in f32 with K1's backward (each call held against
   the closed form on its own inputs) and with autograd through the plain
   shift expansion in its place; then one fp32 step at B=2 128x160 on the
   card (K4 and K1
   live) against the same step on the CPU (plain);
7. evaluation ("eval"), through ``apis/test.py::run_test`` with device
   preprocessing: 8 synthetic 1920x1080 PNG frames (written by this script:
   zlib over filter-0 rows) and a CMU-Panoptic-format json under
   ``build/``; both serving configs in bf16 (B=4 640x1152, 2 batches, the
   launch counts set to 0 as each batch's forward starts and read as its
   decode returns: 16 K1 of which 16 on the wgmma pass, 1 K3, 3 grouped
   gathers, fused samples within K4_SAMPLES, and 36 K2 on the fused
   config), people found and MPJPE finite; the device preprocessing of a
   batch against a float64 reference (<= 1e-4); ``fuse_conv_bn`` at full
   width, fused against unfused in f32, and both timed in bf16; run_test
   on the card against the CPU at 240x320; and ``python -m
   das_tpu_torch.tools.test`` once as a subprocess;
8. the training entry point ("trainrun"): a synthetic shipped mix on disk
   under ``build/`` (8 CMU-Panoptic-format 1920x1080 JPEG frames with 3-4
   people each and 8 COCO-17 keypoint frames at 640x480); the TrainLoader
   alone (images/s, and its resizes and warps all through the host
   library, none through cv2); ``apis/train.py::train_model`` on
   ``configs/das/exp_panoptic_tpu.py`` from those files through the shipped
   random pipelines, B=4 640x1344 bf16 on f32 master weights, 6 steps of 4
   an epoch (every loss finite, 24 + 12 K4 and 32 + 16 K1 launches and no
   K3 each step; one profiled step for the device's busy and idle share), the
   epoch-end save, DCN-offset check and eval hook on phase 7's frames (the
   served launch counts per batch), the final save; a resume from
   ``latest`` for one step (restored tensors, ``count`` and ``step`` bit for
   bit; its losses against the same step from the run's own final state);
   and ``python -m das_tpu_torch.tools.train`` once as a subprocess for 2
   steps. The counts are set to 0 just before the first ``train_model`` run
   and read just after; those launches go into the kernels line;
9. data parallelism ("dataparallel", ``parallel/mesh.py``): a NCCL process
   group of this process alone (world of one, the card's own NCCL path):
   the cut fp32 step of phase 6 at B=4 through the group path against the
   same step with no group, a full-width bf16 step over NCCL, and
   ``run_test`` through the group against phase 7's results; then two ranks
   spawned on the one card over gloo (NCCL takes one rank a card): the cut
   fp32 step at B=2 a rank against one process at B=4, ``train_model`` on
   phase 8's mix at B=2 a rank for one epoch (4 steps; 24 + 12 K4 launches
   a step on each rank, replicas bit-equal, one checkpoint by rank 0, the
   DCN check and the sharded eval hook), the sharded ``run_test`` against
   phase 7's results; ``python -m torch.distributed.run --nproc-per-node 2
   -m das_tpu_torch.tools.train ... --launcher pytorch --dist-backend
   gloo``; and, on a host with two cards or more, ``train_model`` over
   NCCL, one card a rank. The ranks' launches go into the kernels line as
   ``phase9_launches_per_rank``;
10. the remaining entry points and tools ("tools"): the C++ host library
   (``datasets/native.py``, built with g++ in phase 2) on a smooth
   1920x1080 float32 frame, timed beside cv2: the resize within 0.51 of
   cv2, the warp within 1e-3 of an exact float64 warp and within 0.5 of
   cv2 inside the frame; ``python -m
   das_tpu_torch.tools.demo`` on exp_panoptic_tpu with phase 7's weights on
   a 640x480 frame, in bf16 on the card (the request's launches asserted as
   phase 4's: 16 K1, 1 K3, 3 grouped gathers, fused samples within
   K4_SAMPLES) and in f32 on the card against the CPU (the same people);
   ``validate_hybrid`` on the card against the CPU (the same flagged pixels
   per DCN call, max|off| within VALIDATE_RTOL, the same exit code); phase
   8's checkpoints through ``export_torch``, ``publish_model`` and
   ``fuse_conv_bn``, each file loaded strictly by ``init_model``; and one
   request under ``utils/profiling.trace``, whose trace names K1's kernel.
   The demo's card launches go into the kernels line (and
   ``phase10_launches``);
11. the reference's Panoptic recipe served ("main", "plain"):
   ``configs/das/exp_panoptic.py``, whose DCNs serve by the exact
   'patch' gather, 3 B=4 640x1152 bf16 requests (per request no K1, 24
   fused samples (16 DCN calls, 8 RU samples), 3 grouped gathers, 1 K3, as
   ``serve_launches`` derives them), then its kernel path against the CPU's
   plain path at 128x160 fp32;
12. its training ("train"): ``make_trainer`` steps at B=4 640x1344 bf16
   with its 'clip' DCNs (K4's row gather and adjoint at every DCN call:
   under the head's remat 56 + 28 a step), step ms, peak memory and the
   device's busy ms of a profiled step, and the gradient pass with K4
   against its plain pair on the card;
13. the paper's MuPoTS recipe served and evaluated ("mupots"):
   ``configs/das/exp_mupots.py`` (21 joints, root 14, a 3-stage MSPN2, two
   RU layers of which the last sparsifies, nms_thr 0.9), 3 B=4 736x1280
   bf16 requests (its test bucket; 36 fused samples, 3 grouped gathers and
   K3 at J=21 a request), ``run_test`` with device preprocessing over 20
   synthetic MuPoTS-3D frames (TS1-TS20 with their ``annot.mat`` and
   ``occlusion.mat``) and the MuPoTS evaluator's 3DPCK of the card's
   outputs, then its kernel path against the CPU's plain path, full depth;
14. its training ("mupots"): ``train_model`` on its MuCo-3DHP + COCO mix
   from synthetic frames on disk, B=4 800x1280 bf16, 3 steps (40 + 40 K4
   launches a step), then the same gradient pass and step with ``remat``
   as shipped and with ``remat=False`` from the same weights and batch:
   step ms and peak memory of each, loss terms and BN statistics bit for
   bit, gradients within their pass-to-pass noise;
15. the sustained run's tool ("train_run"): ``python -m
   das_tpu_torch.tools.train_run`` (in this process) on exp_panoptic_tpu
   for 40 steps from disk, its artifact finite and parsed.
   The launches of phases 11-15 go into the kernels line (and
   ``recipes_launches``).

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
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
BF16_STEP = 2.0 ** -7         # bf16's spacing relative to a value in [1, 2)
# a gradient leaf that is zero to rounding: its largest value below this
# fraction of the largest of all leaves (a conv bias before a norm)
ZERO_GRAD = 1e-6
# how many times its measured rounding noise a gradient leaf may be off
GRAD_NOISE = 10.0
# a gradient leaf of the card's train step against the CPU's, relative to
# its largest CPU value (see train_kernel_vs_plain)
CARD_CPU_RTOL = 2e-2
# K4 launches (row gathers and fused samples) that a served request may
# make: a quarter of the 210 it made with one launch per corner. A request
# makes 3 grouped gathers (take_at at the sparse levels 0-2), 8 fused
# samples (two per level) and one fused sample per DCN call that repairs,
# of 16 DCN calls
K4_PER_REQUEST = 52
K4_SAMPLES = (9, 24)
TRAIN_HW = (640, 1344)        # exp_panoptic's train bucket
TRAIN_LEVELS = [(160, 336), (80, 168), (40, 84), (20, 42)]  # B=4 640x1344


STARTED = time.perf_counter()


def train_step_launches(cfg, hw, max_pos):
    """(K4 forward, K4 backward, K1 forward, K1 backward) launches of one
    train step of ``cfg`` at the ``hw`` bucket with ``max_pos``, derived
    from the model code:

    - the DCN calls: the 3 towers' last convs and each RU layer's update
      conv at 4 levels, all of whose inputs ask for gradients; each is one
      K1 forward and one K1 backward under ``'shift'``, or one row gather
      of the nine taps' four corners and its adjoint under ``'clip'``;
    - the RU's sampling, one gather and one adjoint a sample: the last
      layer at a level of more than ``max_pos`` points (sparse) makes three
      launches that depend on one another (the grouped take_at, the sample
      of the offsets at the points it gives, the sample of [uvd, conf] at
      the candidates that gives), at a dense level two; an earlier layer
      is dense at every level;
    - remat (``models/layers.remat``): the head's ``remat`` recomputes each
      tower conv in the backward, the RU's (the head's by default) each RU
      layer, so their forward launches run again; no backward launch runs
      twice. The backbone's stages launch no kernel."""
    head = cfg.model.bbox_head
    ru = dict(head.get('recursive_update') or {})
    layers = int(ru.get('num_layers', 1))
    head_remat = bool(head.get('remat', False))
    ru_remat = bool(ru.get('remat', head_remat))
    mode = head.get('dcn_train_gather_mode', 'auto')
    if mode == 'auto':
        mode = {'patch': 'clip', 'shift_pallas': 'shift'}.get(
            head.get('dcn_gather_mode', 'patch'))
    check(mode in ('clip', 'shift'), ('no launch count for the lowering',
                                      mode))
    sparse = bool((cfg.model.get('train_cfg') or {}).get('sparse_refine'))
    points = [(hw[0] // (4 * 2 ** i)) * (hw[1] // (4 * 2 ** i))
              for i in range(4)]
    last = sum(3 if sparse and n > max_pos else 2 for n in points)
    ru_samples = 8 * (layers - 1) + last
    towers, ru_dcn = 12, 4 * layers
    k4_dcn = int(mode == 'clip')
    k4 = (towers + ru_dcn) * k4_dcn + ru_samples
    k4_again = towers * k4_dcn * head_remat \
        + (ru_dcn * k4_dcn + ru_samples) * ru_remat
    k1 = (towers + ru_dcn) * (1 - k4_dcn)
    k1_again = (towers * head_remat + ru_dcn * ru_remat) * (1 - k4_dcn)
    return k4 + k4_again, k4, k1 + k1_again, k1


def tpu_step():
    """``train_step_launches`` of exp_panoptic_tpu's steps in phases 6, 8
    and 9 (640x1344, max_pos 512 = 128 an image of a global batch of 4)."""
    from das_tpu_torch.config import Config
    return train_step_launches(Config.fromfile(SERVING_CFG), TRAIN_HW, 512)


def phase(name, msg):
    """One line of a phase, with the seconds since the script started."""
    print(f'[{name} +{time.perf_counter() - STARTED:.1f}s] {msg}',
          flush=True)


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


def dcn_backward_bound_ms(N, H, W, Cin, Cout, elt_bytes, peak_flops):
    """Least time for the backward of one shift-DCN call: the operations of
    its two products, U = G W^T and dW = A^T G (2 x 2*NHW*9*Cin*Cout), or
    the compulsory bytes (x, f32 offsets, mask, weight and the output
    gradient read; dx, f32 doffset, dmask, dweight and dbias written), the
    larger."""
    px = N * H * W
    flops = 2 * 2.0 * px * 9 * Cin * Cout
    nbytes = elt_bytes * (2 * px * Cin + 2 * px * 9 + 2 * 9 * Cin * Cout
                          + px * Cout + Cout) + 2 * 4 * px * 18
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


def nms_joint_terms(kpts, areas, thr, sigmas, margin=0.01):
    """The joint terms that these candidates' pairs need: a pair (i, j < i)
    is summed joint by joint until even terms of 1 for every joint left
    could not lift its mean above ``thr`` (the kernel's early exit, with its
    margin on the sum), so a pair of far poses needs a few joints and a
    pair that suppresses needs all J."""
    import torch
    from das_tpu_torch.ops.oks_nms import EPS, _nms_var2
    B, M, J, _ = kpts.shape
    var2 = _nms_var2(sigmas, kpts.device)
    left = torch.arange(J - 1, -1, -1, device=kpts.device,
                        dtype=torch.float32)
    need = thr * J - margin
    terms = 0
    for b in range(B):
        for i0 in range(0, M, 256):
            rows = kpts[b, i0:i0 + 256]
            d2 = ((rows[:, None] - kpts[b][None]) ** 2).sum(-1)   # (r, M, J)
            scale = (areas[b, i0:i0 + 256, None] + areas[b][None]) * 0.5 \
                + EPS
            cum = torch.exp(-d2 / var2 / scale[..., None]).cumsum(-1)
            stops = cum + left < need                # joint k ends the pair
            n = torch.where(stops.any(-1), stops.float().argmax(-1) + 1, J)
            below = torch.arange(M, device=kpts.device)[None] < \
                torch.arange(i0, i0 + rows.shape[0],
                             device=kpts.device)[:, None]
            terms += int((n * below).sum())
    return terms


def nms_bound_ms(B, M, J, joint_terms=None):
    """Least time for one OKS-NMS keep mask: the pairwise similarities, 9
    f32 operations per joint term (2 subtractions, 2 products, a sum, 2
    divisions, an exp, an accumulation) and 5 per pair (scale, mean,
    compare) over M(M-1)/2 pairs per image, on the CUDA cores; or the bytes
    (kpts, areas, valid read once, keep written once), the larger.
    ``joint_terms``: the terms this run's data needs (``nms_joint_terms``);
    without it, J for every pair."""
    pairs = B * M * (M - 1) / 2.0
    if joint_terms is None:
        joint_terms = pairs * J
    flops = 9.0 * joint_terms + 5.0 * pairs
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
    try:
        import cv2
        cv = cv2.__version__
    except ImportError:
        cv = 'absent'
    phase('env', f'nvcc {nvcc or "absent"}; triton {tri}; cv2 {cv}')
    from das_tpu_torch.utils.collect_env import collect_env
    phase('env', 'collect_env: ' + '; '.join(
        f'{k}: {v}' for k, v in collect_env().items()))
    return name, smi[0]


def build():
    """The host library (g++, ``datasets/native.py``), then every CUDA
    source (one nvcc each, started together)."""
    from das_tpu_torch.datasets import native
    from das_tpu_torch.ops import conv_gn, cuda_build, dcn_shift, gather, \
        oks_nms
    libs = [dcn_shift.LIB, conv_gn.LIB, oks_nms.LIB, gather.LIB]
    t = time.perf_counter()
    so = native.build()
    check(native.available(), 'the host library did not load')
    host_s = time.perf_counter() - t
    secs = cuda_build.build_all(libs)
    phase('build', ', '.join(lib.source.name for lib in libs)
          + f' built (one nvcc each, in parallel) and loaded in {secs:.2f} s;'
          f' host library {os.path.relpath(so, HERE)} (g++ '
          f'{" ".join(native.GXX_FLAGS)}) built and loaded in {host_s:.2f} s')
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

    def bf16_case(a, r, want_wgmma, what):
        """Kernel vs plain within 1e-2 of max|ref|, two runs equal bit for
        bit, and the pass the call took."""
        before = dcn_shift.wgmma_launches
        got = dcn_shift.deform_conv_shift(*a, radius=r)
        again = dcn_shift.deform_conv_shift(*a, radius=r)
        want = dcn_shift.deform_conv_shift_plain(*a, radius=r).float()
        torch.cuda.synchronize()
        check(dcn_shift.wgmma_launches - before == 2 * want_wgmma,
              ('dcn_shift pass', what, r))
        check(torch.equal(got, again), ('dcn_shift bf16 repeats', what, r))
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        check(rel <= 1e-2, ('dcn_shift bf16', what, r, rel))
        return err, rel

    # the WMMA pass (channels that the wgmma pass does not take), then the
    # wgmma pass: ragged patches (H, W no multiples of 8, 16), Cin of one to
    # four slices, Cout below, at and across a column block, both radii; one
    # tap with offsets 0 and mask 1 (a plain 3x3 conv); far negative inputs,
    # where a padded zero times a weight and a skipped corner must agree
    worst = 0.0
    for (n, h, w, cin, cout, r, takes) in [
            (2, 9, 7, 8, 16, 1, 0), (2, 13, 21, 72, 136, 2, 0),
            (1, 8, 16, 64, 64, 1, 1), (2, 13, 21, 128, 192, 1, 1),
            (2, 13, 21, 128, 192, 2, 1), (3, 5, 40, 192, 320, 1, 1),
            (2, 20, 36, 256, 128, 2, 1)]:
        a = inputs(n, h, w, cin, cout, torch.bfloat16, spread=1.2 * r,
                   wscale=0.05)
        worst = max(worst, bf16_case(a, r, takes, (n, h, w, cin, cout))[1])
    x, off, mask, wt, b = inputs(2, 13, 21, 128, 192, torch.bfloat16,
                                 wscale=0.05)
    worst = max(worst, bf16_case(
        (x, torch.zeros_like(off), torch.ones_like(mask), wt, b), 1, 1,
        'offsets 0, mask 1')[1])
    worst = max(worst, bf16_case((-x.abs() - 100, off * 2, mask, wt, b), 1,
                                 1, 'far negative x')[1])
    phase('kernel', f'dcn_shift bf16 at small shapes (WMMA pass: Cin 8 and '
          f'72; wgmma pass: ragged patches, Cin 64 to 256, Cout 64 to 320, '
          f'r=1,2, offsets 0 with mask 1, far negative x): max err / '
          f'max|ref| {worst:.3g} (<= 1e-2), two runs equal bit for bit, '
          f'each call on the pass its shapes name ok')

    n, h, w = 2, 8, 6
    a = inputs(n, h, w, 3, 5, torch.float32, far=True)
    got = modulated_deform_conv(*a, gather_mode='hybrid_pallas',
                                shift_radius=1, shift_budget=h * w)
    want = modulated_deform_conv(*a, gather_mode='patch')
    err = (got - want).abs().max().item()
    check(err <= 1e-4, err)
    phase('kernel', f"hybrid_pallas (kernel + repair) vs exact 'patch', far "
          f'offsets, fp32: max abs err {err:.3g} (atol 1e-4) ok')

    def wmma_pass(a, r):
        """The source's WMMA pass, which these shapes took before the wgmma
        pass, on the same inputs (a raw call that names the pass)."""
        x, off, mask, wt, b = a
        out = torch.empty_like(x)
        fn = dcn_shift.LIB.load().dcn_shift_forward_pass
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            check(fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(),
                     wt.data_ptr(), b.data_ptr(), out.data_ptr(), *x.shape,
                     wt.shape[-1], r, 1, 1, stream) == 0, 'WMMA pass launch')
            return out
        return run

    entry, total, total_wmma = None, 0.0, 0.0
    for lvl, (h, w) in enumerate(LEVELS):
        for r in (1, 2) if lvl == 1 else (1,):
            a = inputs(4, h, w, 256, 256, torch.bfloat16, spread=0.8 * r,
                       wscale=0.05)
            err, rel = bf16_case(a, r, 1, f'level {lvl}')
            old = wmma_pass(a, r)
            want = dcn_shift.deform_conv_shift_plain(*a, radius=r).float()
            old_rel = ((old().float() - want).abs().max()
                       / want.abs().max()).item()
            check(old_rel <= 1e-2, ('dcn_shift WMMA pass', lvl, r, old_rel))
            ms = cuda_ms(lambda: dcn_shift.deform_conv_shift(*a, radius=r),
                         20)
            wmma_ms = cuda_ms(old, 20)
            plain_ms = cuda_ms(
                lambda: dcn_shift.deform_conv_shift_plain(*a, radius=r), 3)
            bound, by = dcn_bound_ms(4, h, w, 256, 256, 2, PEAK_BF16_FLOPS)
            phase('kernel', f'dcn_shift level {lvl} 4x{h}x{w}x256 bf16 '
                  f'r={r}: wgmma pass {ms:.4f} ms, WMMA pass {wmma_ms:.4f} '
                  f'ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms '
                  f'({by}); max err / max|ref| {rel:.3g} (<= 1e-2), two '
                  f'runs equal bit for bit')
            if r == 1:
                total, total_wmma = total + 4 * ms, total_wmma + 4 * wmma_ms
            if lvl == 0:
                entry = dict(
                    name='dcn_shift', route='cuda',
                    source='das_tpu_torch/csrc/dcn_shift.cu',
                    replaces='das_tpu/ops/pallas_dcn.py:111', launches=0,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None,
                    wmma_pass_ms=wmma_ms, shape=f'4x{h}x{w}x256 bf16 r=1')
    # a request runs four DCN convs per level
    phase('kernel', f'dcn_shift summed over the 16 launches of a request (4 '
          f'per level, r=1): wgmma pass {total:.4f} ms, WMMA pass '
          f'{total_wmma:.4f} ms')
    return entry


def dcn_backward_vs_plain():
    """K1's backward, ``deform_conv_shift_backward_cuda`` (the two products
    and one library call of the tap and dx kernels), against the closed form
    ``deform_conv_shift_backward_plain`` on the same inputs: small f32 and
    bf16 shapes (Cin 8, 64 and 128, r=1,2, offsets all 0, exactly +-r,
    within an ulp of those, and generic; Cin 6 and an x one element off
    16-byte alignment, which take the lane kernels' one-element-a-lane
    instantiation), then bf16 at the four levels of the B=4 640x1344 train
    step, timed beside the closed form and the bound. bf16 with Cin a
    multiple of 64 takes the tiled pass (the patch-staged tap kernel and
    the dx kernel that both passes share), the rest the lane pass; where
    the tiled pass runs, its tile is held equal to the lane pass's value
    for value and its dx to the same bits in two runs and in the lane pass,
    and the tap kernels of both passes and the dx kernel are timed side by
    side with their bytes bound. f32 within 1e-5 of max|ref|; bf16 within 2^-7 of max|ref|: both
    sides take U from one product and the tile as the forward rounds it,
    and reduce in f32 in other orders, so a bf16 output can round to the
    neighbouring value.
    Returns the dcn_shift_backward entry of the kernel table."""
    import torch
    from das_tpu_torch.ops import dcn_shift
    gen = torch.Generator().manual_seed(11)
    names = ('dx', 'doffset', 'dmask', 'dweight', 'dbias')
    fn = dcn_shift.LIB.load().dcn_shift_backward_pass

    def inputs(n, h, w, cin, cout, dt, r, case):
        x = torch.randn(n, h, w, cin, generator=gen)
        if case == 'zero':
            off = torch.zeros(n, h, w, 18)
        elif case == 'at +-r':
            off = (torch.randint(0, 2, (n, h, w, 18), generator=gen) * 2.0
                   - 1.0) * r
        elif case == 'next to the kinks':
            # within an ulp or two of 0, +-1 and +-r: i - d rounds onto a
            # kink of the hat in f32
            near = torch.tensor([1 - 2 ** -24, -(1 - 2 ** -24), 2 ** -30,
                                 -2 ** -30, 1 + 2 ** -23, -1 - 2 ** -23,
                                 r - 2 ** -22, -r + 2 ** -22, 0.5])
            off = near[torch.randint(0, 9, (n, h, w, 18), generator=gen)]
        else:
            off = (torch.rand(n, h, w, 18, generator=gen) * 2 - 1) * 1.2 * r
        mask = torch.sigmoid(torch.randn(n, h, w, 9, generator=gen))
        wt = torch.randn(3, 3, cin, cout, generator=gen) \
            * (0.2 if cin < 64 else 0.05)
        g = torch.randn(n, h, w, cout, generator=gen)
        return (x.cuda().to(dt), off.cuda(), mask.cuda().to(dt),
                wt.cuda().to(dt), g.cuda().to(dt))

    def takes_tiled(x):
        return x.dtype == torch.bfloat16 and x.shape[-1] % 64 == 0 \
            and x.data_ptr() % 16 == 0

    def held(a, r, what):
        """(max err / max|ref|, max abs err) over the five outputs."""
        before = (dcn_shift.backward_launches,
                  dcn_shift.backward_tiled_launches)
        got = dcn_shift.deform_conv_shift_backward_cuda(*a, r)
        want = dcn_shift.deform_conv_shift_backward_plain(*a, r)
        torch.cuda.synchronize()
        check((dcn_shift.backward_launches,
               dcn_shift.backward_tiled_launches) ==
              (before[0] + 1, before[1] + takes_tiled(a[0])),
              ('K1 backward launches (all, tiled)', what))
        tol = 1e-5 if a[0].dtype == torch.float32 else BF16_STEP
        worst, worst_abs = 0.0, 0.0
        for name, g, w in zip(names, got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  ('K1 backward output', what, name))
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            check(err <= tol * scale,
                  ('K1 backward vs closed form', what, name, err, scale))
            worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
        return worst, worst_abs

    def library(a, r, lanes, outputs=('tile', 'doffset', 'dmask', 'dx')):
        """(call, outputs): one library call of the kernels on the tiled
        (lanes=0) or the lane pass on x, offset, mask and U = G W^T; the
        outputs not named are not asked for."""
        x, off, mask, wt, g = a
        n, h, w, cin = x.shape
        cout = wt.shape[-1]
        P = n * h * w
        u = g.reshape(P, cout) @ wt.reshape(9 * cin, cout).t()
        out = dict(tile=torch.empty(P, 9 * cin, dtype=x.dtype,
                                    device='cuda'),
                   doffset=torch.empty(n, h, w, 18, device='cuda'),
                   dmask=torch.empty_like(mask), dx=torch.empty_like(x))
        ptr = [out[k].data_ptr() if k in outputs else None
               for k in ('tile', 'doffset', 'dmask', 'dx')]
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            check(fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(),
                     u.data_ptr(), *ptr, n, h, w, cin, r, 1, lanes, None,
                     stream) == 0, ('K1 backward library call', lanes))
        return call, out

    def against_lanes(a, r, what):
        """The tiled pass's tile equal to the lane pass's in value, its dx
        the same bits in two runs and in the lane pass, its dmask and
        doffset within 2^-7 and 1e-5 of max|lanes|."""
        runs = []
        for lanes in (0, 0, 1):
            call, out = library(a, r, lanes)
            call()
            runs.append(out)
        torch.cuda.synchronize()
        tiled, again, lanes = runs
        check(torch.equal(tiled['tile'], lanes['tile']),
              ('K1 backward tiled tile != lanes', what))
        for other, label in ((again, 'run to run'), (lanes, 'lanes')):
            check(torch.equal(tiled['dx'].view(torch.int16),
                              other['dx'].view(torch.int16)),
                  ('K1 backward tiled dx bits', label, what))
        for k, tol in (('doffset', 1e-5), ('dmask', BF16_STEP)):
            err = (tiled[k].float() - lanes[k].float()).abs().max().item()
            check(err <= tol * lanes[k].float().abs().max().item(),
                  ('K1 backward tiled vs lanes', k, what, err))

    def unaligned(t):
        """``t``'s values in a contiguous tensor one element past a
        16-byte boundary."""
        v = torch.empty(t.numel() + 1, dtype=t.dtype,
                        device=t.device)[1:].view(t.shape)
        return v.copy_(t)

    worst, tiled_worst = {}, 0.0
    for dt in (torch.float32, torch.bfloat16):
        worst[dt] = 0.0
        # Cin 6 and the unaligned x take the lanes' one element a lane;
        # bf16 at Cin 64 and 128 the tiled pass
        for shape in [(2, 9, 7, 8, 16), (2, 13, 21, 128, 192),
                      (2, 9, 7, 6, 16), (2, 13, 21, 64, 64)]:
            for r in (1, 2):
                for case in ('zero', 'at +-r', 'next to the kinks',
                             'generic'):
                    a = inputs(*shape, dt, r, case)
                    rel = held(a, r, (shape, dt, r, case))[0]
                    worst[dt] = max(worst[dt], rel)
                    if takes_tiled(a[0]):
                        tiled_worst = max(tiled_worst, rel)
                        against_lanes(a, r, (shape, r, case))
        for r in (1, 2):
            x, *rest = inputs(2, 9, 7, 8, 16, dt, r, 'generic')
            x = unaligned(x)
            check(x.data_ptr() % 16 != 0, 'an unaligned x')
            worst[dt] = max(worst[dt], held((x, *rest), r,
                                            ('unaligned x', dt, r))[0])
    phase('kernel', f'dcn_shift backward at small shapes (Cin 8, 128, 6 '
          f'and 64, Cout 16, 192 and 64, r=1,2, offsets all 0, exactly +-r,'
          f' within an ulp of those and generic; an x off 16-byte '
          f'alignment): dx, doffset, dmask, dweight and dbias against the '
          f'closed form, max err / max|ref| {worst[torch.float32]:.3g} f32 '
          f'(<= 1e-5), {worst[torch.bfloat16]:.3g} bf16 (<= 2^-7, one '
          f'rounding step of a bf16 output), of which the tiled pass (bf16,'
          f' Cin 64 and 128) {tiled_worst:.3g}; the tiled tile == the lane '
          f'pass\'s, its dx the same bits in two runs and in the lane pass '
          f'ok')

    entry, total, total_plain = None, 0.0, 0.0
    total_kernels, total_lanes = 0.0, 0.0
    for lvl, (h, w) in enumerate(TRAIN_LEVELS):
        a = inputs(4, h, w, 256, 256, torch.bfloat16, 1, 'generic')
        rel, err = held(a, 1, f'level {lvl}')
        against_lanes(a, 1, f'level {lvl}')
        x, off, mask, wt, g = a
        P = 4 * h * w
        g2 = g.reshape(P, 256)
        w2 = wt.reshape(9 * 256, 256)
        tile = torch.empty(P, 9 * 256, dtype=torch.bfloat16, device='cuda')
        iters = 5 if lvl == 0 else 20
        ms = cuda_ms(lambda: dcn_shift.deform_conv_shift_backward_cuda(
            *a, 1), iters)
        # each pass's kernels together and its tap kernel alone, in turns:
        # tiled, lanes, lanes, tiled; the dx kernel, which both passes
        # share, alone on the lane turns
        kms = {}
        for lanes in (0, 1, 1, 0):
            for part, outs in (('both', ('tile', 'doffset', 'dmask', 'dx')),
                               ('tap', ('tile', 'doffset', 'dmask')),
                               ('dx', ('dx',)))[:2 + lanes]:
                call, _ = library(a, 1, lanes, outs)
                kms.setdefault((lanes, part), []).append(cuda_ms(call,
                                                                 iters))
                del call, _
        km = {k: min(v) for k, v in kms.items()}
        u_ms = cuda_ms(lambda: g2 @ w2.t(), iters)
        dw_ms = cuda_ms(lambda: tile.t() @ g2, iters)
        plain_ms = cuda_ms(lambda: dcn_shift.deform_conv_shift_backward_plain(
            *a, 1), 2)
        bound, by = dcn_backward_bound_ms(4, h, w, 256, 256, 2,
                                          PEAK_BF16_FLOPS)
        # the kernels' own compulsory bytes: U read and the tile written
        # (P x 9 x 256), x read and dx written, the offsets, mask and their
        # gradients; the tap kernel's alone (U, x, offsets and mask read;
        # the tile, doffset and dmask written) and the dx kernel's (U,
        # offsets and mask read, dx written)
        kbound, kby = bound_ms(0.0, PEAK_F32_FLOPS,
                               2 * (2 * P * 9 * 256 + 2 * P * 256 + 2 * P * 9)
                               + 2 * 4 * P * 18)
        tap_bound = bound_ms(0.0, PEAK_F32_FLOPS,
                             2 * (2 * P * 9 * 256 + P * 256 + 2 * P * 9)
                             + 2 * 4 * P * 18)[0]
        dx_bound = bound_ms(0.0, PEAK_F32_FLOPS,
                            2 * (P * 9 * 256 + P * 256 + P * 9)
                            + 4 * P * 18)[0]
        del tile
        phase('kernel', f'dcn_shift backward level {lvl} 4x{h}x{w}x256 '
              f'bf16 r=1: {ms:.4f} ms (U = G W^T {u_ms:.4f} ms, the tiled '
              f'tap kernel and the dx kernel {km[0, "both"]:.4f} ms (tap '
              f'{km[0, "tap"]:.4f}, dx {km[1, "dx"]:.4f}) against the lane '
              f'pair\'s {km[1, "both"]:.4f} (tap {km[1, "tap"]:.4f}) and '
              f'their bytes bound {kbound:.4f} ms '
              f'({kby}; tap {tap_bound:.4f}, dx {dx_bound:.4f}), dW = A^T G '
              f'{dw_ms:.4f} ms), closed form {plain_ms:.4f} ms, bound '
              f'{bound:.4f} ms ({by}); max err / max|ref| {rel:.3g} (<= '
              f'2^-7); tiled tile == lanes\', dx the same bits (two runs, '
              f'lanes); the least of two turns each, tiled, lanes, lanes, '
              f'tiled: ' + ', '.join(
                  f'{"lanes" if k[0] else "tiled"} {k[1]} '
                  + '/'.join(f'{t:.4f}' for t in v) for k, v in kms.items()))
        total += 4 * ms
        total_plain += 4 * plain_ms
        total_kernels += 4 * km[0, 'both']
        total_lanes += 4 * km[1, 'both']
        if lvl == 0:
            entry = dict(
                name='dcn_shift_backward', route='cuda',
                source='das_tpu_torch/csrc/dcn_shift.cu',
                replaces='das_tpu/ops/pallas_dcn.py:111 (its gradient, '
                         'which JAX takes by autodiff of '
                         'das_tpu/ops/deform_conv.py:111)',
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                kernels_ms=km[0, 'both'], tap_ms=km[0, 'tap'],
                dx_ms=km[1, 'dx'], lanes_kernels_ms=km[1, 'both'],
                lanes_tap_ms=km[1, 'tap'],
                kernels_bound_ms=kbound, tap_bound_ms=tap_bound,
                dx_bound_ms=dx_bound, products_ms=u_ms + dw_ms,
                shape=f'4x{h}x{w}x256 bf16 r=1')
        torch.cuda.empty_cache()
    # a reckoning from one call a level, not a step's measurement: the
    # train phase times the 16 calls inside a real step
    phase('kernel', f'dcn_shift backward, 4 x each level\'s one timed call '
          f'summed over the levels (a train step makes 4 a level, r=1): '
          f'{total:.4f} ms, of which the tiled tap kernel and the dx kernel '
          f'{total_kernels:.4f} ms (the lane pair {total_lanes:.4f}); '
          f'closed form {total_plain:.4f} ms')
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

    # bf16 at small shapes: the wgmma pass with ragged patches (H, W no
    # multiples of 8, 16), Cin below and across a 64-channel slice, Cout
    # below a column block, and the element-wise tiles (Cin, Cout no
    # multiples of 8); one bf16 step of max|ref|
    worst = 0.0
    for (h, w, cin, cout, g) in [(8, 16, 8, 8, 4), (10, 18, 32, 64, 8),
                                 (20, 36, 64, 64, 32), (13, 21, 72, 136, 17),
                                 (7, 40, 128, 256, 32), (9, 7, 3, 6, 3),
                                 (5, 11, 12, 130, 13)]:
        a = inputs(2, h, w, cin, cout, torch.bfloat16)
        got = conv_gn.conv_gn_relu(*a, groups=g)
        again = conv_gn.conv_gn_relu(*a, groups=g)
        want = conv_gn.conv_gn_relu_plain(*a, groups=g).float()
        torch.cuda.synchronize()
        check(torch.equal(got, again), ('conv_gn bf16 repeats', h, w, cin,
                                        cout))
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= 1e-2, ('conv_gn bf16', h, w, cin, cout, g, rel))
    phase('kernel', f'conv_gn bf16 at small shapes (ragged patches, Cin 8 to '
          f'128, Cout 8 to 256; element-wise tiles for Cin 3 and 12): max '
          f'err / max|ref| {worst:.3g} (<= 1e-2), two runs equal bit for '
          f'bit ok')

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
            got = conv_gn.conv_gn_relu(*a, groups=32)
            check(torch.equal(got, conv_gn.conv_gn_relu(*a, groups=32)),
                  ('conv_gn bf16 repeats', lvl, cout))
            got = got.float()
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
                  f'(<= 1e-2), two runs equal; unfused vs plain max abs '
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
    # the shapes of tests/test_pallas_nms.py (both below one 64-row block),
    # M no multiple of 64, one block exactly, then one request's M
    for B, M, J in [(1, 48, 15), (1, 16, 4), (2, 777, 17), (3, 64, 15),
                    (4, 3720, 15)]:
        a = nms_inputs(B, M, J)
        sig = oks_nms.default_sigmas(J)
        got = oks_nms.oks_nms_keep(*a, 0.9, sig)
        want = oks_nms.oks_nms_keep_plain(*a, 0.9, sig)
        check(torch.equal(got, want), ('oks_nms keep mask', B, M, J))
        check(0 < int(got.sum()) < B * M, ('oks_nms kept', B, M, J))
        for k in (0, 1, 7, 100, M):
            got = oks_nms.oks_nms_keep(*a, 0.9, sig, max_keep=k)
            check(torch.equal(got, want & (want.cumsum(-1) <= k)),
                  ('oks_nms keep mask with max_keep', B, M, J, k))
    phase('kernel', 'oks_nms keep mask == plain, bit for bit, without and '
          'with max_keep (0, 1, 7, 100, M), at the test_pallas_nms shapes '
          '(M=48 J=15, M=16 J=4), at M=777 J=17, M=64 and at B=4 M=3720 '
          'J=15, near-duplicate candidates ok')


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


# (N, R, C, P, index type, what): the probe's shape
# (tools/analysis_tools/pallas_gather_probe.py:26-28); the RU's gathers at
# the sparse serving levels 0 and 1 of a B=4 640x1152 request (60 = B x J
# tables of H*W rows: take_at of uvd C=3 and of the sampling offsets C=8 at
# K=1000 points, the offsets' bilinear corners C=8 at 1000, the [uvd, conf]
# corners C=6 at 8000) and of a B=4 640x1344 train step (K = max_pos = 512
# positives, so 512 and 512 x 8 candidates = 4096); the hybrid repair's
# corners at budget 2048 on 256-channel maps; and indices past both ends,
# which must clamp
GATHER_SHAPES = [
    (1, 11520, 128, 11520, 'int32', 'probe'),
    (60, 46080, 3, 1000, 'int64', 'RU level 0 take_at uvd'),
    (60, 46080, 8, 1000, 'int64', 'RU level 0 take_at / corners, offsets'),
    (60, 46080, 6, 8000, 'int64', 'RU level 0 corners, [uvd, conf]'),
    (60, 11520, 3, 1000, 'int64', 'RU level 1 take_at uvd'),
    (60, 11520, 8, 1000, 'int64', 'RU level 1 take_at / corners, offsets'),
    (60, 11520, 6, 8000, 'int64', 'RU level 1 corners, [uvd, conf]'),
    (60, 53760, 3, 512, 'int64', 'train RU level 0 take_at uvd'),
    (60, 53760, 8, 512, 'int64', 'train RU level 0 take_at / corners, '
     'offsets'),
    (60, 53760, 6, 4096, 'int64', 'train RU level 0 corners, [uvd, conf]'),
    (60, 53760, 8, 4 * 512, 'int64', 'train RU level 0, all four corners, '
     'offsets'),
    (60, 53760, 6, 4 * 4096, 'int64', 'train RU level 0, all four corners, '
     '[uvd, conf]'),
    (60, 13440, 3, 512, 'int64', 'train RU level 1 take_at uvd'),
    (60, 13440, 8, 512, 'int64', 'train RU level 1 take_at / corners, '
     'offsets'),
    (60, 13440, 6, 4096, 'int64', 'train RU level 1 corners, [uvd, conf]'),
    (4, 46080, 256, 2048, 'int64', 'hybrid repair corners, level 0'),
    (4, 11520, 256, 2048, 'int64', 'hybrid repair corners, level 1'),
    (2, 1000, 8, 3000, 'int32', 'clamp, int32'),
    (2, 1000, 6, 3000, 'int64', 'clamp, int64'),
]


def gather_vs_plain():
    """K4 forward bit for bit against its plain version, its backward
    against the plain scatter-add, and both timed, at GATHER_SHAPES.
    Returns the table entries of the forward and the backward kernel (at
    the probe's shape, bf16)."""
    import torch
    from das_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(13)
    entries = {}
    for N, R, C, P, itype, what in GATHER_SHAPES:
        lo, hi = (-R // 2, R + R // 2) if what.startswith('clamp') else (0, R)
        idx = torch.randint(lo, hi, (N, P), generator=gen) \
            .to(getattr(torch, itype)).cuda()
        base = torch.randn(N, R, C, generator=gen).cuda()
        ct = torch.randn(N, P, C, generator=gen).cuda()
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            table = base.to(dt)
            got = gather.gather_rows(table, idx)
            want = gather.gather_rows_plain(table, idx)
            check(torch.equal(got, want), ('gather_rows', what, dt))
            fwd_err = (got.float() - want.float()).abs().max().item()
            g = ct.to(dt)
            gb = gather.scatter_rows_cuda(g, idx, R, dt).float()
            wb = gather.scatter_rows_plain(g, idx, R, dt).float()
            scale = wb.abs().max().item()
            berr = (gb - wb).abs().max().item()
            tol = 1e-5 if dt == torch.float32 else BF16_STEP
            check(berr <= tol * scale, ('gather_rows backward', what, dt,
                                         berr, scale))
            errs.append((berr / scale, berr))
        # the model's type at serving and in training: bf16
        table, g = base.to(torch.bfloat16), ct.to(torch.bfloat16)
        nidx = torch.arange(N, device='cuda')[:, None]
        clamped = idx.long().clamp(0, R - 1)
        flat = (clamped + nidx * R).reshape(-1)
        acc = torch.zeros(N * R, C, device='cuda')
        g2 = g.reshape(-1, C).float()
        ms = cuda_ms(lambda: gather.gather_rows(table, idx), 50)
        plain_ms = cuda_ms(lambda: gather.gather_rows_plain(table, idx), 20)
        lib_ms = cuda_ms(lambda: table[nidx, clamped], 50)
        bms = cuda_ms(lambda: gather.scatter_rows_cuda(
            g, idx, R, torch.bfloat16), 50)
        bplain_ms = cuda_ms(lambda: gather.scatter_rows_plain(
            g, idx, R, torch.bfloat16), 20)
        blib_ms = cuda_ms(lambda: acc.index_add_(0, flat, g2), 50)
        zero_ms = cuda_ms(lambda: torch.zeros(N, R, C, device='cuda'), 50)
        cast_ms = cuda_ms(lambda: acc.to(torch.bfloat16), 50)
        ib = idx.element_size()
        bound, by = gather_bound_ms(N, R, P, C, 2, ib)
        bbound, bby = gather_bound_ms(N, R, P, C, 2, ib, backward=True)
        phase('kernel', f'gather_rows {what} ({N}x{R}x{C}, P={P}, {itype}):'
              f' forward == plain bit for bit in f32 and bf16; backward '
              f'max err / max|ref| {errs[0][0]:.3g} f32 (<= 1e-5), {errs[1][0]:.3g}'
              f' bf16 (<= 2^-7); bf16 forward kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, indexing {lib_ms:.4f} ms, bound '
              f'{bound:.4f} ms ({by}); backward kernel {bms:.4f} ms, plain '
              f'{bplain_ms:.4f} ms, index_add_ {blib_ms:.4f} ms (the '
              f"table's f32 zero-fill {zero_ms:.4f} ms, its cast "
              f'{cast_ms:.4f} ms), bound {bbound:.4f} ms ({bby})')
        if what == 'probe':
            src = 'das_tpu_torch/csrc/gather_rows.cu'
            rep = 'tools/analysis_tools/pallas_gather_probe.py:36'
            shape = f'{N}x{R}x{C} bf16, P={P} {itype}'
            entries['fwd'] = dict(
                name='gather_rows', route='cuda', source=src, replaces=rep,
                launches=0, max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms, shape=shape)
            entries['bwd'] = dict(
                name='gather_rows_backward', route='cuda', source=src,
                replaces=rep + ' (its adjoint: XLA scatter-add)', launches=0,
                max_abs_err=errs[1][1], ms=bms, plain_ms=bplain_ms,
                bound_ms=bbound, bound_by=bby, library_ms=blib_ms,
                shape=shape)
    return entries['fwd'], entries['bwd']


# (N, [(R, C, P)], what): the segments of one grouped launch. The RU's
# take_at of a served request and of a train step at levels 0 and 1 (uvd
# C=3 and the sampling offsets C=8 at the same points); four segments of
# different R, C and P of which two name one table (their gradients add
# into one buffer); and indices past both ends, which must clamp
GROUPED_SHAPES = [
    (60, [(46080, 3, 1000), (46080, 8, 1000)], 'RU level 0 take_at'),
    (60, [(11520, 3, 1000), (11520, 8, 1000)], 'RU level 1 take_at'),
    (60, [(53760, 3, 512), (53760, 8, 512)], 'train RU level 0 take_at'),
    (60, [(13440, 3, 512), (13440, 8, 512)], 'train RU level 1 take_at'),
    (4, [(11520, 256, 2048), (2880, 6, 300), (11520, 256, 700),
         (720, 7, 5000)], 'four segments, the first and third one table'),
    (2, [(1000, 8, 3000), (1000, 6, 3000)], 'clamp'),
]


def grouped_gather_vs_plain():
    """The grouped row gather bit for bit against its plain version and its
    adjoint against the plain one (the tolerances of gather_vs_plain), in
    f32 and bf16, and both timed in bf16 against one launch per segment."""
    import torch
    from das_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(17)
    for N, segs, what in GROUPED_SHAPES:
        shared = what.startswith('four')
        for dt in (torch.float32, torch.bfloat16):
            tables, idxs, cts, which = [], [], [], []
            for s, (R, C, P) in enumerate(segs):
                lo, hi = (-R // 2, R + R // 2) if what == 'clamp' else (0, R)
                if shared and s == 2:
                    tables.append(tables[0])
                    which.append(0)
                else:
                    which.append(len(set(which)))
                    tables.append(torch.randn(N, R, C, generator=gen).cuda()
                                  .to(dt))
                idxs.append(torch.randint(lo, hi, (N, P), generator=gen)
                            .to(torch.int32 if s % 2 and shared
                                else torch.int64).cuda())
                cts.append(torch.randn(N, P, C, generator=gen).cuda().to(dt))
            before = gather.launches, gather.backward_launches
            got = gather.gather_grouped_cuda(tables, idxs)
            want = gather.gather_grouped_plain(tables, idxs)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  ('grouped gather', what, dt))
            uniq = sorted(set(which))
            rows = [segs[which.index(u)][0] for u in uniq]
            gb = gather.scatter_grouped_cuda(cts, idxs, which, rows,
                                             [dt] * len(uniq))
            wb = gather.scatter_grouped_plain(cts, idxs, which, rows,
                                              [dt] * len(uniq))
            torch.cuda.synchronize()
            check((gather.launches, gather.backward_launches) ==
                  (before[0] + 1, before[1] + 1),
                  ('grouped gather: one launch each way', what))
            tol = 1e-5 if dt == torch.float32 else BF16_STEP
            rel = 0.0
            for g, w in zip(gb, wb):
                scale = w.float().abs().max().item()
                err = (g.float() - w.float()).abs().max().item()
                check(err <= tol * scale, ('grouped gather backward', what,
                                           dt, err, scale))
                rel = max(rel, err / scale)
        ms = cuda_ms(lambda: gather.gather_grouped_cuda(tables, idxs), 50)
        each = cuda_ms(lambda: [gather.gather_rows_cuda(t, i)
                                for t, i in zip(tables, idxs)], 50)
        plain_ms = cuda_ms(lambda: gather.gather_grouped_plain(tables, idxs),
                           20)
        bms = cuda_ms(lambda: gather.scatter_grouped_cuda(
            cts, idxs, which, rows, [dt] * len(uniq)), 50)
        bplain_ms = cuda_ms(lambda: gather.scatter_grouped_plain(
            cts, idxs, which, rows, [dt] * len(uniq)), 20)
        bound = sum(gather_bound_ms(N, R, P, C, 2, i.element_size())[0]
                    for (R, C, P), i in zip(segs, idxs))
        phase('kernel', f'gather_rows_grouped {what} (N={N}, (R, C, P) = '
              f'{segs}): forward == plain bit for bit in f32 and bf16, '
              f'backward max err / max|ref| {rel:.3g} bf16 (<= 2^-7; f32 <= '
              f'1e-5); bf16 forward one launch {ms:.4f} ms, one launch per '
              f'segment {each:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{bound:.4f} ms (bytes); backward one launch {bms:.4f} ms, '
              f'plain {bplain_ms:.4f} ms')


# (N, H, W, C, P, what): the samples of a B=4 640x1152 request: the RU's
# sparse levels 0 and 1 (the sampling offsets C=8 at the K=1000 selected
# points, [uvd, conf] C=6 at 1000 x 8 candidates) and its dense level 3
# (20x36: 720 points, then 720 x 8), the uvd field alone (C=3), and the
# hybrid repair's nine taps of 2048 pixels on the 256-channel maps
SAMPLER_SHAPES = [
    (60, 160, 288, 8, 1000, 'RU level 0, offsets'),
    (60, 160, 288, 6, 8000, 'RU level 0, [uvd, conf]'),
    (60, 80, 144, 8, 1000, 'RU level 1, offsets'),
    (60, 80, 144, 6, 8000, 'RU level 1, [uvd, conf]'),
    (60, 20, 36, 8, 720, 'RU level 3 (dense), offsets'),
    (60, 20, 36, 6, 5760, 'RU level 3 (dense), [uvd, conf]'),
    (60, 80, 144, 3, 1000, 'uvd field'),
    (4, 160, 288, 256, 9 * 2048, 'hybrid repair, level 0'),
    (4, 80, 144, 256, 9 * 2048, 'hybrid repair, level 1'),
]


def sampler_bound_ms(N, R, P, C, elt):
    """Least time for one fused bilinear sample: four rows read per point,
    or the whole table once where that is less (points share corners), two
    f32 coordinates read and one row written per point; 11 f32 operations
    per channel (4 products, 3 sums and their share of the weights)."""
    return bound_ms(11.0 * N * P * C, PEAK_F32_FLOPS,
                    (min(4 * P, R) + P) * N * C * elt + 8 * N * P)


def sampler_vs_plain():
    """The fused sampler bit for bit against the plain composition (torch
    elementwise weights around the plain row gather) in f32 and bf16, with
    points outside the image and on its border, and timed in bf16 against
    its bound and F.grid_sample. Returns its entry of the kernel table (at
    the level-0 repair shape)."""
    import torch
    import torch.nn.functional as F
    from das_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(19)
    entry = None
    for N, H, W, C, P, what in SAMPLER_SHAPES:
        x = torch.rand(N, P, generator=gen) * (W + 3) - 2
        y = torch.rand(N, P, generator=gen) * (H + 3) - 2
        # whole coordinates on and just past every border
        edge = torch.tensor([-1.0, 0.0, W - 1.0, float(W), -0.5, W - 0.5])
        x[:, :36] = edge.repeat_interleave(6)
        y[:, :36] = torch.tensor([-1.0, 0.0, H - 1.0, float(H), -0.5,
                                  H - 0.5]).repeat(6)
        x, y = x.cuda(), y.cuda()
        base = torch.randn(N, H * W, C, generator=gen).cuda()
        err = 0.0
        for dt in (torch.float32, torch.bfloat16):
            flat = base.to(dt)
            before = gather.sampler_launches
            got = gather.sample_rows_bilinear(flat, x, y, H, W)
            check(gather.sampler_launches == before + 1,
                  ('sampler: one launch', what))
            want = gather.sample_rows_bilinear_plain(
                flat, x, y, H, W, gather=gather.gather_rows_plain)
            torch.cuda.synchronize()
            check(torch.equal(got, want), ('sample_rows_bilinear', what, dt,
                                           (got.float() - want.float())
                                           .abs().max().item()))
            err = (got.float() - want.float()).abs().max().item()
        grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1],
                           dim=-1)[:, None].to(dt)
        nchw = flat.reshape(N, H, W, C).permute(0, 3, 1, 2)
        lib = F.grid_sample(nchw, grid, mode='bilinear',
                            padding_mode='zeros', align_corners=True)
        lib_err = (lib[:, :, 0].permute(0, 2, 1).float() - want.float()) \
            .abs().max().item()
        ms = cuda_ms(lambda: gather.sample_rows_bilinear(flat, x, y, H, W),
                     50)
        plain_ms = cuda_ms(lambda: gather.sample_rows_bilinear_plain(
            flat, x, y, H, W, gather=gather.gather_rows_plain), 10)
        gathered_ms = cuda_ms(lambda: gather.sample_rows_bilinear_plain(
            flat, x, y, H, W), 10)
        lib_ms = cuda_ms(lambda: F.grid_sample(
            nchw, grid, mode='bilinear', padding_mode='zeros',
            align_corners=True), 50)
        bound, by = sampler_bound_ms(N, H * W, P, C, 2)
        phase('kernel', f'sample_rows_bilinear {what} ({N}x{H}x{W}x{C}, '
              f'P={P}): == plain composition bit for bit in f32 and bf16; '
              f'bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch '
              f'weights around the K4 gather {gathered_ms:.4f} ms, '
              f'F.grid_sample {lib_ms:.4f} ms (its grid is bf16 as its '
              f'input, so coordinates keep 8 bits: max abs diff from plain '
              f'{lib_err:.3g}), bound {bound:.4f} ms ({by})')
        if what == 'hybrid repair, level 0':
            entry = dict(
                name='sample_rows_bilinear', route='cuda',
                source='das_tpu_torch/csrc/gather_rows.cu',
                replaces='tools/analysis_tools/pallas_gather_probe.py:36 '
                '(the four row gathers of das_tpu/ops/interp.py:68-79 and '
                'the weights around them)', launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, shape=f'{N}x{H}x{W}x{C} bf16, P={P}')
    return entry


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
    """K3 on the NMS candidates of one served request, and its place in the
    decode: the keep mask against the plain version, ``oks_nms_sorted``
    against ``oks_nms_fixed``, and ``decode_batch``'s own output against the
    one built from ``oks_nms_fixed``'s indices. Returns the oks_nms entry
    of the kernel table."""
    import torch
    from das_tpu_torch.core.decode import decode_batch
    from das_tpu_torch.ops import oks_nms
    from das_tpu_torch.tools.profile_kernels import (pose_template,
                                                     served_candidates)
    head = cfg.model.bbox_head
    test_cfg = dict(cfg.model.test_cfg)
    J = int(head.num_joints)
    pose_template(model)
    r = served_candidates(model, cfg, img, sf)
    kpts, areas, valid, c = r['kpts'], r['areas'], r['valid'], r['cand']
    thr, sig, post = r['thr'], r['sigmas'], r['nms_post']
    with torch.inference_mode():
        B, M = c['nms_scores'].shape
        check(bool(c['valid'].any()), 'no valid candidate')
        torch.cuda.synchronize()
        before = oks_nms.launches
        keep = oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig)
        capped = oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig,
                                      max_keep=post)
        torch.cuda.synchronize()
        check(oks_nms.launches == before + 2, 'oks_nms_keep launches')
        plain = oks_nms.oks_nms_keep_plain(kpts, areas, valid, thr, sig)
        check(torch.equal(keep, plain), 'served keep mask != plain')
        check(torch.equal(capped, plain & (plain.cumsum(-1) <= post)),
              'served keep mask with max_keep != plain')
        kept = keep.sum(1).tolist()
        check(all(post < k < M for k in kept), ('kept per image', kept, M))
        args = (c['xy'], c['nms_scores'], c['areas'], c['valid'], thr, sig)
        before = oks_nms.launches
        mine, mine_ok = oks_nms.oks_nms_sorted(*args, max_dets=post)
        check(oks_nms.launches == before + 1, 'oks_nms_sorted launches')
        fixed, fixed_ok = oks_nms.oks_nms_fixed(*args, max_dets=post)
        scores = c['nms_scores'].cpu()
        for b in range(B):
            check(same_up_to_ties(mine[b][mine_ok[b]].cpu(),
                                  fixed[b][fixed_ok[b]].cpu(), scores[b],
                                  post), ('oks_nms_sorted != oks_nms_fixed',
                                          b))
        # the decode's own output on this request against the one that
        # oks_nms_fixed's indices give: the same scores in the same order,
        # and each pose that of a candidate of that score
        before = oks_nms.launches
        out = decode_batch(*r['heads'], tuple(head.strides), sf, J, test_cfg)
        check(oks_nms.launches == before + 1, 'decode_batch K3 launches')
        nidx = torch.arange(B, device=fixed.device)[:, None]
        check(torch.equal(out['valid'], fixed_ok), 'decode valid')
        check(torch.equal(out['scores'], torch.where(
            fixed_ok, c['nms_scores'][nidx, fixed], 0.0)), 'decode scores')
        same = (out['poses'] == c['poses'][nidx, fixed]).flatten(2).all(-1)
        check(torch.equal(out['poses'], c['poses'][nidx, mine]),
              'decode poses != those of oks_nms_sorted\'s indices')
        for b, i in (~same).nonzero().tolist():
            check(float(c['nms_scores'][b, mine[b, i]]) ==
                  float(c['nms_scores'][b, fixed[b, i]]),
                  ('decode pose differs beyond an equal-score swap', b, i))
        terms = nms_joint_terms(kpts, areas, thr, sig)
        ms = cuda_ms(lambda: oks_nms.oks_nms_keep(kpts, areas, valid, thr,
                                                  sig), 20)
        capped_ms = cuda_ms(lambda: oks_nms.oks_nms_keep(
            kpts, areas, valid, thr, sig, max_keep=post), 20)
        sorted_ms = cuda_ms(lambda: oks_nms.oks_nms_sorted(
            *args, max_dets=post), 20)
        plain_ms = cuda_ms(lambda: oks_nms.oks_nms_keep_plain(
            kpts, areas, valid, thr, sig), 1)
        fixed_ms = cuda_ms(lambda: oks_nms.oks_nms_fixed(
            *args, max_dets=post), 3)
    bound, by = nms_bound_ms(B, M, J, terms)
    full_bound, _ = nms_bound_ms(B, M, J)
    pairs = B * M * (M - 1) // 2
    phase('nms', f'served fused-GN request, B={B} M={M} J={J}: '
          f'{int(valid.sum())} valid, kept per image {kept}; keep mask == '
          f'plain, also with max_keep={post}; oks_nms_sorted == '
          f'oks_nms_fixed and decode_batch == the decode built from '
          f'oks_nms_fixed (up to equal-score swaps: {int((~same).sum())} '
          f'poses swapped); kernel {ms:.4f} ms, with max_keep={post} '
          f'{capped_ms:.4f} ms, oks_nms_sorted (sort, kernel, topk) '
          f'{sorted_ms:.4f} ms, plain {plain_ms:.4f} ms, oks_nms_fixed '
          f'{fixed_ms:.4f} ms; bound {bound:.4f} ms ({by}; {terms} joint '
          f'terms of {pairs} pairs; {full_bound:.4f} ms were every pair '
          f'summed over all {J} joints)')
    return dict(name='oks_nms', route='cuda',
                source='das_tpu_torch/csrc/oks_nms.cu',
                replaces='das_tpu/ops/pallas_nms.py:88', launches=0,
                max_abs_err=float((keep != plain).sum().item()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, max_keep_ms=capped_ms,
                oks_nms_sorted_ms=sorted_ms, oks_nms_fixed_ms=fixed_ms,
                all_joints_bound_ms=full_bound,
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


def count_label(key):
    return f'{key[0].__name__.rsplit(".", 1)[-1]}.{key[1]}'


def main_path(cfg_path, requests, expect, hw=(640, 1152)):
    """Serve ``requests`` B=4 ``hw`` bf16 requests of ``cfg_path``. Every
    count of ``expect`` ({(kernel module, name of its count): launches per
    request}) is set to 0 just before the requests and read just after;
    each request must launch exactly its share, or a number within (lo, hi)
    where the share is such a pair (the fused sampler, whose count follows
    the DCN calls that repair). K4's launches together (row gathers and
    fused samples) must stay within K4_PER_REQUEST. A hybrid DCN config
    must flag pixels beyond radius 1 (the repair runs). Returns (model, cfg,
    {module.count: launches}, last image, scale factors)."""
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
    mode = head.get('dcn_gather_mode', 'patch')
    phase('main', f"{name} (dcn_gather_mode={mode!r}, "
          f"r={head.get('dcn_shift_radius', 2)}, "
          f"conv_bias={head.conv_bias!r}, J={head.num_joints}, "
          f"stages={cfg.model.backbone.num_stages}, RU layers="
          f"{head.recursive_update.get('num_layers', 1)}, "
          f"nms_thr={cfg.model.test_cfg.nms_thr}, "
          f"fused_gn={head.get('fused_gn', False)}, "
          f"sparse_refine={cfg.model.test_cfg.sparse_refine}) built in bf16 "
          f'on the card in {time.perf_counter() - t0:.1f} s, '
          f'{sum(p.numel() for p in model.parameters())} parameters')

    rng = np.random.RandomState(0)
    H, W = hw
    imgs = [torch.from_numpy(rng.randn(4, H, W, 3).astype(np.float32))
            .cuda() for _ in range(requests + 1)]
    sf = torch.ones(4, 2, device='cuda')
    if mode.startswith('hybrid'):
        flagged = flagged_per_layer(model, imgs[0].to(torch.float32))
        total = sum(c for _, c in flagged)
        phase('main', 'pixels beyond radius 1 per DCN layer (request 0, '
              'B=4, all levels): ' + ', '.join(
                  f'{n.replace("bbox_head.", "")}={c}' for n, c in flagged))
        check(total > 0, 'no offset left radius 1: the repair never ran')
    predict(imgs[0], sf)                     # warm-up request
    torch.cuda.synchronize()

    for mod, attr in expect:
        setattr(mod, attr, 0)
    times = []
    for i in range(1, requests + 1):
        before = {key: getattr(*key) for key in expect}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict(imgs[i], sf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        got = {key: getattr(*key) - before[key] for key in expect}
        for k, v in out.items():
            if v.is_floating_point():
                check(torch.isfinite(v).all(), k)
        check(out['poses'].shape == (4, 100, head.num_joints, 3),
              tuple(out['poses'].shape))
        counts = ', '.join(f'{n} {count_label(key)}'
                           for key, n in got.items())
        k4 = sum(n for key, n in got.items() if 'gather' in count_label(key))
        phase('main', f'{name} request {i}: B=4 {H}x{W} in '
              f'{times[-1]:.2f} ms, {int(out["valid"].sum())} valid poses, '
              f'launches: {counts}')
        check(all(n[0] <= got[key] <= n[1] if isinstance(n, tuple)
                  else got[key] == n for key, n in expect.items())
              and k4 <= K4_PER_REQUEST,
              (name, 'launches per request', counts))
    totals = {count_label(key): getattr(*key) for key in expect}
    phase('main', f'{name}: {requests} requests ok, mean '
          f'{np.mean(times):.2f} ms, median {np.median(times):.2f} ms, '
          f'launches {totals}, outputs finite')
    return model, cfg, totals, imgs[-1], sf


def kernel_path_vs_plain_path(cfg_path, expect):
    """Same fp32 weights on the card (kernel) and on the CPU (plain); the
    card's forward launches ``expect`` = (dcn_shift, conv_gn) kernels and
    some of K4's (row gathers and fused samples)."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    from das_tpu_torch.ops import conv_gn, dcn_shift, gather
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
        before = (dcn_shift.launches, conv_gn.launches,
                  gather.launches + gather.sampler_launches)
        outs_g = gpu(img.cuda(), [None if s is None else s.cuda()
                                  for s in sel])
        ran = (dcn_shift.launches - before[0], conv_gn.launches - before[1])
        gathers = gather.launches + gather.sampler_launches - before[2]
    check(ran == expect and gathers > 0,
          (cfg_name, 'fp32 launches (dcn_shift, conv_gn, K4)', ran,
           gathers))
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
          f'{ran[0]} dcn_shift, {ran[1]} conv_gn, {gathers} K4 (row gather '
          f'and fused sampler) launches) vs plain path '
          f'(CPU): head outputs max err / max|ref| {worst:.3g} (<= 1e-3); '
          f'decode: {nv} valid on both, scores within 1e-4, poses max err '
          f'/ max|pose| {pose_err:.3g} (<= 1e-3) ok')


def loss_grads(model, cfg, batch, featmaps, max_pos):
    """The train step's gradient pass without its update, on the model's
    device: ``batch`` (the TrainLoader's numpy arrays) normalised as
    ``make_train_step`` normalises it, its targets, ``model.loss`` and the
    backward of the sum of the loss terms. Returns ({term: value},
    {parameter name: gradient})."""
    import torch
    from das_tpu_torch.core.targets import get_targets
    dev = next(model.parameters()).device
    head = cfg.model.bbox_head
    gt = [torch.from_numpy(batch[k]).to(dev) for k in (
        'gt_poses_3d', 'gt_centers2d', 'gt_depths', 'gt_valid')]
    targets = get_targets(featmaps, tuple(head.strides),
                          tuple(tuple(r) for r in head.regress_ranges), *gt,
                          int(head.num_joints),
                          float(head.get('center_sample_radius', 1.5)))
    norm = cfg.img_norm_cfg
    img = torch.from_numpy(batch['img']).to(dev)
    if norm.get('to_rgb', False):
        img = img.flip(-1)
    img = (img - torch.tensor(norm['mean'], device=dev)) \
        / torch.tensor(norm['std'], device=dev)
    model.zero_grad(set_to_none=True)
    losses = model.loss(img, targets, max_pos)
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in losses.items()}, grads


@contextlib.contextmanager
def k4_launchers(forward, backward):
    """Within the block, the port's row gathers on CUDA tensors run
    ``forward`` and ``backward`` in place of K4's grouped launchers
    (``gather.gather_grouped_cuda``, ``gather.scatter_grouped_cuda``),
    through which the one-segment gathers go too."""
    from das_tpu_torch.ops import gather
    saved = gather.gather_grouped_cuda, gather.scatter_grouped_cuda
    gather.gather_grouped_cuda, gather.scatter_grouped_cuda = forward, \
        backward
    try:
        yield
    finally:
        gather.gather_grouped_cuda, gather.scatter_grouped_cuda = saved


def k4_witness(seen):
    """K4's grouped launchers, each also holding its result against the
    plain version on the very same inputs. ``seen`` gets one (direction, N,
    R, C, P, dtype, max err / max|ref|) per segment of a forward launch and
    per table of a backward launch (P then counts all its segments'
    points); the forward's error is 0 when it is equal bit for bit and inf
    otherwise. ``seen.launches`` counts the launches."""
    import torch
    from das_tpu_torch.ops import gather
    kernel_fwd = gather.gather_grouped_cuda
    kernel_bwd = gather.scatter_grouped_cuda

    def forward(tables, idxs):
        outs = kernel_fwd(tables, idxs)
        wants = gather.gather_grouped_plain(tables, idxs)
        seen.launches[0] += 1
        for t, i, o, w in zip(tables, idxs, outs, wants):
            seen.append(('forward', *t.shape, i.shape[1], t.dtype,
                         0.0 if torch.equal(o, w) else math.inf))
        return outs

    def backward(grads, idxs, which, rows, dtypes):
        gots = kernel_bwd(grads, idxs, which, rows, dtypes)
        wants = gather.scatter_grouped_plain(grads, idxs, which, rows,
                                             dtypes)
        seen.launches[1] += 1
        for u, (got, want) in enumerate(zip(gots, wants)):
            check((got is None) == (want is None), 'K4 backward: a table')
            if got is None:
                continue
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            N, R, C = got.shape
            P = sum(i.shape[1] for i, w, g in zip(idxs, which, grads)
                    if w == u and g is not None)
            seen.append(('backward', N, R, C, P, dtypes[u],
                         err / scale if scale else (0.0 if err == 0 else
                                                    math.inf)))
        return gots
    return forward, backward


class Seen(list):
    """The witness's records, and its (forward, backward) launches."""

    def __init__(self):
        super().__init__()
        self.launches = [0, 0]


def train_full_width(steps=5, cfg_path=SERVING_CFG, profile=False):
    """``steps`` train steps of ``cfg_path`` (exp_panoptic_tpu) at its train
    bucket, B=4, bf16 compute on f32 master weights, on a synthetic
    TrainLoader batch (8 people per image, one per regress range in turn).
    The K4 and K1 counts are set to 0 just before the steps and read just
    after: each step launches K4 and K1 ``train_step_launches`` times (for
    exp_panoptic_tpu's 'shift' DCNs under the head's remat 24 + 12 and 32 +
    16: every DCN conv's forward, its recompute and its backward), every
    backward call of K1 on its tiled pass, and no plain shift expansion.
    K1's backward calls are timed inside each step by CUDA events around
    each. With ``profile``, one more step under ``torch.profiler`` gives the
    device's busy ms. Returns the (forward, backward) launches of K4 and of
    K1, and the run: its trained model, config, batch, feature map sizes,
    max_pos, the launches a step, step times and peak memory."""
    import numpy as np
    import torch
    from das_tpu_torch.config import Config
    from das_tpu_torch.ops import dcn_shift, deform_conv, gather
    from das_tpu_torch.parallel import frozen_mask, mspn_frozen_prefixes
    from das_tpu_torch.tools.profile_train import (make_trainer,
                                                   synthetic_batch,
                                                   train_pad_hw)
    cfg = Config.fromfile(cfg_path)
    name = os.path.basename(cfg_path)[:-3]
    head = cfg.model.bbox_head
    H, W = train_pad_hw(cfg.train_pipeline)
    B = 4
    t0 = time.perf_counter()
    state, step, _, max_pos = make_trainer(cfg, torch.bfloat16, 'cuda', B,
                                           (H, W))
    k4f, k4b, k1f, k1b = train_step_launches(cfg, (H, W), max_pos)
    model = state.model
    trainable = frozen_mask(model, mspn_frozen_prefixes(
        int(cfg.model.backbone.frozen_stages)))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    host_batch = synthetic_batch(B, H, W, int(head.num_joints),
                                 int(head.root_idx))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch.items()}
    torch.cuda.synchronize()
    phase('train', f"{name} trainable (dcn_train_gather_mode="
          f"{head.get('dcn_train_gather_mode', 'auto')!r}, dcn_gather_mode="
          f"{head.get('dcn_gather_mode', 'patch')!r}, "
          f"r={head.get('dcn_shift_radius', 2)}, remat (backbone, head) "
          f"{cfg.model.backbone.get('remat', False)}, "
          f"{head.get('remat', False)}, "
          f"sparse_refine={cfg.model.train_cfg.sparse_refine}, "
          f"frozen_stages={cfg.model.backbone.frozen_stages}) built in "
          f'{time.perf_counter() - t0:.1f} s: B={B} {H}x{W}, bf16 compute, '
          f'f32 master weights, max_pos={max_pos}, '
          f'{sum(v == 0.0 for v in trainable.values())} of {len(trainable)}'
          f' parameter tensors frozen')
    torch.cuda.reset_peak_memory_stats()
    gather.launches = gather.backward_launches = 0
    dcn_shift.launches = dcn_shift.backward_launches = 0
    dcn_shift.backward_tiled_launches = 0
    times = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    plain_shift = deform_conv._deform_conv_shift
    plain_calls = [0]

    def counted_plain(*a, **k):
        plain_calls[0] += 1
        return plain_shift(*a, **k)
    deform_conv._deform_conv_shift = counted_plain
    spans, k1_bwd_ms = [], []
    try:
        for i in range(steps):
            f0, b0 = gather.launches, gather.backward_launches
            k0, kb0 = dcn_shift.launches, dcn_shift.backward_launches
            kt0 = dcn_shift.backward_tiled_launches
            spans.clear()
            torch.cuda.synchronize()
            ev[0].record()
            with k1_backward(k1_timed(spans)):
                state, metrics = step(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
            k1_bwd_ms.append(sum(a.elapsed_time(b) for a, b in spans))
            m = {k: float(v) for k, v in metrics.items()}
            fwd, bwd = gather.launches - f0, gather.backward_launches - b0
            k1 = (dcn_shift.launches - k0, dcn_shift.backward_launches - kb0)
            k1_tiled = dcn_shift.backward_tiled_launches - kt0
            check(all(math.isfinite(v) for v in m.values()), ('train', i, m))
            check(fwd == k4f and bwd == k4b,
                  ('train K4 launches', i, fwd, bwd, k4f, k4b))
            check(k1 == (k1f, k1b) and plain_calls[0] == 0,
                  ('train K1 launches, plain shift calls', i, k1, k1f, k1b,
                   plain_calls[0]))
            # every backward call of the step takes the tiled pass
            check(k1_tiled == k1b,
                  ('train K1 backward calls on the tiled pass', i, k1_tiled))
            phase('train', f'step {i}: ' + ', '.join(
                f'{k} {v:.6g}' for k, v in m.items()) + f'; {times[-1]:.2f} '
                f'ms (CUDA events), of which K1\'s {len(spans)} backward '
                f'calls {k1_bwd_ms[-1]:.2f} ms (CUDA events around each '
                f'call, summed); K4 launches {fwd} forward + {bwd} '
                f'backward; K1 {k1[0]} forward + {k1[1]} backward, '
                f'{k1_tiled} of them on the tiled pass, no plain shift '
                f'expansion')
    finally:
        deform_conv._deform_conv_shift = plain_shift
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frozen_same = all(torch.equal(p, before[k])
                      for k, p in model.named_parameters()
                      if trainable[k] == 0.0)
    moved = sum(not torch.equal(p, before[k])
                for k, p in model.named_parameters() if trainable[k] == 1.0)
    check(frozen_same, 'a frozen parameter moved')
    check(moved > 0.5 * sum(trainable.values()),
          ('trainable parameters that moved', moved))
    phase('train', f'{steps} steps ok: median {np.median(times):.2f} ms, '
          f'steps 2-{steps} median {np.median(times[1:]):.2f} ms (K1\'s '
          f'backward calls in them {np.median(k1_bwd_ms[1:]):.2f} ms), peak '
          f'memory {peak:.2f} GiB; losses finite; frozen parameters '
          f'unchanged bit for bit; {moved} of {int(sum(trainable.values()))}'
          f' trainable tensors moved; K4 launches {gather.launches} forward'
          f' + {gather.backward_launches} backward; K1 {dcn_shift.launches}'
          f' forward + {dcn_shift.backward_launches} backward, '
          f'{dcn_shift.backward_tiled_launches} of them on the tiled pass; '
          f'K1\'s backward calls summed in each step (CUDA events) '
          + ', '.join(f'{b:.2f} of {t:.2f} ms' for b, t in zip(k1_bwd_ms,
                                                               times)))
    featmaps = [(H // (4 * 2 ** i), W // (4 * 2 ** i))
                for i in range(len(head.strides))]
    k4 = (gather.launches, gather.backward_launches)
    k1 = (dcn_shift.launches, dcn_shift.backward_launches)
    busy = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        busy = device_busy_ms(prof)
        phase('train', f'{name}: one more step under torch.profiler: device '
              f'busy {busy:.2f} ms, idle share against the median of steps '
              f'2-{steps} {1 - busy / np.median(times[1:]):.3f}')
    return k4, k1, dict(
        model=model, cfg=cfg, batch=host_batch, featmaps=featmaps,
        max_pos=max_pos, median_ms=float(np.median(times)),
        k1_tiled=dcn_shift.backward_tiled_launches,
        k1_in_step_ms=[float(b) for b in k1_bwd_ms],
        step_ms=[float(t) for t in times], per_step=(k4f, k4b, k1f, k1b),
        peak_gib=peak, busy_ms=busy)


def train_k4_vs_plain_on_card(run, dtypes=('bf16',)):
    """Full depth, full width: the gradient pass of ``train_full_width``'s
    step (its model after the steps, its B=4 640x1344 batch) on the card,
    with K4 and with K4's plain pair in its place, for each compute type of
    ``dtypes``.

    Five passes: K4 with each launch held against the plain version on its
    own inputs (forward bit for bit, backward within 1e-5 (f32) or one bf16
    step (bf16) of max|ref|: K4 at every shape and on every value the
    training path gives it), then plain, plain again, K4 again, and plain
    with the rows of each adjoint segment added in a shuffled order
    (``reordered_scatter``). The forward is the same bit for bit, so the
    loss terms must be equal. The gradients differ only where sums are
    taken with atomics in another order (K4's adjoint, ``index_add_``,
    cuDNN), so each leaf's K4-vs-plain error must stay within GRAD_NOISE
    times the largest of the plain-vs-plain, K4-vs-K4 and reordered-vs-plain
    errors of that leaf, or within 1e-3 of the leaf's largest plain gradient
    where that is more; a leaf that is zero to rounding within ZERO_GRAD of
    the largest of all. The reordered pass is there because each adjoint's
    atomics land in nearly the same order every time it runs, so two runs
    of one adjoint can agree far more closely than K4's and ``index_add_``'s
    orders do: under the 'clip' DCNs a leaf's K4-vs-plain error has been
    tens of times its repeat spread, while the shuffled order moves it as
    much as K4 does. In f32 that noise is ~4e-5 of a leaf's largest value,
    so every leaf is held at 1e-3 of it; in bf16 it reaches ~7e-2 in the
    backbone (bf16 weight gradients, each rounding flip one bf16 step),
    while the RU's leaves, next to K4, come out nearly equal.
    """
    import torch
    from das_tpu_torch.models.layers import keep_master_weights
    from das_tpu_torch.ops import gather
    model, cfg = run['model'], run['cfg']
    args = (cfg, run['batch'], run['featmaps'], run['max_pos'])
    plain = (gather.gather_grouped_plain, gather.scatter_grouped_plain)
    for name in dtypes:
        dt = {'bf16': torch.bfloat16, 'f32': torch.float32}[name]
        keep_master_weights(model, dt)
        seen = Seen()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with k4_launchers(*k4_witness(seen)):
            la, ga = loss_grads(model, *args)
        with k4_launchers(*plain):
            lb, gb = loss_grads(model, *args)
            lc, gc = loss_grads(model, *args)
        ld, gd = loss_grads(model, *args)
        with k4_launchers(plain[0], reordered_scatter(0)):
            _, ge = loss_grads(model, *args)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tol = 1e-5 if dt == torch.float32 else BF16_STEP
        fwd = [s for s in seen if s[0] == 'forward']
        bwd = [s for s in seen if s[0] == 'backward']
        check(fwd and bwd and all(s[-1] == 0.0 for s in fwd),
              ('K4 forward != plain on the training path', name,
               [s for s in fwd if s[-1] != 0.0][:3]))
        check(all(s[-1] <= tol for s in bwd),
              ('K4 backward vs plain on the training path', name,
               max(bwd, key=lambda s: s[-1])))
        shapes = sorted({s[1:5] for s in seen})
        check(seen.launches == list(run['per_step'][:2]),
              ('K4 launches of the gradient pass', name, seen.launches))
        check(la == lb, ('loss terms, K4 vs plain on the card', name, la,
                         lb))
        eb = leaf_errors(ge, gb)
        ab, bc, ad, own, real, held, worst, where = grads_vs_plain(
            ga, gb, gc, gd, ('K4', name), eb)
        ru = [k for k in real if 'recursive_update' in k]

        def over(noise):
            # the leaf whose K4-vs-plain error is the most times ``noise``
            r = {k: ab[k] / noise[k] for k in real if noise[k] > 0}
            return (max(r.values()), max(r, key=r.get)) if r else (0, None)
        rep = over({k: max(bc[k], ad[k]) for k in real})
        reo = over(eb)
        del ge
        B, H, W = run['batch']['img'].shape[:3]
        phase('train', f'{name} gradient pass, full depth, B={B} {H}x{W}, '
              f'K4 vs its plain pair on the card ({secs:.1f} s for 5 '
              f'passes, peak memory {peak:.2f} GiB): {seen.launches[0]} forward + '
              f'{seen.launches[1]} backward K4 launches ({len(fwd)} gathers, '
              f'{len(bwd)} table gradients) held against plain on their own inputs at '
              f'{len(shapes)} (N, R, C, P) shapes {shapes}: forward bit for'
              f' bit, backward max err / max|ref| '
              f'{max(s[-1] for s in bwd):.3g} (<= {tol:.3g}); loss terms '
              f'equal; gradients: K4 vs plain max err / max|leaf| '
              f'{max(ab[k] / own[k] for k in real):.3g} over {len(real)} '
              f'leaves ({max(ab[k] / own[k] for k in ru):.3g} over the '
              f'{len(ru)} RU leaves), plain vs plain '
              f'{max(bc[k] / own[k] for k in real):.3g}, K4 vs K4 '
              f'{max(ad[k] / own[k] for k in real):.3g}, reordered plain '
              f'vs plain {max(eb[k] / own[k] for k in real):.3g}; K4 vs '
              f'plain at most {rep[0]:.3g}x the repeats\' spread ({rep[1]})'
              f' and {reo[0]:.3g}x the reordered spread ({reo[1]}); '
              f'{sum(ab[k] == 0.0 for k in gb)} of {len(gb)} leaves equal, '
              f'{held} of {len(real)} held at 1e-3 of their largest, the '
              f'rest at {GRAD_NOISE:g}x their noise; worst leaf at '
              f'{worst:.3g} of its tolerance ({where}) ok')
    keep_master_weights(model, torch.bfloat16)


def leaf_errors(x, y):
    """{leaf: max |x - y|} over the gradient leaves of ``y``."""
    return {k: float((x[k].float() - y[k].float()).abs().max()) for k in y}


def reordered_scatter(seed):
    """K4's plain adjoint (``gather.scatter_grouped_plain``) with the rows of
    each segment added in a shuffled order (one permutation of its points
    from ``seed``, the same for every image): the same sums as K4's adjoint
    and ``index_add_``, taken in another order."""
    import torch
    from das_tpu_torch.ops import gather
    gen = None

    def scatter(grads, idxs, which, rows, dtypes):
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device=idxs[0].device)
            gen.manual_seed(seed)
        gs, ix = [], []
        for g, i in zip(grads, idxs):
            p = torch.randperm(i.shape[1], device=i.device, generator=gen)
            gs.append(None if g is None else g[:, p])
            ix.append(i[:, p])
        return gather.scatter_grouped_plain(gs, ix, which, rows, dtypes)
    return scatter


def grads_vs_plain(ga, gb, gc, gd, what, reordered=None):
    """Gradient leaves of four passes, kernel (a), plain (b), plain again
    (c), kernel again (d): each leaf's kernel-vs-plain error within
    GRAD_NOISE times the larger of its plain-vs-plain and kernel-vs-kernel
    errors (and of ``reordered``, {leaf: error} of a plain pass whose sums
    were taken in another order, where given), or within 1e-3 of the leaf's
    largest plain value where that is more; a leaf that is zero to rounding
    within ZERO_GRAD of the largest of all. Returns the errors (a-b, c-b,
    d-a), each leaf's largest plain value, the leaves that are not zero to
    rounding, how many of them were held at 1e-3, and the worst leaf's
    error / tolerance and name."""
    check(sorted(ga) == sorted(gb), ('gradient keys', what))
    own = {k: float(v.abs().max()) for k, v in gb.items()}
    top = max(own.values())
    ab, bc, ad = leaf_errors(ga, gb), leaf_errors(gc, gb), \
        leaf_errors(gd, ga)
    noise = {k: max(bc[k], ad[k], (reordered or {}).get(k, 0.0))
             for k in gb}
    worst, where = 0.0, None
    for k in gb:
        t = max(1e-3 * own[k], GRAD_NOISE * noise[k])
        if own[k] < ZERO_GRAD * top:
            t = max(t, ZERO_GRAD * top)
        check(ab[k] <= t, ('gradient, kernel vs plain on the card', what, k,
                           ab[k], own[k], noise[k]))
        if ab[k] / t > worst:
            worst, where = ab[k] / t, k
    real = [k for k in gb if own[k] >= ZERO_GRAD * top]
    held = sum(1e-3 * own[k] >= GRAD_NOISE * noise[k] for k in real)
    return ab, bc, ad, own, real, held, worst, where


@contextlib.contextmanager
def k1_backward(backward):
    """Within the block, K1's backward on the card (``dcn_shift.
    deform_conv_shift_backward_cuda``, which the wrapper looks up at each
    call) is ``backward``."""
    from das_tpu_torch.ops import dcn_shift
    saved = dcn_shift.deform_conv_shift_backward_cuda
    dcn_shift.deform_conv_shift_backward_cuda = backward
    try:
        yield
    finally:
        dcn_shift.deform_conv_shift_backward_cuda = saved


def plain_backward_on_card(x, offset, mask, weight, grad, radius=1,
                           needs=(True,) * 5, K=3, padding=1):
    """K1's backward replaced by autograd through the plain shift expansion
    ``_deform_conv_shift`` at the same inputs, on the card: what the
    gradient pass took before K1 had a backward."""
    import torch
    from das_tpu_torch.ops import deform_conv
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                    weight)]
        bias = torch.zeros(weight.shape[-1], dtype=x.dtype, device=x.device,
                           requires_grad=True)
        out = deform_conv._deform_conv_shift(*ins, bias, K, padding, radius)
        grads = torch.autograd.grad(out, ins + [bias], grad)
    return tuple(g if n else None for g, n in zip(grads, needs))


def k1_timed(spans):
    """K1's backward with a pair of CUDA events recorded around each call
    on the current stream: ``spans`` gets the (start, end) pair of each."""
    import torch
    from das_tpu_torch.ops import dcn_shift
    kernel = dcn_shift.deform_conv_shift_backward_cuda

    def backward(*args, **kwargs):
        pair = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        pair[0].record()
        got = kernel(*args, **kwargs)
        pair[1].record()
        spans.append(pair)
        return got
    return backward


def k1_witness(seen):
    """K1's backward, each call also holding its result against the closed
    form on the very same inputs: ``seen`` gets one (N, H, W, Cin, Cout,
    dtype, max over the outputs of err / max|ref|) a call."""
    from das_tpu_torch.ops import dcn_shift
    kernel = dcn_shift.deform_conv_shift_backward_cuda

    def backward(x, offset, mask, weight, grad, radius=1,
                 needs=dcn_shift.ALL, K=3, padding=1):
        got = kernel(x, offset, mask, weight, grad, radius, needs, K,
                     padding)
        want = dcn_shift.deform_conv_shift_backward_plain(
            x, offset, mask, weight, grad, radius, needs, K, padding)
        worst = 0.0
        for g, w in zip(got, want):
            check((g is None) == (w is None), 'K1 backward: an output')
            if g is None:
                continue
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            worst = max(worst, err / scale if scale else
                        (0.0 if err == 0 else math.inf))
        seen.append((*x.shape, weight.shape[-1], x.dtype, worst))
        return got
    return backward


def train_k1_vs_plain_on_card(run):
    """Full depth, full width, f32: the gradient pass of
    ``train_full_width``'s step (its model after the steps, its B=4
    640x1344 batch) on the card with K1's backward, and with autograd
    through the plain shift expansion ``_deform_conv_shift`` in its place
    (``plain_backward_on_card``). K1's forward runs in both, so the two
    passes see the same values: the forward's own order of summation,
    within 4.8e-7 of the plain expansion's, is amplified by the random-init
    train-mode network (to 2.2e-3 of a backbone leaf in one run), as the
    card's and the CPU's rounding are.

    Four passes: K1 with each backward call held against the closed form on
    its own inputs (within 1e-5 of max|ref|), then plain, plain again and
    K1 again. The loss terms must be equal, and the gradients are held as
    ``grads_vs_plain`` holds them (as K4 is held)."""
    import torch
    from das_tpu_torch.models.layers import keep_master_weights
    model, cfg = run['model'], run['cfg']
    args = (cfg, run['batch'], run['featmaps'], run['max_pos'])
    keep_master_weights(model, torch.float32)
    seen = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with k1_backward(k1_witness(seen)):
        la, ga = loss_grads(model, *args)
    with k1_backward(plain_backward_on_card):
        lb, gb = loss_grads(model, *args)
        lc, gc = loss_grads(model, *args)
    ld, gd = loss_grads(model, *args)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    keep_master_weights(model, torch.bfloat16)
    check(len(seen) == run['per_step'][3]
          and all(s[-1] <= 1e-5 for s in seen),
          ('K1 backward vs closed form on the training path', len(seen),
           max(seen, key=lambda s: s[-1]) if seen else None))
    check(la == lb, ('loss terms, K1 vs plain on the card', la, lb))
    ab, bc, ad, own, real, held, worst, where = grads_vs_plain(
        ga, gb, gc, gd, 'K1')
    # the DCN convs' own weights: each sits beside its conv_offset
    dcn = [k for k in real if k.endswith('.weight')
           and k[:-len('weight')] + 'conv_offset.weight' in gb]
    B, H, W = run['batch']['img'].shape[:3]
    shapes = sorted({s[:5] for s in seen})
    phase('train', f'f32 gradient pass, full depth, B={B} {H}x{W}, K1\'s '
          f'backward vs autograd through the plain shift expansion on the '
          f'card ({secs:.1f} s for 4 '
          f'passes, peak memory {peak:.2f} GiB): {len(seen)} K1 backward '
          f'calls held against the closed form on their own inputs at '
          f'{len(shapes)} shapes {shapes}: max err / max|ref| '
          f'{max(s[-1] for s in seen):.3g} (<= 1e-5); loss terms equal; '
          f'gradients: K1 vs plain max err / max|leaf| '
          f'{max(ab[k] / own[k] for k in real):.3g} over {len(real)} leaves '
          f'({max(ab[k] / own[k] for k in dcn):.3g} '
          f'over the {len(dcn)} DCN weights), plain vs plain '
          f'{max(bc[k] / own[k] for k in real):.3g}, K1 vs K1 '
          f'{max(ad[k] / own[k] for k in real):.3g}; {held} of {len(real)}'
          f' held at 1e-3 of their largest, the rest at {GRAD_NOISE:g}x '
          f'their noise; worst leaf at {worst:.3g} of its tolerance '
          f'({where}) ok')


def cut_train_cfg():
    """exp_panoptic_tpu with the backbone cut to one stage of one block per
    unit, widths kept: a random-init train-mode forward at full depth
    amplifies two devices' (or two reduction orders') rounding to ~1e-2 at
    the FPN outputs (see train_kernel_vs_plain)."""
    from das_tpu_torch.config import Config
    cfg = Config.fromfile(SERVING_CFG)
    cfg.model.backbone.update(num_stages=1, num_blocks=[1, 1, 1, 1])
    return cfg


def leaves_close(got, want, what, rtol=CARD_CPU_RTOL):
    """Each leaf of ``got`` within ``rtol`` of the largest value of its leaf
    in ``want``, a leaf that is zero to rounding (below ZERO_GRAD of the
    largest of all) within 10 x ZERO_GRAD of that largest; returns the
    worst error / tolerance of each kind and the tolerances."""
    top = max(float(w.abs().max()) for w in want.values())
    worst, tols = [0.0, 0.0], {}
    for k, w in want.items():
        own = float(w.abs().max())
        zero = own < ZERO_GRAD * top
        tol = 10 * ZERO_GRAD * top if zero else rtol * own
        err = float((got[k] - w).abs().max())
        check(err <= tol, (what, k, err, own, top))
        worst[zero], tols[k] = max(worst[zero], err / tol), tol
    return worst, tols


def train_kernel_vs_plain():
    """One fp32 step of exp_panoptic_tpu at B=2 128x160 on the card (K4
    live) and on the CPU (plain), same weights and batch, TF32 off: first
    the loss's gradients, then the step. Loss terms rtol 1e-4, grad_norm
    rtol 1e-3.

    Each gradient leaf agrees within CARD_CPU_RTOL (2e-2) of its largest
    CPU value. A random-init train-mode step is ill-conditioned: the
    card's and the CPU's convs round differently, and while the median
    leaf agrees to ~2e-6 of its largest value, a few leaves of the
    backbone's low-resolution layers differ by ~1e-2 (PERF.md). A fault
    moves a leaf by the order of the leaf. A leaf whose CPU gradient is
    zero to rounding (below
    ZERO_GRAD of the largest of all leaves: a conv bias before a norm)
    must be so on the card too, within 10 x ZERO_GRAD of that largest.
    Each update (-lr * lr_mult * trainable * momentum) is held the same
    way, and the parameters then agree to that plus one f32 rounding.

    Widths are the config's; the backbone is cut to one stage of one block
    per unit: at full depth the random-init train-mode forward amplifies
    the card's and the CPU's rounding differences to ~1e-2 at the FPN
    outputs. ``train_k4_vs_plain_on_card`` holds K4 in the full model, where
    both sides run on the card."""
    import torch
    from das_tpu_torch.ops import dcn_shift, gather
    from das_tpu_torch.parallel import (frozen_mask, mspn_frozen_prefixes,
                                        param_groups)
    from das_tpu_torch.tools.profile_train import (make_trainer,
                                                   synthetic_batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut_train_cfg()
    head = cfg.model.bbox_head
    B, H, W = 2, 128, 160
    cpu, cpu_step, lr_fn, max_pos = make_trainer(cfg, torch.float32, 'cpu',
                                                 B, (H, W), seed=3)
    gpu, gpu_step, _, _ = make_trainer(cfg, torch.float32, 'cuda', B,
                                       (H, W), seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    batch = synthetic_batch(B, H, W, int(head.num_joints),
                            int(head.root_idx), seed=1)
    featmaps = [(H // (4 * 2 ** i), W // (4 * 2 ** i)) for i in range(4)]
    args = (cfg, batch, featmaps, max_pos)

    f0, b0 = gather.launches, gather.backward_launches
    k0, kb0 = dcn_shift.launches, dcn_shift.backward_launches
    _, gg = loss_grads(gpu.model, *args)
    gathers = (gather.launches - f0, gather.backward_launches - b0)
    k1 = (dcn_shift.launches - k0, dcn_shift.backward_launches - kb0)
    gg = {k: v.cpu() for k, v in gg.items()}
    _, gc = loss_grads(cpu.model, *args)
    want = train_step_launches(cfg, (H, W), max_pos)
    check(sorted(gg) == sorted(gc) and min(gathers) > 0
          and gathers + k1 == want,
          ('gradient keys, K4 or K1 launches', gathers, k1, want))
    p0 = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    g_worst, _ = leaves_close(gg, gc, 'gradient')
    cpu, mc = cpu_step(cpu, batch)
    gpu, mg = gpu_step(gpu, {k: torch.from_numpy(v).cuda()
                             for k, v in batch.items()})
    mc = {k: float(v) for k, v in mc.items()}
    mg = {k: float(v) for k, v in mg.items()}
    for k, v in mc.items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        check(abs(mg[k] - v) <= rtol * abs(v) + 1e-7, ('metric', k, mg[k], v))
    lr_mult, _ = param_groups(cpu.model)
    trainable = frozen_mask(cpu.model, mspn_frozen_prefixes(
        int(cfg.model.backbone.frozen_stages)))
    f = {k: -lr_fn(0) * lr_mult[k] * trainable[k] for k in trainable}
    uc = {k: f[k] * m for k, m in cpu.opt_state['momentum'].items()}
    ug = {k: f[k] * m.cpu() for k, m in gpu.opt_state['momentum'].items()}
    u_worst, u_tol = leaves_close(ug, uc, 'update')
    sc, sg = cpu.model.state_dict(), gpu.model.state_dict()
    for k in uc:
        p = sc[k]
        check(bool(((sg[k].cpu() - p).abs()
                    <= u_tol[k] + torch.finfo(torch.float32).eps * p.abs())
                   .all()), ('parameter after the step', k))
        if trainable[k] == 0.0:
            check(torch.equal(p, p0[k]) and torch.equal(sg[k].cpu(), p0[k]),
                  ('frozen parameter moved', k))
    top = max(float(w.abs().max()) for w in gc.values())
    errs = sorted((float((gg[k] - w).abs().max()) / float(w.abs().max()), k)
                  for k, w in gc.items() if float(w.abs().max()) >= ZERO_GRAD
                  * top)
    phase('plain', f'train step B={B} {H}x{W} fp32 (backbone 1 stage of 1 '
          f'block per unit), card (K4 {gathers[0]} forward + {gathers[1]} '
          f'backward and K1 {k1[0]} + {k1[1]} launches in the gradient pass) '
          f'vs CPU: ' + ', '.join(f'{k} {mg[k]:.6g}/{mc[k]:.6g}'
                                  for k in mc)
          + f'; gradients: max err / max|leaf| {errs[-1][0]:.3g} '
          f'({errs[-1][1]}), median {errs[len(errs) // 2][0]:.3g}, over '
          f'{len(errs)} leaves; within {g_worst[0]:.3g} of their tolerance'
          f' ({CARD_CPU_RTOL:g} of their largest), the {len(gc) - len(errs)}'
          f' that are zero to rounding within {g_worst[1]:.3g} of theirs; '
          f'updates within {u_worst[0]:.3g} and {u_worst[1]:.3g}; '
          f'parameters agree; frozen unchanged ok')


EVAL_DIR = os.path.join(HERE, 'build', 'chip_smoke_eval')
EVAL_J = 15
EVAL_F = 1000.0
# decoded people of two runs that should agree (fused against unfused, card
# against CPU): scores within EVAL_SCORE_TOL, each pose within EVAL_POSE_RTOL
# of its largest coordinate (phase 5's tolerances)
EVAL_SCORE_TOL = 1e-4
EVAL_POSE_RTOL = 1e-3


@contextlib.contextmanager
def no_tf32():
    """f32 convs and matmuls in f32, as the CPU computes them, for the
    block; the flags as they were after it."""
    import torch
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def png_bytes(rgb):
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8: zlib over filter-0
    rows."""
    import struct
    import zlib
    import numpy as np
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                          axis=1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes(), 1))
            + chunk(b'IEND', b''))


def write_eval_data(name, n, h, w, seed):
    """``n`` synthetic h x w PNG frames and a CMU-Panoptic-format
    annotation json beside them (the layout of
    tests/test_datasets.py::make_panoptic_json: pinhole camera of focal
    EVAL_F / 1920 * w at the centre, 2 or 3 people an image with pixel+depth
    joints, world joints, full visibility). Returns (folder, json path)."""
    import numpy as np
    root = os.path.join(EVAL_DIR, name)
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    f = EVAL_F * w / 1920
    images, anns = [], []
    for i in range(n):
        blocks = rng.randint(0, 256, (h // 40 + 1, w // 40 + 1, 3))
        rgb = np.kron(blocks, np.ones((40, 40, 1), np.int64))[:h, :w]
        rgb = (rgb + rng.randint(0, 16, (h, w, 3))).clip(0, 255)
        fname = f'frame_{i:02d}.png'
        with open(os.path.join(root, fname), 'wb') as fh:
            fh.write(png_bytes(rgb.astype(np.uint8)))
        images.append(dict(
            id=i + 1, file_name=fname, width=w, height=h,
            cam=dict(K=[[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.]],
                     R=np.eye(3).tolist(), t=[[0.], [0.], [0.]])))
        for p in range(2 + i % 2):
            base = np.array([w * (0.2 + 0.3 * p), h * 0.45, 300.0 + 40 * p])
            joints = base + rng.randn(EVAL_J, 3) * [w / 30, h / 10, 15]
            u, v, z = joints.T
            world = np.stack([(u - w / 2) / f * z, (v - h / 2) / f * z, z], 1)
            bbox = [float(u.min()), float(v.min()), float(np.ptp(u)),
                    float(np.ptp(v))]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0,
                joints3d_img=joints.tolist(), joints3d=world.tolist(),
                joints2d_vis=[[1, 1]] * EVAL_J,
                joints3d_vis=[[1, 1, 1]] * EVAL_J))
    ann = os.path.join(root, 'annotations.json')
    with open(ann, 'w') as fh:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), fh)
    return root, ann


def eval_config(cfg_path, root, ann, img_scale=None):
    """``cfg_path`` with its test data set to ``ann`` and the images under
    ``root`` (and the test scale to ``img_scale``, where given), as
    ``--cfg-options`` sets them."""
    from das_tpu_torch.config import Config
    cfg = Config.fromfile(cfg_path)
    opts = {'data.test.ann_file': ann, 'data.test.img_prefix': root}
    if img_scale is not None:
        opts['data.test.pipeline.2.img_scale'] = img_scale
    cfg.merge_from_dict(opts)
    return cfg


@contextlib.contextmanager
def per_batch_counts(model, expect):
    """The launches of each batch that ``run_test`` evaluates: every count of
    ``expect`` set to 0 as the model's forward starts (a pre-hook) and read
    as the batch's decode returns. Yields the list of per-batch counts."""
    import das_tpu_torch.apis.test as test_api
    batches = []
    real = test_api.decode_batch

    def start(mod, inp):
        for mod_, attr in expect:
            setattr(mod_, attr, 0)

    def decode(*args, **kwargs):
        out = real(*args, **kwargs)
        batches.append({count_label(k): getattr(*k) for k in expect})
        return out

    hook = model.register_forward_pre_hook(start)
    test_api.decode_batch = decode
    try:
        yield batches
    finally:
        hook.remove()
        test_api.decode_batch = real


def people_agree(ref, got, what):
    """Two runs' decoded people of each image (``run_test``'s output dicts):
    the same count, scores in the same order within EVAL_SCORE_TOL, and each
    pose of ``got`` within EVAL_POSE_RTOL (of its largest coordinate) of a
    ``ref`` pose whose score is within EVAL_SCORE_TOL; the lowest-scored
    entries, where a near tie can cross the nms_post cut, are skipped.
    Returns (people, worst relative pose error)."""
    import numpy as np
    worst, people = 0.0, 0
    for i, (r, g) in enumerate(zip(ref, got)):
        sr, sg = np.asarray(r['scores']), np.asarray(g['scores'])
        check(len(sr) == len(sg), (what, 'people', i, len(sr), len(sg)))
        people += len(sg)
        if not len(sg):
            continue
        check(np.abs(sr - sg).max() <= EVAL_SCORE_TOL, (what, 'scores', i))
        cut = sr.min() + EVAL_SCORE_TOL
        for p in range(len(sg)):
            if sg[p] <= cut:
                continue
            near = np.abs(sr - sg[p]) <= EVAL_SCORE_TOL
            err = np.abs(r['poses'][near] - g['poses'][p]).max(axis=(1, 2))
            worst = max(worst, float(err.min()) / max(
                1.0, float(np.abs(g['poses'][p]).max())))
    check(worst <= EVAL_POSE_RTOL, (what, 'poses', worst))
    return people, worst


def eval_sweep(model, cfg_path, data, expect):
    """``run_test`` with device preprocessing over the full-width synthetic
    frames (1920x1080 -> 640x1138, padded to 640x1152, B=4), on ``model``
    (bf16, on the card) with the pose template of phase 4's NMS check and
    the cls bias at 0, so that people pass score_thr. Each batch must launch
    exactly its share of ``expect`` (as ``main_path``); people must be found
    and MPJPE finite. Returns ({count: launches over the sweep}, images/s,
    the sweep's results)."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import run_test
    from das_tpu_torch.datasets import build_dataset
    from das_tpu_torch.tools.profile_kernels import pose_template
    name = os.path.basename(cfg_path)[:-3]
    cfg = eval_config(cfg_path, *data)
    pose_template(model)
    ds = build_dataset(cfg.data['test'])
    with per_batch_counts(model, expect) as batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = run_test(model, ds, cfg, batch_size=4, progress=False,
                        device_preprocess=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    labels = {count_label(k): n for k, n in expect.items()}
    for i, got in enumerate(batches):
        check(all(n[0] <= got[k] <= n[1] if isinstance(n, tuple)
                  else got[k] == n for k, n in labels.items())
              and sum(v for k, v in got.items() if 'gather' in k)
              <= K4_PER_REQUEST, (name, 'eval batch', i, got))
    check(len(batches) == len(ds) // 4, (name, 'batches', len(batches)))
    people = [len(o['poses']) for o in outs]
    check(sum(people) > 0, (name, 'no person found'))
    for o in outs:
        check(np.isfinite(o['poses']).all() and o['poses'].shape[1:] ==
              (EVAL_J, 3), (name, 'poses', o['poses'].shape))
    res = ds.evaluate(outs)
    check(np.isfinite(res['mpjpe_mm']), (name, 'MPJPE', res))
    totals = {k: sum(b[k] for b in batches) for k in labels}
    phase('eval', f'{name}: run_test(device_preprocess=True) over {len(ds)} '
          f'synthetic 1920x1080 PNGs, {len(batches)} batches of B=4 '
          f'640x1152 bf16 in {secs * 1e3:.2f} ms ({len(ds) / secs:.2f} '
          f'images/s, decode and all); people per image {people}; MPJPE '
          f"{res['mpjpe_mm']:.2f} mm (random weights); launches per batch "
          + '; '.join(', '.join(f'{v} {k}' for k, v in b.items())
                      for b in batches))
    return totals, len(ds) / secs, outs


def device_preprocess_vs_float64(data, smi):
    """The device preprocessing of one B=4 batch of the frames (1080x1920 ->
    640x1138 -> 640x1152) against a float64 numpy reference of the same
    half-pixel resize, BGR->RGB, normalisation and padding: within 1e-4 in
    normalised units (TF32 or a wrong tap would be far off). Returns the
    preprocessed batch on the card and its scale factors."""
    import numpy as np
    import torch
    from das_tpu_torch.datasets.pipelines import _rescale_size
    from das_tpu_torch.ops.preprocess import make_preprocess_fn
    from das_tpu_torch.utils.image import imread, read_png
    root, ann = data
    paths = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.endswith('.png'))
    t = time.perf_counter()
    raws = [imread(p) for p in paths]
    decode_ms = (time.perf_counter() - t) * 1e3 / len(paths)
    t = time.perf_counter()
    for p, raw in zip(paths, raws):
        with open(p, 'rb') as fh:
            check(np.array_equal(read_png(fh.read(), p), raw),
                  ('the PNG reader differs from imread', p))
    png_ms = (time.perf_counter() - t) * 1e3 / len(paths)
    try:
        import cv2  # noqa: F401
        decoder = 'cv2'
    except ImportError:
        decoder = 'its own PNG reader'
    h, w = raws[0].shape[:2]
    nh, nw = _rescale_size(h, w, (1333, 640))
    ph, pw = -(-nh // 32) * 32, -(-nw // 32) * 32
    check((nh, nw, ph, pw) == (640, 1138, 640, 1152), (nh, nw, ph, pw))
    mean = np.array([123.675, 116.28, 103.53])
    std = np.array([58.395, 57.12, 57.375])
    pre = make_preprocess_fn((h, w), (nh, nw), (ph, pw), mean, std)
    raw = torch.from_numpy(np.stack(raws[:4])).cuda()
    with torch.inference_mode():
        got = pre(raw).cpu().numpy()
        ms = cuda_ms(lambda: pre(raw), 10)

    def taps(src, dst):
        pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        lo = np.floor(pos)
        return (np.clip(lo, 0, src - 1).astype(np.int64),
                np.clip(lo + 1, 0, src - 1).astype(np.int64), pos - lo)
    x = np.stack(raws[:4]).astype(np.float64)
    lo, hi, wt = taps(h, nh)
    x = x[:, lo] * (1 - wt)[:, None, None] + x[:, hi] * wt[:, None, None]
    lo, hi, wt = taps(w, nw)
    x = x[:, :, lo] * (1 - wt)[:, None] + x[:, :, hi] * wt[:, None]
    want = np.zeros((4, ph, pw, 3))
    want[:, :nh, :nw] = (x[..., ::-1] - mean) / std
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape and err <= 1e-4,
          ('device preprocessing vs float64', got.shape, err))
    phase('eval', f'device preprocessing, B=4 uint8 {h}x{w} -> {nh}x{nw} -> '
          f'{ph}x{pw} f32 on the card: max error {err:.3g} of the float64 '
          f'reference (<= 1e-4, normalised units); {ms:.4f} ms a batch '
          f'(CUDA events); host decode (utils/image.imread, through '
          f'{decoder}) {decode_ms:.2f} ms an image, the PNG reader '
          f'(utils/image.read_png, equal bit for bit) {png_ms:.2f} ms; '
          f'{smi}')
    sf = torch.tensor([[nw / w, nh / h]] * 4, device=raw.device)
    return torch.from_numpy(got).to(raw.device), sf, ms, decode_ms


def fuse_at_full_width(img, sf, smi):
    """``fuse_conv_bn`` on the shipped config at full width: an f32 model
    (seeded, offsets perturbed as phase 4, cls bias 0) against its fused
    copy on ``img`` (the preprocessed B=4 640x1152 frames), TF32 off: the
    same people per image, poses within EVAL_POSE_RTOL. Then both in bf16,
    request times (median of 12, alternating). Returns (pairs, unfused ms,
    fused ms)."""
    import copy
    import numpy as np
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    from das_tpu_torch.apis.inference import results_to_host
    from das_tpu_torch.models.fuse import fuse_conv_bn
    from das_tpu_torch.models.layers import cast_compute
    model, cfg = init_model(SERVING_CFG, device='cuda', seed=4)
    perturb_offsets(model, seed=3)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    fused, pairs = fuse_conv_bn(copy.deepcopy(model))
    head = cfg.model.bbox_head
    args = (cfg.model.test_cfg, head.num_joints, head.strides)
    paths = [f'image {i}' for i in range(img.shape[0])]
    with no_tf32():
        ref = results_to_host(make_predict_fn(model, *args, device='cuda')(
            img, sf), paths)
        got = results_to_host(make_predict_fn(fused, *args, device='cuda')(
            img, sf), paths)
    people, worst = people_agree(ref, got, 'fused vs unfused')
    check(people > 0, 'fused vs unfused: no person found')
    plain16 = cast_compute(copy.deepcopy(model), torch.bfloat16)
    fused16 = cast_compute(fused, torch.bfloat16)
    del model
    runs = {'unfused': make_predict_fn(plain16, *args, device='cuda'),
            'fused': make_predict_fn(fused16, *args, device='cuda')}
    times = {k: [] for k in runs}
    for k, fn in runs.items():
        fn(img, sf)                                   # warm-up
    for _ in range(12):
        for k, fn in runs.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(img, sf)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    phase('eval', f'fuse_conv_bn: {pairs} conv+bn pairs fused; f32 at B=4 '
          f'640x1152, fused vs unfused: {people} people on both, poses '
          f'within {worst:.3g} of their largest coordinate (<= '
          f'{EVAL_POSE_RTOL:g}); bf16 request (host clock, median of 12, '
          f'alternating): unfused {med["unfused"]:.2f} ms (min '
          f'{min(times["unfused"]):.2f}), --fuse-conv-bn {med["fused"]:.2f}'
          f' ms (min {min(times["fused"]):.2f}); {smi}')
    return pairs, med['unfused'], med['fused']


def eval_card_vs_cpu():
    """``run_test`` (device preprocessing) at a cut size, the same f32
    weights on the card (kernels) and on the CPU (plain versions): 2
    synthetic 320x240 frames at img_scale (320, 256), cls bias 0. The same
    people per image, poses within phase 5's tolerance."""
    import torch
    from das_tpu_torch.apis import init_model, run_test
    from das_tpu_torch.datasets import build_dataset
    data = write_eval_data('cut', 2, 240, 320, seed=7)
    cfg = eval_config(SERVING_CFG, *data, img_scale=(320, 256))
    cpu, _ = init_model(SERVING_CFG, device='cpu', seed=5)
    perturb_offsets(cpu, seed=6)
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()
    gpu, _ = init_model(SERVING_CFG, device='cuda', seed=5)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    ds = build_dataset(cfg.data['test'])
    kw = dict(batch_size=2, progress=False, device_preprocess=True)
    t = time.perf_counter()
    ref = run_test(cpu, ds, cfg, **kw)
    cpu_s = time.perf_counter() - t
    with no_tf32():
        got = run_test(gpu, ds, cfg, **kw)
    people, worst = people_agree(ref, got, 'card vs CPU')
    check(people > 0, 'card vs CPU: no person found')
    phase('eval', f'run_test card vs CPU, 2 frames 240x320 at img_scale '
          f'(320, 256), f32: {people} people on both, scores within '
          f'{EVAL_SCORE_TOL:g}, poses within {worst:.3g} of their largest '
          f'coordinate (<= {EVAL_POSE_RTOL:g}); CPU sweep {cpu_s:.1f} s')


def eval_cli(data):
    """``python -m das_tpu_torch.tools.test`` on the shipped config and the
    synthetic frames, once, as a user runs it: exit 0 and a finite MPJPE."""
    root, ann = data
    res = os.path.join(EVAL_DIR, 'cli_results')
    cmd = [sys.executable, '-m', 'das_tpu_torch.tools.test', SERVING_CFG,
           '--cfg-options', f'data.test.ann_file={ann}',
           f'data.test.img_prefix={root}', '--device-preprocess', '--eval',
           'mpjpe', '--res-folder', res]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=300)
    secs = time.perf_counter() - t
    lines = proc.stdout.splitlines()
    mpjpe = [float(x.split()[1]) for x in lines if x.startswith('mpjpe_mm ')]
    check(proc.returncode == 0 and len(mpjpe) == 1
          and math.isfinite(mpjpe[0]),
          ('das_tpu_torch.tools.test', proc.returncode, lines[-5:],
           proc.stderr[-2000:]))
    phase('eval', f'python -m das_tpu_torch.tools.test '
          f'{os.path.relpath(SERVING_CFG, HERE)} --cfg-options ... '
          f'--device-preprocess --eval mpjpe: exit 0 in {secs:.1f} s, '
          f'"{next(x for x in lines if x.startswith("MPJPE:"))}"')


TRAIN_DIR = os.path.join(HERE, 'build', 'chip_smoke_train')
# 16 frames at B=4 are 4 steps an epoch: 6 steps cross one epoch end (a
# save, the DCN-offset check and the eval hook), then the final save
TRAIN_STEPS = 6
# the losses of the resumed step against the same step from the run's own
# final state in memory, on the same batch, relative to each loss
RESUME_RTOL = 1e-3


def block_frame(rng, h, w):
    """An h x w uint8 BGR frame of 40-pixel blocks with a little noise."""
    import numpy as np
    blocks = rng.randint(0, 256, (h // 40 + 1, w // 40 + 1, 3))
    img = np.kron(blocks, np.ones((40, 40, 1), np.int64))[:h, :w]
    return (img + rng.randint(0, 16, (h, w, 3))).clip(0, 255) \
        .astype(np.uint8)


def dump_coco_json(path, images, anns):
    """A COCO-format json of one 'person' category; returns ``path``."""
    with open(path, 'w') as fh:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), fh)
    return path


def write_coco_data(root, rng, n=8, h=480, w=640):
    """``n`` COCO-17 keypoint frames (h x w JPEGs) with 3 people each, both
    hips visible, under ``root``; returns the json's path."""
    import cv2
    import numpy as np
    images, anns = [], []
    for i in range(n):
        fname = f'coco_{i:02d}.jpg'
        cv2.imwrite(os.path.join(root, fname), block_frame(rng, h, w))
        images.append(dict(id=i + 1, file_name=fname, width=w, height=h))
        for p in range(3):
            cx, cy = w * (0.3 + 0.2 * p), h * (0.48 + 0.03 * p)
            kp = np.array([cx, cy]) + rng.randn(17, 2) * [w / 40, h / 10]
            kp[11], kp[12] = [cx - 8, cy], [cx + 8, cy + 2]
            vis = np.where(rng.rand(17) < 0.15, 1, 2)
            u, v = kp.T
            bbox = [float(u.min() - 4), float(v.min() - 4),
                    float(np.ptp(u) + 8), float(np.ptp(v) + 8)]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0, num_keypoints=17,
                keypoints=np.concatenate([kp, vis[:, None]], 1)
                .reshape(-1).tolist()))
    return dump_coco_json(os.path.join(root, 'coco_train.json'), images,
                          anns)


def write_train_data(seed=0):
    """The shipped mix on disk: 8 CMU-Panoptic-format 1920x1080 JPEG frames
    with 3-4 people each (the layout of tests/test_train_api.py's
    make_train_dataset, roots well inside the frame so that the random warp
    keeps at least 2) and 8 COCO-17 keypoint frames at 640x480 with 3
    people each. Returns the --cfg-options that point exp_panoptic_tpu's
    data.train at them."""
    import cv2
    import numpy as np
    root = os.path.join(TRAIN_DIR, 'data')
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)

    def frame(h, w):
        return block_frame(rng, h, w)

    def dump(name, images, anns):
        return dump_coco_json(os.path.join(root, name), images, anns)

    h, w, f = 1080, 1920, EVAL_F
    images, anns = [], []
    for i in range(8):
        fname = f'panoptic_{i:02d}.jpg'
        cv2.imwrite(os.path.join(root, fname), frame(h, w))
        images.append(dict(
            id=i + 1, file_name=fname, width=w, height=h,
            cam=dict(K=[[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.]],
                     R=np.eye(3).tolist(), t=[[0.], [0.], [0.]])))
        n = 3 + i % 2
        for p in range(n):
            root_uvz = np.array([w * (0.32 + 0.36 * p / (n - 1)),
                                 h * (0.45 + 0.04 * p), 300.0 + 30 * p])
            joints = root_uvz + rng.randn(EVAL_J, 3) * [w / 40, h / 12, 15]
            joints[2] = root_uvz                      # mid-hip, the root
            u, v, z = joints.T
            world = np.stack([(u - w / 2) / f * z, (v - h / 2) / f * z, z],
                             1)
            bbox = [float(u.min()), float(v.min()), float(np.ptp(u)),
                    float(np.ptp(v))]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0,
                joints3d_img=joints.tolist(), joints3d=world.tolist(),
                joints2d_vis=[[1, 1]] * EVAL_J,
                joints3d_vis=[[1, 1, 1]] * EVAL_J))
    pan = dump('panoptic_train.json', images, anns)
    coco = write_coco_data(root, rng)
    return {'data.train.0.data_root': root, 'data.train.0.ann_file': pan,
            'data.train.0.img_prefix': root,
            'data.train.1.data_root': root, 'data.train.1.ann_file': coco,
            'data.train.1.img_prefix': root,
            'checkpoint_config.max_keep_ckpts': 2}


class TrainWatch:
    """Wraps the step that ``train_model`` builds (``apis/train.py``'s
    ``make_train_step``), its checkpoint manager's save and restore, the
    DCN-offset check, the eval hook's ``run_test`` and its decode, for the
    block. Each step: the counts read just before and just after
    (``per_step``: K4, its adjoint, K1 and its backward as
    ``train_step_launches`` derives them, no K3), CUDA events around
    it, a sync, every metric finite; the step ``profile_at`` under
    ``torch.profiler``. The eval model's forward (a module hook: a DAS in
    eval mode) marks the counts, its decode reads what each rose by since
    the mark (a batch's launches; the run's counts are never reset). With ``resume_ref`` (a state), the first step is
    also run from that state on the same batch first, its losses kept."""

    def __init__(self, expect, per_step, profile_at=None,
                 resume_ref=None):
        self.expect, self.profile_at = expect, profile_at
        self.per_step = list(per_step) + [0]
        self.resume_ref = resume_ref
        self.steps, self.host_ms, self.gap_ms, self.losses = [], [], [], []
        self.saves, self.restored, self.dcn, self.evals = [], [], [], []
        self.batches, self.ref_losses, self.busy_ms = [], None, None
        self.mark = {}
        self.profiled_ms = None

    @contextlib.contextmanager
    def watching(self):
        import torch
        import das_tpu_torch.apis.inference as inf_api
        import das_tpu_torch.apis.test as test_api
        import das_tpu_torch.apis.train as train_api
        from das_tpu_torch.checkpoint import CheckpointManager
        from das_tpu_torch.models import DAS
        saved = (train_api.make_train_step, CheckpointManager.save,
                 CheckpointManager.restore, inf_api.validate_dcn_offsets,
                 test_api.run_test, test_api.decode_batch,
                 inf_api.decode_batch)
        real_make, real_save, real_restore, real_dcn, real_run, \
            real_decode, _ = saved
        watch = self

        def make(*a, **k):
            return watch.step(real_make(*a, **k))

        def save(mgr, state, step):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = real_save(mgr, state, step)
            watch.saves.append((step, (time.perf_counter() - t) * 1e3,
                                os.path.getsize(path)))
            return path

        def restore(mgr, state, step_or_path=None):
            got = real_restore(mgr, state, step_or_path)
            watch.restored.append(restored_equal(mgr, got))
            return got

        def dcn(*a, **k):
            out = real_dcn(*a, **k)
            watch.dcn.append(out)
            return out

        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_run(*a, **k)
            torch.cuda.synchronize()
            watch.evals.append(dict(secs=time.perf_counter() - t,
                                    batches=watch.batches))
            watch.batches = []
            return out

        def decode(*a, **k):
            out = real_decode(*a, **k)
            watch.batches.append({count_label(key): getattr(*key)
                                  - watch.mark[key] for key in watch.expect})
            return out

        def start(mod, inp):
            if isinstance(mod, DAS) and not mod.training:
                watch.mark = {key: getattr(*key) for key in watch.expect}

        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            start)
        # the eval hook's sweep decodes through make_predict_fn (the host
        # pipeline) or through apis/test.py (device preprocessing)
        (train_api.make_train_step, CheckpointManager.save,
         CheckpointManager.restore, inf_api.validate_dcn_offsets,
         test_api.run_test, test_api.decode_batch,
         inf_api.decode_batch) = (make, save, restore, dcn, run, decode,
                                  decode)
        try:
            yield self
        finally:
            hook.remove()
            (train_api.make_train_step, CheckpointManager.save,
             CheckpointManager.restore, inf_api.validate_dcn_offsets,
             test_api.run_test, test_api.decode_batch,
             inf_api.decode_batch) = saved

    def step(self, real):
        import torch
        from das_tpu_torch.ops import dcn_shift, gather, oks_nms
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        last = [None]

        def counted(state, batch):
            i = len(self.steps)
            if i == 0 and self.resume_ref is not None:
                _, m = real(self.resume_ref, batch)
                self.ref_losses = {k: float(v) for k, v in m.items()}
            before = (gather.launches, gather.backward_launches,
                      dcn_shift.launches, dcn_shift.backward_launches,
                      oks_nms.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if last[0] is not None:
                self.gap_ms.append((t - last[0]) * 1e3)
            prof = None
            if i == self.profile_at:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            ev[0].record()
            state, metrics = real(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3
            if prof is not None:
                prof.__exit__(None, None, None)
                self.busy_ms = device_busy_ms(prof)
                self.profiled_ms = host
            last[0] = time.perf_counter()
            after = (gather.launches, gather.backward_launches,
                     dcn_shift.launches, dcn_shift.backward_launches,
                     oks_nms.launches)
            m = {k: float(v) for k, v in metrics.items()}
            check(all(math.isfinite(v) for v in m.values()),
                  ('trainrun step', state.step, m))
            counts = [b - a for a, b in zip(before, after)]
            check(counts == self.per_step,
                  ('trainrun step launches (K4, K4 backward, K1, K1 '
                   'backward, K3)', state.step, counts, self.per_step))
            self.steps.append(ev[0].elapsed_time(ev[1]))
            self.host_ms.append(host)
            self.losses.append(m)
            return state, metrics
        return counted


def device_busy_ms(prof):
    """The device time of a profiled block: its kernels' self device
    time."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0.0))
    return sum(dev_us(e) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3


def restored_equal(mgr, state):
    """The restored state against its file: every model tensor, the
    momentum by name, ``count`` and ``step`` equal bit for bit. Returns
    (step, tensors compared)."""
    import torch
    path = mgr.path(mgr.latest_step())
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = state.model.state_dict()
    check(sorted(sd) == sorted(ckpt['model']), 'restore: model keys')
    n = 0
    for k, v in ckpt['model'].items():
        check(torch.equal(sd[k].cpu(), v), ('restore: model tensor', k))
        n += 1
    mom = state.opt_state['momentum']
    check(sorted(mom) == sorted(ckpt['momentum']), 'restore: momentum keys')
    for k, v in ckpt['momentum'].items():
        check(torch.equal(mom[k].cpu(), v), ('restore: momentum', k))
        n += 1
    check(state.opt_state['count'] == ckpt['count'] and
          state.step == ckpt['step'], ('restore: count, step',
                                       state.opt_state['count'],
                                       state.step))
    return state.step, n


@contextlib.contextmanager
def resize_and_warp_calls():
    """Counts, for the block, the training transforms' resizes and warps
    through the host library (``datasets/native.py``) and through cv2.
    Yields the dict of counts."""
    import cv2
    from das_tpu_torch.datasets import native
    calls = {}
    targets = [(native, 'resize_bilinear'), (native, 'affine_warp'),
               (cv2, 'resize'), (cv2, 'warpAffine')]
    real = {t: getattr(*t) for t in targets}

    def counted(t):
        def call(*a, **kw):
            calls[t[1]] = calls.get(t[1], 0) + 1
            return real[t](*a, **kw)
        return call
    for t in targets:
        setattr(*t, counted(t))
    try:
        yield calls
    finally:
        for t in targets:
            setattr(*t, real[t])


def loader_images_per_s(cfg, batches=6):
    """The training loader alone, as train_model builds it (the shipped
    mix, its train bucket, workers_per_gpu threads, seed 0): images/s over
    ``batches`` batches after the first, this process's CPU seconds an
    image over them (all threads), and the resizes and warps of the run
    through the host library and through cv2."""
    from das_tpu_torch.datasets import build_dataset
    from das_tpu_torch.datasets.loader import (TrainLoader,
                                               train_pad_hw_from_cfg)
    train = cfg.data['train']
    loader = TrainLoader(build_dataset(train), int(cfg.data.samples_per_gpu),
                         train_pad_hw_from_cfg(train[0]['pipeline']),
                         int(cfg.model.bbox_head.num_joints),
                         num_workers=int(cfg.data.workers_per_gpu), seed=0)
    with resize_and_warp_calls() as calls:
        it = iter(loader)
        first = next(it)
        t, cpu = time.perf_counter(), time.process_time()
        for _ in range(batches):
            next(it)
        secs = time.perf_counter() - t
        cpu = time.process_time() - cpu
        it.close()
    images = batches * loader.batch_size
    return images / secs, cpu / images, first['img'].shape, calls


def trainrun(eval_data, synthetic_median, smi):
    """Phase 8: ``train_model`` on exp_panoptic_tpu from the shipped mix on
    disk, B=4 640x1344 bf16 on f32 master weights, TRAIN_STEPS steps with
    an epoch end inside (save, DCN-offset check, eval hook on phase 7's
    frames), a resume from 'latest' for one step, and ``python -m
    das_tpu_torch.tools.train`` for 2 steps. Returns the launches of the
    run (counts set to 0 just before, read just after), the run's
    ``--cfg-options`` (the data on disk) and its median step ms."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import train_model
    from das_tpu_torch.config import Config
    from das_tpu_torch.ops import dcn_shift, gather, oks_nms
    opts = write_train_data()
    opts.update({'data.val.ann_file': eval_data[1],
                 'data.val.img_prefix': eval_data[0],
                 'data.val.data_root': eval_data[0]})
    cfg = Config.fromfile(SERVING_CFG)
    cfg.merge_from_dict(opts)
    ips, cpu, shape, calls = loader_images_per_s(cfg)
    check(calls.get('resize_bilinear', 0) > 0
          and calls.get('affine_warp', 0) > 0
          and not calls.get('resize') and not calls.get('warpAffine'),
          ('the training transforms left the native path', calls))
    phase('trainrun', f'TrainLoader alone (8 Panoptic 1920x1080 + 8 COCO '
          f'640x480 JPEGs, the shipped random pipelines, '
          f'{cfg.data.workers_per_gpu} threads): {ips:.2f} images/s, '
          f'{cpu * 1e3:.1f} ms of host CPU an image, batches '
          f'{tuple(shape)}; the transforms took the native path: '
          f'{calls["resize_bilinear"]} resizes and {calls["affine_warp"]} '
          f'warps through the host library, none through cv2; {smi}')
    work = os.path.join(TRAIN_DIR, 'work')
    if os.path.isdir(work):
        import shutil
        shutil.rmtree(work)
    # the eval hook's model keeps the trained offsets, which need not leave
    # radius 1 (phase 4 perturbs them so that some DCN calls repair): 8
    # fused samples a batch and one more per DCN call that repairs
    expect = {(dcn_shift, 'launches'): 16, (dcn_shift, 'wgmma_launches'): 16,
              (dcn_shift, 'backward_launches'): 0,
              (oks_nms, 'launches'): 1, (gather, 'launches'): 3,
              (gather, 'backward_launches'): 0,
              (gather, 'sampler_launches'): (8, K4_SAMPLES[1])}
    counts = [(dcn_shift, 'launches'), (dcn_shift, 'backward_launches'),
              (dcn_shift, 'backward_tiled_launches'),
              (oks_nms, 'launches'), (gather, 'launches'),
              (gather, 'backward_launches'), (gather, 'sampler_launches')]
    for mod, attr in counts:
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    per_step = tpu_step()
    with TrainWatch(expect, per_step, profile_at=3).watching() as w:
        state = train_model(cfg, work_dir=work, max_steps=TRAIN_STEPS,
                            log_interval=2)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {count_label(k): getattr(*k) for k in counts}
    check(state.step == TRAIN_STEPS and len(w.steps) == TRAIN_STEPS,
          ('trainrun steps', state.step, len(w.steps)))
    check([s for s, _, _ in w.saves] == [4, TRAIN_STEPS],
          ('trainrun saves', w.saves))
    check(len(w.dcn) == 2, ('trainrun DCN-offset checks', w.dcn))
    check(len(w.evals) == 1 and len(w.evals[0]['batches']) == 2,
          ('trainrun eval hook', w.evals))
    labels = {count_label(k): n for k, n in expect.items()}
    for i, got in enumerate(w.evals[0]['batches']):
        check(all(n[0] <= got[k] <= n[1] if isinstance(n, tuple)
                  else got[k] == n for k, n in labels.items()),
              ('trainrun eval batch', i, got))
    text = ''.join(open(os.path.join(work, x)).read()
                   for x in os.listdir(work) if x.endswith('.log'))
    check('eval @ step 4: MPJPE' in text and 'dcn offsets @ step 4' in text,
          'trainrun: the eval and DCN lines missing from the log')
    ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')))
    check(ckpts == ['meta.json', 'step_00000004.pt', 'step_00000006.pt'],
          ('trainrun checkpoints', ckpts))
    phase('trainrun', f'train_model exp_panoptic_tpu, B=4 640x1344 bf16 on '
          f'f32 master weights from the disk mix: {TRAIN_STEPS} steps in '
          f'{secs:.1f} s (build, loader, saves, checks, eval included); '
          f'every loss finite; K4 launches {per_step[0]} + {per_step[1]} '
          f'and K1 {per_step[2]} + {per_step[3]} each step, no K3; losses '
          + ', '.join(f"{m['loss']:.5g}" for m in w.losses))
    # the profiler's overhead stretches the profiled step several times
    # over: its device busy time is held against the other steps' median
    plain = np.median([x for i, x in enumerate(w.steps) if i != w.profile_at])
    phase('trainrun', f'step ms from the disk loader (CUDA events) '
          + ', '.join(f'{x:.2f}' for x in w.steps)
          + f'; median of the unprofiled steps {plain:.2f} (phase 6 '
          f'synthetic median {synthetic_median:.2f}); host interval between '
          f'steps median {np.median(w.gap_ms):.2f} ms; step {w.profile_at} '
          f'under the profiler {w.profiled_ms:.2f} ms host, device busy '
          f'{w.busy_ms:.2f} ms, idle share against the median '
          f'{1 - w.busy_ms / plain:.3f}; {smi}')
    phase('trainrun', 'saves (step, ms, bytes): ' + '; '.join(
          f'{s}, {ms:.1f}, {n}' for s, ms, n in w.saves)
          + f"; DCN-offset checks {[(bool(a), bool(b), c) for a, b, c in w.dcn]}"
          + f"; eval hook {w.evals[0]['secs']:.2f} s, launches per batch "
          + '; '.join(', '.join(f'{v} {k}' for k, v in b.items())
                      for b in w.evals[0]['batches'])
          + f'; peak memory {peak:.2f} GiB (train step, eval model, pinned '
          f'ring); {smi}')

    # resume from the latest save for one step; the same step from the
    # first run's final state in memory on the same batch is the reference
    with TrainWatch(expect, per_step, resume_ref=state).watching() as r:
        again = train_model(cfg, work_dir=work, resume_from='latest',
                            max_steps=TRAIN_STEPS + 1, log_interval=2)
        torch.cuda.synchronize()
    check(again.step == TRAIN_STEPS + 1 and len(r.steps) == 1,
          ('trainrun resume', again.step, len(r.steps)))
    check(len(r.restored) == 1 and r.restored[0][0] == TRAIN_STEPS,
          ('trainrun restore', r.restored))
    worst = max(abs(r.losses[0][k] - v) / max(abs(v), 1e-12)
                for k, v in r.ref_losses.items() if 'loss' in k)
    check(worst <= RESUME_RTOL, ('trainrun resumed losses', worst,
                                 r.losses[0], r.ref_losses))
    phase('trainrun', f'resume from latest: step {TRAIN_STEPS} restored bit '
          f'for bit ({r.restored[0][1]} tensors, count and step); the '
          f'resumed step\'s losses within {worst:.3g} (<= {RESUME_RTOL:g}) '
          f'of the same step from the run\'s own final state on the same '
          f'batch; step {again.step} saved')
    del state, again
    torch.cuda.empty_cache()

    cli_work = os.path.join(TRAIN_DIR, 'cli')
    cmd = [sys.executable, '-m', 'das_tpu_torch.tools.train', SERVING_CFG,
           '--work-dir', cli_work, '--max-steps', '2', '--cfg-options'] + [
        f'{k}={v}' for k, v in opts.items()]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=300)
    secs = time.perf_counter() - t
    check(proc.returncode == 0 and
          '[das_tpu_torch] trained to step 2' in proc.stdout and
          os.path.exists(os.path.join(cli_work, 'ckpts',
                                      'step_00000002.pt')),
          ('das_tpu_torch.tools.train', proc.returncode,
           proc.stdout[-2000:], proc.stderr[-2000:]))
    phase('trainrun', f'python -m das_tpu_torch.tools.train '
          f'{os.path.relpath(SERVING_CFG, HERE)} --max-steps 2 --cfg-options'
          f' ...: exit 0 in {secs:.1f} s, step 2 saved')
    return launches, opts, float(plain)


# ------------------------------------------------------- 9. data parallel

DP_DIR = os.path.join(HERE, 'build', 'chip_smoke_dp')
# phase 8's 16 frames at a global batch of 4, 2 a rank, are one epoch
DP_STEPS = 4
DP_BATCH = 2
DP_RANK_TIMEOUT = 600
# the card the gloo ranks share (and the one-process reference's)
DP_DEVICE = 'cuda:0'
KERNEL_COUNTS = ('dcn_shift.launches', 'dcn_shift.backward_launches',
                 'conv_gn.launches',
                 'oks_nms.launches', 'gather.launches',
                 'gather.backward_launches', 'gather.sampler_launches')


def kernel_counts():
    """Every kernel's launch count in this process, by label."""
    from das_tpu_torch.ops import conv_gn, dcn_shift, gather, oks_nms
    mods = dict(dcn_shift=dcn_shift, conv_gn=conv_gn, oks_nms=oks_nms,
                gather=gather)
    return {k: getattr(mods[k.split('.')[0]], k.split('.')[1])
            for k in KERNEL_COUNTS}


def replica_mismatches(tensors, group):
    """Elements of ``tensors`` that differ from rank 0's copy (broadcast
    through the same flat buffers as ``replicate``)."""
    import torch
    import torch.distributed as dist
    from das_tpu_torch.parallel import mesh
    tensors = [t.detach() for t in tensors]
    copies = [t.clone() for t in tensors]
    src = dist.get_global_rank(group, 0)
    mesh._flat_collective(copies, lambda t: dist.broadcast(t, src=src,
                                                           group=group))
    return sum(int((a != b).sum()) for a, b in zip(copies, tensors))


def dp_parity_job(rank, group, dev, ref_path):
    """The cut fp32 step of ``dp_parity_reference`` on this rank's share of
    its B=4 batch, through the group path (TF32 off): the summed metrics,
    the state after it (rank 0) and the elements that differ from rank
    0's replica."""
    import torch
    import torch.distributed as dist
    from das_tpu_torch.tools.profile_train import make_trainer
    ref = torch.load(ref_path, weights_only=False)
    B, H, W = ref['batch']['img'].shape[:3]
    share = B // dist.get_world_size(group)
    state, step, _, max_pos = make_trainer(cut_train_cfg(), torch.float32,
                                           dev, share, (H, W), seed=3,
                                           group=group)
    state.model.load_state_dict(ref['sd0'], strict=True)
    batch = {k: torch.from_numpy(v[rank * share:(rank + 1) * share]).to(dev)
             for k, v in ref['batch'].items()}
    with no_tf32():
        state, metrics = step(state, batch)
    mom = state.opt_state['momentum']
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               max_pos=max_pos, mismatches=replica_mismatches(
                   [*state.model.state_dict().values(), *mom.values()],
                   group))
    if rank == 0:
        out.update(sd={k: v.cpu() for k, v in state.model.state_dict()
                       .items()}, momentum={k: v.cpu()
                                            for k, v in mom.items()})
    return out


def dp_train_job(rank, group, dev, opts, work):
    """``train_model`` on exp_panoptic_tpu from phase 8's mix on disk, this
    rank's DP_BATCH a step of the global batch, bf16 on f32 master weights,
    DP_STEPS steps (one epoch: the save, the DCN-offset check, the sharded
    eval hook). Each step: K4 and K1 ``tpu_step()`` times (with remat 24 +
    12 and 32 + 16), no K3, every metric finite, host ms around it (synchronised) and around its gradient
    all-reduce. Returns those, the run's launches, this rank's peak memory
    and its elements that differ from rank 0's replica."""
    import numpy as np
    import torch
    import das_tpu_torch.apis.train as train_api
    import das_tpu_torch.parallel.train_step as step_api
    from das_tpu_torch.apis import train_model
    from das_tpu_torch.config import Config
    cfg = Config.fromfile(SERVING_CFG)
    cfg.merge_from_dict(dict(opts, **{'data.samples_per_gpu': DP_BATCH}))
    real_make, real_reduce = train_api.make_train_step, \
        step_api.all_reduce_grads
    steps, reduce_ms, losses = [], [], []
    per_step = tpu_step()

    def timed_reduce(grads, group_):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        real_reduce(grads, group_)
        torch.cuda.synchronize(dev)
        reduce_ms.append((time.perf_counter() - t) * 1e3)

    def make(*a, **k):
        real = real_make(*a, **k)

        def counted(state, batch):
            before = kernel_counts()
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            state, metrics = real(state, batch)
            torch.cuda.synchronize(dev)
            steps.append((time.perf_counter() - t) * 1e3)
            after = kernel_counts()
            got = [after[k] - before[k] for k in (
                'gather.launches', 'gather.backward_launches',
                'dcn_shift.launches', 'dcn_shift.backward_launches',
                'oks_nms.launches')]
            check(got == list(per_step) + [0],
                  ('dataparallel step launches (K4, K4 backward, K1, K1 '
                   'backward, K3)', rank, state.step, got, per_step))
            m = {k: float(v) for k, v in metrics.items()}
            check(all(math.isfinite(v) for v in m.values()),
                  ('dataparallel step', rank, state.step, m))
            losses.append(m)
            return state, metrics
        return counted

    torch.cuda.reset_peak_memory_stats(dev)
    start = kernel_counts()
    train_api.make_train_step, step_api.all_reduce_grads = make, \
        timed_reduce
    try:
        state = train_model(cfg, work_dir=work, max_steps=DP_STEPS,
                            log_interval=2, device=dev, group=group)
        torch.cuda.synchronize(dev)
    finally:
        train_api.make_train_step, step_api.all_reduce_grads = real_make, \
            real_reduce
    end = kernel_counts()
    mism = replica_mismatches(
        [*state.model.state_dict().values(),
         *state.opt_state['momentum'].values()], group)
    return dict(step=state.step, steps_ms=steps, reduce_ms=reduce_ms,
                losses=losses, median_ms=float(np.median(steps)),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                launches={k: end[k] - start[k] for k in KERNEL_COUNTS},
                mismatches=mism, tensors=len(state.model.state_dict()))


def served_model(served_path, dev):
    """Phase 7's served exp_panoptic_tpu model (its bf16 state on disk) on
    ``dev``, in the config's DCN mode."""
    import torch
    from das_tpu_torch.apis import init_model
    model, _ = init_model(SERVING_CFG, dtype=torch.bfloat16, device=dev,
                          validate_dcn=False)
    model.load_state_dict(torch.load(served_path, map_location=dev),
                          strict=True)
    return model


def dp_eval_job(rank, group, dev, served_path, eval_data):
    """``run_test`` of phase 7's served model over the group: this rank
    sweeps frames rank, rank + W, ...; every rank returns all 8."""
    from das_tpu_torch.apis import run_test
    from das_tpu_torch.datasets import build_dataset
    cfg = eval_config(SERVING_CFG, *eval_data)
    return run_test(served_model(served_path, dev),
                    build_dataset(cfg.data['test']), cfg, batch_size=4,
                    progress=False, device_preprocess=True, group=group)


def dp_rank_main(rank, world, backend, devices, store, jobs, out):
    """A spawned rank: join the group through the FileStore at ``store``,
    run each job ``(name, fn, kwargs)`` as ``fn(rank, group, device,
    **kwargs)``, save the results to ``out.<rank>``; on an error save the
    traceback to ``out.<rank>.err`` and exit nonzero."""
    import traceback
    import torch
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, HERE)
    from das_tpu_torch.parallel import init_distributed
    try:
        dev = init_distributed('pytorch', backend, devices[rank],
                               init_method=f'file://{store}')
        results = {name: fn(rank, dist.group.WORLD, dev, **kw)
                   for name, fn, kw in jobs}
        torch.save(results, f'{out}.{rank}')
    except BaseException:
        with open(f'{out}.{rank}.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dp_spawn(tag, backend, devices, jobs):
    """Spawn one rank per entry of ``devices`` that runs ``jobs``; their
    results by rank. A rank that fails ends the others and the run."""
    import multiprocessing as mp
    import torch
    out = os.path.join(DP_DIR, f'{tag}.result')
    store = os.path.join(DP_DIR, f'{tag}.store')
    for f in os.listdir(DP_DIR):
        if f.startswith(f'{tag}.'):
            os.remove(os.path.join(DP_DIR, f))
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=dp_rank_main, args=(
        r, len(devices), backend, devices, store, jobs, out))
        for r in range(len(devices))]
    for p in procs:
        p.start()
    end = time.monotonic() + DP_RANK_TIMEOUT
    while any(p.is_alive() for p in procs) and time.monotonic() < end:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    errs = [open(os.path.join(DP_DIR, f)).read()[-3000:]
            for f in sorted(os.listdir(DP_DIR))
            if f.startswith(f'{tag}.result.') and f.endswith('.err')]
    check(codes == [0] * len(devices), (tag, 'ranks', codes, errs))
    return [torch.load(f'{out}.{r}', weights_only=False)
            for r in range(len(devices))]


def dp_parity_reference(path):
    """One process's cut fp32 step at B=4 128x160 on the card (TF32 off):
    the weights before it, its batch, metrics, momentum and weights after,
    saved to ``path`` for the ranks. Returns them and the lr schedule."""
    import torch
    from das_tpu_torch.tools.profile_train import (make_trainer,
                                                   synthetic_batch)
    cfg = cut_train_cfg()
    head = cfg.model.bbox_head
    B, H, W = 4, 128, 160
    state, step, lr_fn, max_pos = make_trainer(cfg, torch.float32,
                                               DP_DEVICE, B, (H, W), seed=3)
    sd0 = {k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    batch = synthetic_batch(B, H, W, int(head.num_joints),
                            int(head.root_idx), seed=1)
    with no_tf32():
        state, metrics = step(state, {k: torch.from_numpy(v).to(DP_DEVICE)
                                      for k, v in batch.items()})
    ref = dict(sd0=sd0, batch=batch, max_pos=max_pos,
               metrics={k: float(v) for k, v in metrics.items()},
               momentum={k: v.cpu()
                         for k, v in state.opt_state['momentum'].items()},
               sd={k: v.cpu() for k, v in state.model.state_dict().items()})
    torch.save(ref, path)
    return ref, lr_fn


def hold_step(got, ref, lr_fn, what):
    """A step through the group path against ``ref``'s one-process step
    from the same weights: metrics rtol 1e-4 (grad_norm 1e-3), each update
    (-lr * lr_mult * trainable * momentum) within CARD_CPU_RTOL of its
    leaf's largest (``leaves_close``), the weights within that plus one f32
    rounding, frozen weights unchanged. Returns the worst update error /
    tolerance (leaves, zero leaves)."""
    import torch
    from das_tpu_torch.models import build_trainable_model
    from das_tpu_torch.parallel import (frozen_mask, mspn_frozen_prefixes,
                                        param_groups)
    check(got['max_pos'] == ref['max_pos'], (what, 'max_pos'))
    for k, v in ref['metrics'].items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        check(abs(got['metrics'][k] - v) <= rtol * abs(v) + 1e-7,
              (what, 'metric', k, got['metrics'][k], v))
    cfg = cut_train_cfg()
    model = build_trainable_model(cfg.model, device='cpu')
    lr_mult, _ = param_groups(model)
    trainable = frozen_mask(model, mspn_frozen_prefixes(
        int(cfg.model.backbone.frozen_stages)))
    f = {k: -lr_fn(0) * lr_mult[k] * trainable[k] for k in trainable}
    worst, tol = leaves_close(
        {k: f[k] * m for k, m in got['momentum'].items()},
        {k: f[k] * m for k, m in ref['momentum'].items()}, (what, 'update'))
    for k in trainable:
        p = ref['sd'][k]
        check(bool(((got['sd'][k] - p).abs()
                    <= tol[k] + torch.finfo(torch.float32).eps * p.abs())
                   .all()), (what, 'weight after the step', k))
        if trainable[k] == 0.0:
            check(torch.equal(got['sd'][k], ref['sd0'][k]),
                  (what, 'frozen weight moved', k))
    return worst


@contextlib.contextmanager
def nccl_world_of_one():
    """A process group of this process alone over NCCL (through a FileStore
    under DP_DIR), on the card; the group within the block."""
    import torch.distributed as dist
    from das_tpu_torch.parallel import init_distributed
    store = os.path.join(DP_DIR, 'nccl1.store')
    if os.path.exists(store):
        os.remove(store)
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', LOCAL_WORLD_SIZE='1')
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dev = init_distributed('pytorch', 'nccl',
                               init_method=f'file://{store}')
        check(dist.get_backend() == 'nccl', 'NCCL world of one: backend')
        yield dist.group.WORLD, dev
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_full_width_nccl(group, dev):
    """One full-width B=4 640x1344 bf16 step of exp_panoptic_tpu through
    the group path over NCCL (the 266 MB gradient all-reduce, the BN
    all-reduces) beside the same step without a group from the same seed:
    K4's and K1's ``tpu_step()`` launches and finite metrics on both.
    Returns each loss term's relative difference (not held: at full depth a
    random-init train-mode forward amplifies the BN sums' order of
    summation, as it amplifies the card's and the CPU's rounding)."""
    import torch
    from das_tpu_torch.config import Config
    from das_tpu_torch.tools.profile_train import (make_trainer,
                                                   synthetic_batch,
                                                   train_pad_hw)
    cfg = Config.fromfile(SERVING_CFG)
    head = cfg.model.bbox_head
    H, W = train_pad_hw(cfg.train_pipeline)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        4, H, W, int(head.num_joints), int(head.root_idx)).items()}
    got = {}
    per_step = list(tpu_step())
    for name, g in (('none', None), ('nccl', group)):
        state, step, _, _ = make_trainer(cfg, torch.bfloat16, dev, 4, (H, W),
                                         group=g)
        before = kernel_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize(dev)
        after = kernel_counts()
        n = [after[k] - before[k] for k in (
            'gather.launches', 'gather.backward_launches',
            'dcn_shift.launches', 'dcn_shift.backward_launches')]
        m = {k: float(v) for k, v in metrics.items()}
        check(n == per_step and all(math.isfinite(v) for v in m.values()),
              ('full-width step', name, n, m))
        got[name] = m
        del state, step
        torch.cuda.empty_cache()
    return {k: abs(got['nccl'][k] - v) / max(abs(v), 1e-30)
            for k, v in got['none'].items() if 'loss' in k}


def dataparallel(eval_data, served_sd, served_outs, train_opts, median8,
                 smi):
    """Phase 9: the data-parallel path on the card. A NCCL group of this
    process alone (the cut fp32 step and a full-width bf16 step through
    the group path, ``run_test`` through it against phase 7's results);
    two ranks sharing the card over gloo (the cut fp32 step at W=2, B=2 a
    rank, against one process at B=4; ``train_model`` at full width for
    one epoch; the sharded ``run_test`` against phase 7's results); the CLI
    under ``torch.distributed.run``; and, with two cards or more,
    ``train_model`` over NCCL, one card a rank. Returns the per-rank
    launches of the gloo ``train_model`` run."""
    import shutil
    import numpy as np
    import torch
    from das_tpu_torch.apis import run_test
    from das_tpu_torch.datasets import build_dataset
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if os.path.isdir(DP_DIR):
        shutil.rmtree(DP_DIR)
    os.makedirs(DP_DIR)
    served_path = os.path.join(DP_DIR, 'served.pt')
    torch.save(served_sd, served_path)
    ref_path = os.path.join(DP_DIR, 'parity_ref.pt')
    ref, lr_fn = dp_parity_reference(ref_path)
    torch.cuda.empty_cache()
    phase('dataparallel', f'{cards} card(s): {torch.cuda.get_device_name(0)}'
          f'; {smi}; reference: one process, cut fp32 step, B=4 128x160, '
          f"max_pos {ref['max_pos']}")

    with nccl_world_of_one() as (group, dev):
        one = dp_parity_job(0, group, dev, ref_path)
        check(one['mismatches'] == 0, 'NCCL world of one: replica')
        w1 = hold_step(one, ref, lr_fn, 'NCCL world of one, cut step')
        torch.cuda.empty_cache()
        full = dp_full_width_nccl(group, dev)
        cfg = eval_config(SERVING_CFG, *eval_data)
        outs = run_test(served_model(served_path, dev),
                        build_dataset(cfg.data['test']), cfg, batch_size=4,
                        progress=False, device_preprocess=True, group=group)
        people, worst = people_agree(served_outs, outs,
                                     'run_test, NCCL world of one')
    torch.cuda.empty_cache()
    phase('dataparallel', f'NCCL world of one on the card: the cut fp32 '
          f'step through the group path vs group=None, metrics within '
          f'1e-4 (grad_norm 1e-3), updates within {w1[0]:.3g} of their '
          f'tolerance ({CARD_CPU_RTOL:g} of each leaf\'s largest; zero '
          f'leaves {w1[1]:.3g}); full width bf16 B=4 640x1344 step over '
          f'NCCL: K4, K1 launches {list(tpu_step())}, finite, loss terms '
          f'vs group=None '
          + ', '.join(f'{k} {v:.3g}' for k, v in full.items())
          + ' (relative, not held: full depth amplifies the order of the '
          f'BN sums); run_test through the group: {people} people, poses '
          f'within {worst:.3g} of phase 7\'s')

    work = os.path.join(DP_DIR, 'work')
    gloo = dp_spawn('gloo2', 'gloo', [DP_DEVICE, DP_DEVICE], [
        ('parity', dp_parity_job, dict(ref_path=ref_path)),
        ('train', dp_train_job, dict(opts=train_opts, work=work)),
        ('eval', dp_eval_job, dict(served_path=served_path,
                                   eval_data=eval_data))])
    par = [r['parity'] for r in gloo]
    check([p['mismatches'] for p in par] == [0, 0] and
          par[0]['metrics'] == par[1]['metrics'], 'W=2 cut step: replicas')
    w2 = hold_step(par[0], ref, lr_fn, 'W=2 gloo, cut step')
    tr = [r['train'] for r in gloo]
    check([t['step'] for t in tr] == [DP_STEPS] * 2 and
          all(len(t['steps_ms']) == DP_STEPS for t in tr),
          ('W=2 train_model steps', [t['step'] for t in tr]))
    check([t['mismatches'] for t in tr] == [0, 0],
          ('W=2 train_model: replicas differ', [t['mismatches'] for t in tr]))
    check(tr[0]['losses'] == tr[1]['losses'],
          'W=2 train_model: the ranks logged different metrics')
    ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')))
    check(ckpts == ['meta.json', f'step_{DP_STEPS:08d}.pt'],
          ('W=2 train_model checkpoints', ckpts))
    logs = [x for x in os.listdir(work) if x.endswith('.log')]
    text = ''.join(open(os.path.join(work, x)).read() for x in logs)
    check(len(logs) == 1 and f'eval @ step {DP_STEPS}: MPJPE' in text and
          f'dcn offsets @ step {DP_STEPS}' in text,
          ('W=2 train_model: rank 0\'s log', logs))
    per_step = tpu_step()
    for t in tr:
        n = t['launches']
        check(n['dcn_shift.launches'] > 0 and n['oks_nms.launches'] > 0 and
              n['gather.launches'] > 0 and
              n['gather.backward_launches'] == per_step[1] * DP_STEPS and
              n['dcn_shift.backward_launches'] == per_step[3] * DP_STEPS and
              n['gather.sampler_launches'] > 0,
              ('W=2 train_model launches', n))
    evals = [r['eval'] for r in gloo]
    people2, worst2 = people_agree(served_outs, evals[0],
                                   'run_test, 2 ranks over gloo')
    for a, b in zip(*evals):
        check(all(np.array_equal(a[k], b[k]) for k in ('poses', 'centers'))
              and a['scores'] == b['scores'], 'run_test: the ranks differ')
    phase('dataparallel', f'2 ranks on the one card over gloo: the cut fp32 '
          f'step at B=2 a rank vs one process at B=4, metrics within 1e-4 '
          f'(grad_norm 1e-3), updates within {w2[0]:.3g} of their '
          f'tolerance (zero leaves {w2[1]:.3g}), replicas bit-equal; '
          f'train_model exp_panoptic_tpu at B={DP_BATCH} a rank (global '
          f'{2 * DP_BATCH}) 640x1344 bf16, {DP_STEPS} steps: every loss '
          f'finite, K4 {per_step[0]} + {per_step[1]} and K1 {per_step[2]} '
          f'+ {per_step[3]} a step on each rank, '
          f"{tr[0]['tensors']} tensors and the momentum bit-equal across "
          f'ranks, one checkpoint ({ckpts[1]}), the eval hook and DCN check '
          f'in rank 0\'s log; losses '
          + ', '.join(f"{m['loss']:.5g}" for m in tr[0]['losses'])
          + f'; sharded run_test: {people2} people, poses within '
          f"{worst2:.3g} of phase 7's, both ranks' lists equal")
    phase('dataparallel', f'step ms at W=2 over gloo (host clock, '
          f'synchronised; harness numbers, gloo stages CUDA tensors through '
          f'the host): rank 0 ' + ', '.join(f'{x:.1f}' for x in
                                            tr[0]['steps_ms'])
          + f"; medians {tr[0]['median_ms']:.2f} / {tr[1]['median_ms']:.2f}"
          f' ms beside phase 8\'s one card at B=4 {median8:.2f} ms; '
          f'gradient all-reduce ms a step (266 MB, 2 flat buffers) median '
          f"{np.median(tr[0]['reduce_ms']):.2f} / "
          f"{np.median(tr[1]['reduce_ms']):.2f}; peak memory "
          f"{tr[0]['peak_gib']:.2f} / {tr[1]['peak_gib']:.2f} GiB a rank; "
          f'launches a rank ' + '; '.join(
              ', '.join(f'{v} {k}' for k, v in t['launches'].items() if v)
              for t in tr))

    cli_work = os.path.join(DP_DIR, 'cli')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc-per-node', '2', '-m', 'das_tpu_torch.tools.train',
           SERVING_CFG, '--work-dir', cli_work, '--launcher', 'pytorch',
           '--dist-backend', 'gloo', '--device', DP_DEVICE, '--max-steps',
           '2', '--cfg-options', f'data.samples_per_gpu={DP_BATCH}'] + [
        f'{k}={v}' for k, v in train_opts.items()]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=400)
    secs = time.perf_counter() - t
    check(proc.returncode == 0 and
          '[das_tpu_torch] trained to step 2 on 2 rank(s)' in proc.stdout
          and os.path.exists(os.path.join(cli_work, 'ckpts',
                                          'step_00000002.pt')),
          ('torchrun das_tpu_torch.tools.train', proc.returncode,
           proc.stdout[-2000:], proc.stderr[-3000:]))
    phase('dataparallel', f'python -m torch.distributed.run --standalone '
          f'--nproc-per-node 2 -m das_tpu_torch.tools.train '
          f'{os.path.relpath(SERVING_CFG, HERE)} --launcher pytorch '
          f'--dist-backend gloo --device cuda:0 --max-steps 2: exit 0 in '
          f'{secs:.1f} s, step 2 saved by rank 0')

    if cards >= 2:
        nccl = dp_spawn('nccl2', 'nccl', [None, None], [
            ('train', dp_train_job, dict(
                opts=train_opts, work=os.path.join(DP_DIR, 'work_nccl')))])
        tn = [r['train'] for r in nccl]
        check([t['mismatches'] for t in tn] == [0, 0] and
              [t['step'] for t in tn] == [DP_STEPS] * 2,
              ('NCCL train_model', [t['mismatches'] for t in tn]))
        phase('dataparallel', f'train_model over NCCL, one card a rank: '
              f'{DP_STEPS} steps, replicas bit-equal; step medians '
              f"{tn[0]['median_ms']:.2f} / {tn[1]['median_ms']:.2f} ms, "
              f"gradient all-reduce {np.median(tn[0]['reduce_ms']):.2f} ms")
    else:
        phase('dataparallel', f'train_model over NCCL with one card a rank: '
              f'not run, this host has {cards} card (NCCL takes one rank a '
              f'card)')
    phase('dataparallel', f'phase 9 in {time.perf_counter() - t0:.1f} s')
    return [t['launches'] for t in tr]


# ------------------------------------------------------------- 10. tools

TOOLS_DIR = os.path.join(HERE, 'build', 'chip_smoke_tools')
# the card the phase runs on (the CPU runs of the demo and validate_hybrid
# are its references)
TOOLS_DEVICE = 'cuda'
# validate_hybrid's max|off| on the card against the CPU, relative
VALIDATE_RTOL = 1e-5


def warp_reference(src, trans, out_hw, border):
    """cv2.warpAffine's INTER_LINEAR with a constant border, exactly, in
    float64: (the warped image, the mask of output pixels whose four taps
    all lie inside the source)."""
    import numpy as np
    (a, b, c), (d, e, f) = np.asarray(trans, np.float64)[:2]
    det = a * e - b * d
    h, w = src.shape[:2]
    ys, xs = np.mgrid[0:out_hw[0], 0:out_hw[1]].astype(np.float64)
    sx = (e * (xs - c) - b * (ys - f)) / det
    sy = (-d * (xs - c) + a * (ys - f)) / det
    x0, y0 = np.floor(sx), np.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    pad = np.empty((h + 2, w + 2, 3), np.float64)
    pad[:] = np.asarray(border, np.float64)
    pad[1:-1, 1:-1] = src
    # every tap outside the frame reads the border: clip to one past it
    xi, xj = (np.clip(x, -1, w).astype(np.int64) + 1 for x in (x0, x0 + 1))
    yi, yj = (np.clip(y, -1, h).astype(np.int64) + 1 for y in (y0, y0 + 1))
    out = ((pad[yi, xi] * (1 - wx) + pad[yi, xj] * wx) * (1 - wy)
           + (pad[yj, xi] * (1 - wx) + pad[yj, xj] * wx) * wy)
    inside = (x0 >= 0) & (x0 + 1 <= w - 1) & (y0 >= 0) & (y0 + 1 <= h - 1)
    return out, inside


def host_library_vs_cv2(smi):
    """The port's C++ host library (``datasets/native.py``) on a smooth
    1920x1080 float32 frame (a 27x48 random grid upsampled bilinearly, as
    smooth as a camera's): the resize to the serving scale (640x1138)
    within 0.51 of ``cv2.resize``, the native tests' tolerance; the
    training warp (GlobalRotScaleTransPose's affine at a 20 degree rotation,
    scale 1.1, the config's border) within 1e-3 of the exact warp in
    float64 everywhere, and within 0.5 of ``cv2.warpAffine`` where all four
    taps lie inside the frame. cv2 4.x rounds each sample position to 1/32
    of a pixel, so at the frame's edge, where the border colour meets the
    image, it is off the exact warp by more (printed, not held). Each is
    timed beside cv2 (host clock, median of 5)."""
    import cv2
    import numpy as np
    from das_tpu_torch.datasets import native
    from das_tpu_torch.datasets.pipelines import get_affine_transform
    check(native.available(), 'the host library did not load')
    rng = np.random.RandomState(0)
    src = cv2.resize((rng.rand(27, 48, 3) * 255).astype(np.float32),
                     (1920, 1080), interpolation=cv2.INTER_LINEAR)
    trans = get_affine_transform(np.array([960.0, 540.0]) * 1.05,
                                 np.array([1920.0, 1080.0]) * 1.1, 20.0,
                                 [1920, 1080])
    border = [103.53, 116.28, 123.675]
    resized = native.resize_bilinear(src, (640, 1138))
    err = float(np.abs(resized - cv2.resize(
        src, (1138, 640), interpolation=cv2.INTER_LINEAR)).max())
    check(err <= 0.51, ('host library resize vs cv2', err))
    warped = native.affine_warp(src, trans, (1080, 1920), border)
    exact, inside = warp_reference(src, trans, (1080, 1920), border)
    vs_exact = float(np.abs(warped - exact).max())
    diff = np.abs(warped - cv2.warpAffine(
        src, trans, (1920, 1080), flags=cv2.INTER_LINEAR,
        borderValue=border)).max(-1)
    vs_cv2, edge = float(diff[inside].max()), float(diff.max())
    check(vs_exact <= 1e-3 and vs_cv2 <= 0.5,
          ('host library warp', vs_exact, vs_cv2))
    ms = {}
    for name, fn in (
            ('native resize', lambda: native.resize_bilinear(src,
                                                             (640, 1138))),
            ('cv2 resize', lambda: cv2.resize(
                src, (1138, 640), interpolation=cv2.INTER_LINEAR)),
            ('native warp', lambda: native.affine_warp(
                src, trans, (1080, 1920), border)),
            ('cv2 warp', lambda: cv2.warpAffine(
                src, trans, (1920, 1080), flags=cv2.INTER_LINEAR,
                borderValue=border))):
        runs = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t) * 1e3)
        ms[name] = float(np.median(runs))
    phase('tools', f'host library (g++ -O3 -march=native, '
          f'{native.so_path().name}), a smooth 1920x1080 float32 frame: '
          f'resize to 640x1138 within {err:.3g} of cv2 '
          f'{cv2.__version__}; warp within {vs_exact:.3g} of the exact '
          f'float64 warp, within {vs_cv2:.3g} of cv2 inside the frame '
          f'({edge:.3g} at its edge); host clock, median of 5, ms a frame: '
          + ', '.join(f'{k} {v:.2f}' for k, v in ms.items()) + f'; {smi}')
    return ms


def demo_people(res):
    """The demo's JSON -> run_test's per-image dict, for people_agree."""
    import numpy as np
    people = res['people']
    return [dict(scores=[p['score'] for p in people], poses=np.array(
        [p['joints_uvd'] for p in people], np.float32).reshape(-1, EVAL_J,
                                                             3))]


def run_cli(tool, argv):
    """A port CLI's ``main(argv)`` in this process: (stdout, exit code)."""
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = tool.main(argv)
    return out.getvalue(), code


def demo_on_card_and_cpu(ckpt, expect):
    """``python -m das_tpu_torch.tools.demo`` on exp_panoptic_tpu with
    phase 7's weights, a synthetic 640x480 frame (resized to 853x640,
    padded to 864x640), ``--score-thr`` at the config's decode threshold
    (every decoded person is listed): in bf16 on the card as a user runs it, the request
    launching exactly its share of ``expect`` (as phase 4's, counted around
    the CLI's predict call); then in f32 on the card (TF32 off) and on the
    CPU, whose people must agree (people_agree). Returns (the CLI's
    launches over its bf16 run, counts set to 0 just before and read just
    after, the f32 card run's launches, seconds of the three runs)."""
    import cv2
    import numpy as np
    import das_tpu_torch.apis.inference as inf_api
    from das_tpu_torch.tools import demo
    rng = np.random.RandomState(4)
    blocks = rng.randint(0, 256, (480 // 40 + 1, 640 // 40 + 1, 3))
    frame = np.kron(blocks, np.ones((40, 40, 1), np.int64))[:480, :640]
    frame = (frame + rng.randint(0, 16, (480, 640, 3))).clip(0, 255)
    img = os.path.join(TOOLS_DIR, 'frame_640x480.png')
    cv2.imwrite(img, frame.astype(np.uint8))
    from das_tpu_torch.config import Config
    thr = str(Config.fromfile(SERVING_CFG).model.test_cfg.score_thr)
    real = inf_api.make_predict_fn
    requests = []

    def counted(*args, **kwargs):
        predict = real(*args, **kwargs)

        def call(*a):
            before = {key: getattr(*key) for key in expect}
            out = predict(*a)
            requests.append({count_label(key): getattr(*key) - before[key]
                             for key in expect})
            return out
        return call

    out = {}
    secs = {}
    inf_api.make_predict_fn = counted
    try:
        for name, dev, dtype in (('bf16', TOOLS_DEVICE, 'bfloat16'),
                                 ('f32', TOOLS_DEVICE, 'float32'),
                                 ('cpu', 'cpu', 'float32')):
            argv = [SERVING_CFG, ckpt, img, '--device', dev, '--dtype',
                    dtype, '--score-thr', thr, '--out',
                    os.path.join(TOOLS_DIR, f'demo_{name}.png')]
            for mod, attr in expect:
                setattr(mod, attr, 0)
            t = time.perf_counter()
            with no_tf32() if name == 'f32' else contextlib.nullcontext():
                text, code = run_cli(demo, argv)
            secs[name] = time.perf_counter() - t
            check(code == 0, ('demo', name, code))
            out[name] = (json.loads(text[:text.rindex('}') + 1]),
                         {count_label(key): getattr(*key)
                          for key in expect})
    finally:
        inf_api.make_predict_fn = real
    labels = {count_label(k): n for k, n in expect.items()}
    got = requests[0]
    check(len(requests) == 3 and all(
        n[0] <= got[k] <= n[1] if isinstance(n, tuple) else got[k] == n
        for k, n in labels.items())
        and sum(v for k, v in got.items() if 'gather' in k)
        <= K4_PER_REQUEST, ('demo request launches', requests))
    check(requests[2] == {k: 0 for k in labels},
          ('the CPU demo launched a kernel', requests[2]))
    bf16 = out['bf16'][0]
    check(bf16['num_people'] > 0 and all(
        np.isfinite(p['joints_uvd']).all() for p in bf16['people']),
        ('demo bf16 people', bf16['num_people']))
    people, worst = people_agree(demo_people(out['cpu'][0]),
                                 demo_people(out['f32'][0]),
                                 'demo card vs CPU')
    check(people > 0, 'demo card vs CPU: no person above the threshold')
    phase('tools', f'python -m das_tpu_torch.tools.demo exp_panoptic_tpu '
          f'(phase 7 weights) on a 640x480 frame (-> 853x640, padded '
          f'864x640): bf16 on the card {bf16["num_people"]} people, the '
          f'request launched ' + ', '.join(f'{v} {k}' for k, v in got.items())
          + f' (the CLI in all: {out["bf16"][1]}); f32 card vs CPU: '
          f'{people} people on both, scores within {EVAL_SCORE_TOL:g}, '
          f'poses within {worst:.3g} (<= {EVAL_POSE_RTOL:g}); seconds '
          f'(build, load, DCN check, request) bf16 {secs["bf16"]:.1f}, f32 '
          f'card {secs["f32"]:.1f}, CPU {secs["cpu"]:.1f}')
    return out['bf16'][1], out['f32'][1], secs


def validate_on_card_and_cpu(ckpt):
    """``python -m das_tpu_torch.tools.validate_hybrid`` on the card and
    with ``--device cpu``, phase 7's weights (perturb_offsets' seeded
    conv_offset fields), B=2 256x320 RandomState(0) inputs, radius 1: the
    same flagged pixels per layer and level, max|off| within VALIDATE_RTOL
    relative (the rows the CLI computed, at full precision), the same exit
    code."""
    import das_tpu_torch.apis.inference as inf_api
    from das_tpu_torch.tools import validate_hybrid
    real = inf_api.dcn_offset_table
    rows = {}
    codes = {}
    for dev in (TOOLS_DEVICE, 'cpu'):
        def capture(*a, dev=dev):
            rows[dev] = real(*a)
            return rows[dev]
        inf_api.dcn_offset_table = capture
        try:
            text, codes[dev] = run_cli(validate_hybrid, [
                '--config', SERVING_CFG, '--ckpt', ckpt, '--height', '256',
                '--width', '320', '--radius', '1', '--device', dev])
        finally:
            inf_api.dcn_offset_table = real
    got, want = rows[TOOLS_DEVICE], rows['cpu']
    check(len(got) == len(want) == 16 and sum(r[2] for r in want) > 0,
          ('validate_hybrid rows', len(got), len(want)))
    worst = 0.0
    for g, w in zip(got, want):
        check(g[0] == w[0] and g[2] == w[2], ('validate_hybrid row', g, w))
        worst = max(worst, abs(g[1] - w[1]) / max(abs(w[1]), 1e-12))
    check(worst <= VALIDATE_RTOL and codes[TOOLS_DEVICE] == codes['cpu'],
          ('validate_hybrid card vs CPU', worst, codes))
    phase('tools', f'python -m das_tpu_torch.tools.validate_hybrid (phase 7 '
          f'weights, B=2 256x320, radius 1): card and CPU flag the same '
          f'pixels in each of 16 DCN calls ({sum(r[2] for r in got)} in '
          f'all), max|off| within {worst:.3g} relative (<= '
          f'{VALIDATE_RTOL:g}), exit {codes["cpu"]} on both')


def checkpoint_tools(ckpt_dir):
    """Phase 8's checkpoint directory through ``export_torch`` (the latest
    step), ``publish_model`` and ``fuse_conv_bn``, on the card; each file
    loads strictly with ``init_model``."""
    import torch
    from das_tpu_torch.apis import init_model
    from das_tpu_torch.tools import export_torch, fuse_conv_bn, publish_model
    exported = os.path.join(TOOLS_DIR, 'exported.pth')
    text, code = run_cli(export_torch, [SERVING_CFG, ckpt_dir, exported,
                                        '--device', TOOLS_DEVICE])
    check(code == 0, ('export_torch', text))
    text, code = run_cli(publish_model, [exported, os.path.join(
        TOOLS_DIR, 'published.pth')])
    published = text.split()[-1]
    check(code == 0 and os.path.exists(published), ('publish_model', text))
    fused = os.path.join(TOOLS_DIR, 'fused.pth')
    text, code = run_cli(fuse_conv_bn, [SERVING_CFG, published, fused,
                                        '--device', TOOLS_DEVICE])
    pairs = [ln for ln in text.splitlines() if ln.startswith('fused ')]
    check(code == 0 and pairs, ('fuse_conv_bn', text))
    for path in (exported, published, fused):
        init_model(SERVING_CFG, path, device=TOOLS_DEVICE)
    ckpt = torch.load(published, map_location='cpu', weights_only=False)
    check(not set(ckpt) & {'optimizer', 'momentum', 'count', 'step'},
          ('publish_model kept training state', sorted(ckpt)))
    phase('tools', f'phase 8\'s checkpoints -> export_torch (latest step) -> '
          f'publish_model ({os.path.basename(published)}) -> fuse_conv_bn '
          f'({pairs[0]}): each loads strictly with init_model on the card')


def traced_request(ckpt):
    """One bf16 request of the demo's frame under
    ``utils/profiling.trace``: the Chrome trace it writes names K1's
    kernel. Returns (trace file, its kernel events named after K1)."""
    import glob
    import cv2
    import torch
    from das_tpu_torch.apis import init_model, make_predict_fn
    from das_tpu_torch.tools import demo
    from das_tpu_torch.utils import profiling
    model, cfg = init_model(SERVING_CFG, ckpt, dtype=torch.bfloat16,
                            device=TOOLS_DEVICE)
    head = cfg.model.bbox_head
    predict = make_predict_fn(model, cfg.model.test_cfg, head.num_joints,
                              head.strides, device=TOOLS_DEVICE)
    padded, sf = demo.preprocess(cv2.imread(os.path.join(
        TOOLS_DIR, 'frame_640x480.png')))
    x = torch.from_numpy(padded)[None].to(TOOLS_DEVICE)
    sf = torch.from_numpy(sf).to(TOOLS_DEVICE)
    predict(x, sf)
    log_dir = os.path.join(TOOLS_DIR, 'trace')
    if os.path.isdir(log_dir):
        import shutil
        shutil.rmtree(log_dir)
    with profiling.trace(log_dir):
        with profiling.annotate('demo_request'):
            predict(x, sf)
    files = glob.glob(os.path.join(log_dir, '*.pt.trace.json'))
    check(len(files) == 1, ('profiling.trace files', files))
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    k1 = [e for e in events if e.get('cat') == 'kernel'
          and 'dcn_shift' in e.get('name', '')]
    check(len(k1) == 16 and any(e.get('name') == 'demo_request'
                                for e in events),
          ('the trace does not name K1 16 times', len(k1)))
    phase('tools', f'utils/profiling.trace of one demo request: '
          f'{os.path.relpath(files[0], HERE)} ({os.path.getsize(files[0])} '
          f'bytes), {len(k1)} K1 kernel events '
          f'("{k1[0]["name"][:60] if k1 else ""}"), '
          f'{sum(e.get("dur", 0) for e in k1):.1f} us of K1 in all')


def tools(served_sd, expect, smi):
    """Phase 10: the host library, the demo and validate_hybrid CLIs card
    against CPU, the checkpoint tools on phase 8's checkpoints, and one
    traced request. Returns the launches of the demo's bf16 CLI run and of
    its f32 card run, added together."""
    import torch
    t0 = time.perf_counter()
    os.makedirs(TOOLS_DIR, exist_ok=True)
    host_library_vs_cv2(smi)
    ckpt = os.path.join(TOOLS_DIR, 'served.pth')
    torch.save(dict(state_dict={k: v.float() for k, v in served_sd.items()},
                    meta={}), ckpt)
    bf16, f32, _ = demo_on_card_and_cpu(ckpt, expect)
    validate_on_card_and_cpu(ckpt)
    checkpoint_tools(os.path.join(TRAIN_DIR, 'work', 'ckpts'))
    traced_request(ckpt)
    torch.cuda.empty_cache()
    phase('tools', f'phase 10 in {time.perf_counter() - t0:.1f} s')
    return {k: bf16[k] + f32[k] for k in bf16}


# ----------------------------------------- 11-15. the reference's recipes

PANOPTIC_CFG = os.path.join(HERE, 'configs', 'das', 'exp_panoptic.py')
MUPOTS_CFG = os.path.join(HERE, 'configs', 'das', 'exp_mupots.py')
RECIPES_DIR = os.path.join(HERE, 'build', 'chip_smoke_recipes')
# exp_mupots's test bucket: a 1920x1080 MuPoTS-3D frame at its test scale
# (1280, 768), ratio kept (1280x720), padded to a multiple of 32
MUPOTS_HW = (736, 1280)
MUPOTS_F = 1500.0
# exp_mupots's train bucket: the largest of its ResizePose scales
# (1280, 800), padded to a multiple of 32
MUPOTS_TRAIN_HW = (800, 1280)
MUPOTS_TRAIN_STEPS = 3
# phase 15: train_run.py on exp_panoptic_tpu from disk, 2 epochs
RUN_STEPS = 40
RUN_IMAGES = 80


def serve_launches(cfg, hw):
    """(row gathers, fused samples) of one served B=4 request of an
    exact-gather ('patch') config at the ``hw`` bucket, derived from the
    model code: every DCN call (the 3 towers' last convs and each RU
    layer's update conv at 4 levels) one fused sample of its nine taps;
    each RU layer but the last two samples a level; the last, at a level
    of more than ``nms_pre`` points, the grouped take_at and two samples,
    else two samples."""
    head = cfg.model.bbox_head
    check(head.get('dcn_gather_mode', 'patch') == 'patch',
          'serve_launches counts the exact gather only')
    layers = int(head.recursive_update.get('num_layers', 1))
    nms_pre = int(cfg.model.test_cfg.nms_pre)
    sparse = bool(cfg.model.test_cfg.get('sparse_refine'))
    big = [(hw[0] // (4 * 2 ** i)) * (hw[1] // (4 * 2 ** i)) > nms_pre
           for i in range(4)]
    gathers = sum(big) if sparse else 0
    return gathers, (12 + 4 * layers) + 8 * layers


def recipe_expect(cfg, hw):
    """main_path's and eval's per-request counts of a 'patch' config: no K1
    or K2, one K3 (the decode's), ``serve_launches``'s K4."""
    from das_tpu_torch.ops import conv_gn, dcn_shift, gather, oks_nms
    gathers, samples = serve_launches(cfg, hw)
    return {(dcn_shift, 'launches'): 0, (dcn_shift, 'wgmma_launches'): 0,
            (dcn_shift, 'backward_launches'): 0, (conv_gn, 'launches'): 0,
            (oks_nms, 'launches'): 1, (gather, 'launches'): gathers,
            (gather, 'backward_launches'): 0,
            (gather, 'sampler_launches'): samples}


def panoptic_serving():
    """Phase 11 ("panoptic"): configs/das/exp_panoptic.py, the reference's
    Panoptic recipe, served: 3 B=4 640x1152 bf16 requests through
    ``make_predict_fn`` (every DCN the exact 'patch' gather: one fused
    sample of nine taps a call, no K1), each request's launches as
    ``serve_launches`` derives them; then its kernel path against the
    CPU's plain path at 128x160 fp32. Returns the requests' launches."""
    from das_tpu_torch.config import Config
    expect = recipe_expect(Config.fromfile(PANOPTIC_CFG), (640, 1152))
    model, _, n, _, _ = main_path(PANOPTIC_CFG, 3, expect)
    del model
    kernel_path_vs_plain_path(PANOPTIC_CFG, (0, 0))
    return n


def panoptic_training():
    """Phase 12 ("train"): exp_panoptic's train step, its 'clip' DCNs (K4's
    row gather and adjoint at every DCN), at B=4 640x1344 bf16 on f32
    master weights: ``train_full_width`` (3 steps and one profiled step:
    step ms, peak memory, device busy ms; K4's launches a step as
    ``train_step_launches`` derives them under the head's remat, no K1),
    then its gradient pass with K4 against K4's plain pair on the card
    (``train_k4_vs_plain_on_card``). Returns the steps' (forward,
    backward) K4 launches."""
    import torch
    (fwd, bwd), (k1, k1b), run = train_full_width(3, PANOPTIC_CFG,
                                                  profile=True)
    check(k1 == k1b == 0, ('exp_panoptic trains no K1', k1, k1b))
    train_k4_vs_plain_on_card(run, ('bf16',))
    phase('train', f"exp_panoptic B=4 640x1344 bf16 ('clip'): steps "
          + ', '.join(f'{t:.2f}' for t in run['step_ms'])
          + f" ms, peak memory {run['peak_gib']:.2f} GiB, device busy "
          f"{run['busy_ms']:.2f} ms a step; K4 {run['per_step'][0]} + "
          f"{run['per_step'][1]} a step")
    del run
    torch.cuda.empty_cache()
    return fwd, bwd


def write_mupots_data(n_seq=20, people=2, h=1080, w=1920, seed=0):
    """One synthetic MuPoTS-3D frame per sequence TS1..TS20 (an h x w JPEG
    ``TS{k}/img_000000.jpg``, the names the evaluator reads) and the
    annotations in the reference's layout (tests/test_mupots_evaluate.py):
    a COCO json with ``intrinsic`` and 21 image/camera joints a person, and
    ``TS{k}/annot.mat`` + ``occlusion.mat`` (MATLAB cell arrays of
    annot2/annot3/univ_annot3/isValidFrame structs, ``scipy.io.savemat``).
    Returns the data root."""
    import cv2
    import numpy as np
    import scipy.io as sio
    root = os.path.join(RECIPES_DIR, 'mupots')
    rng = np.random.RandomState(seed)
    images, anns = [], []
    cx, cy = w / 2, h / 2
    for ts in range(n_seq):
        seq = os.path.join(root, f'TS{ts + 1}')
        os.makedirs(seq, exist_ok=True)
        rel = f'TS{ts + 1}/img_000000.jpg'
        cv2.imwrite(os.path.join(root, rel), block_frame(rng, h, w))
        images.append(dict(id=ts + 1, file_name=rel, width=w, height=h,
                           intrinsic=[MUPOTS_F, MUPOTS_F, cx, cy]))
        cell = np.empty((1, people), object)
        occ = np.empty((1, people), object)
        for p in range(people):
            base = np.array([(p - 0.5) * 900.0, rng.uniform(-150, 150),
                             rng.uniform(2500, 3500)])
            annot3 = base[:, None] + rng.uniform(-350, 350, (3, 17))
            annot3[2] = np.maximum(annot3[2], 1500.0)
            u = MUPOTS_F * annot3[0] / annot3[2] + cx
            v = MUPOTS_F * annot3[1] / annot3[2] + cy
            s = np.zeros((1, 1), dtype=[
                ('annot2', 'O'), ('annot3', 'O'), ('univ_annot3', 'O'),
                ('isValidFrame', 'O')])
            s[0, 0] = (np.stack([u, v]), annot3, annot3.copy(),
                       np.array([[1]]))
            cell[0, p] = s
            occ[0, p] = np.zeros((1, 17))
            img = np.concatenate([np.stack([u, v], 1),
                                  np.stack([u, v], 1)[:4]])
            cam = np.concatenate([annot3.T, annot3.T[:4]])
            bbox = [float(u.min()), float(v.min()), float(np.ptp(u)),
                    float(np.ptp(v))]
            anns.append(dict(
                id=len(anns) + 1, image_id=ts + 1, category_id=1, iscrowd=0,
                bbox=bbox, area=bbox[2] * bbox[3],
                keypoints_img=img.tolist(), keypoints_cam=cam.tolist(),
                keypoints_vis=[1] * 21))
        sio.savemat(os.path.join(seq, 'annot.mat'), {'annotations': cell})
        sio.savemat(os.path.join(seq, 'occlusion.mat'),
                    {'occlusion_labels': occ})
    os.makedirs(os.path.join(root, 'annotations'), exist_ok=True)
    dump_coco_json(os.path.join(root, 'annotations', 'MuPoTS-3D.json'),
                   images, anns)
    return root


def mupots_serving():
    """Phase 13 ("mupots"): configs/das/exp_mupots.py, the paper's
    MuCo-3DHP + COCO recipe (21 joints, root 14, a 3-stage MSPN2, two RU
    layers of which the last sparsifies, nms_thr 0.9), served: 3 B=4
    736x1280 bf16 requests (its test bucket) with ``serve_launches``'s
    launches each, K3 at J=21; ``run_test`` with device preprocessing over
    a synthetic MuPoTS-3D set (``write_mupots_data``: 20 frames, 5 batches
    of B=4, each with the request's launches) and the MuPoTS evaluator:
    3DPCK of the card's outputs (random weights: near 0, finite); then its
    kernel path against the CPU's plain path at 128x160 fp32, full depth
    (the eval forward is well conditioned: a one-ulp change of every weight
    moves its head outputs by 6.6e-6 on the CPU, as exp_panoptic_tpu's by
    7.3e-6). Returns the requests' and the sweep's launches."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import run_test
    from das_tpu_torch.config import Config
    from das_tpu_torch.datasets import build_dataset
    from das_tpu_torch.tools.profile_kernels import pose_template
    cfg = Config.fromfile(MUPOTS_CFG)
    expect = recipe_expect(cfg, MUPOTS_HW)
    model, _, n, _, _ = main_path(MUPOTS_CFG, 3, expect, hw=MUPOTS_HW)
    root = write_mupots_data()
    cfg.merge_from_dict({
        'data.test.data_root': root, 'data.test.num_workers': 4,
        'data.test.ann_file': os.path.join(root, 'annotations',
                                           'MuPoTS-3D.json')})
    ds = build_dataset(cfg.data['test'])
    pose_template(model)
    with per_batch_counts(model, expect) as batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = run_test(model, ds, cfg, batch_size=4, progress=False,
                        device_preprocess=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    labels = {count_label(k): v for k, v in expect.items()}
    check(len(batches) == len(ds) // 4 and all(b == labels for b in batches),
          ('exp_mupots eval batches launches', batches, labels))
    people = [len(o['poses']) for o in outs]
    check(sum(people) > 0 and all(
        np.isfinite(o['poses']).all() and o['poses'].shape[1:] == (21, 3)
        for o in outs), ('exp_mupots sweep poses', people))
    t = time.perf_counter()
    res = ds.evaluate(outs)
    ev_secs = time.perf_counter() - t
    check(np.isfinite(res['pck_mean']) and np.isfinite(res['pck_mean_abs'])
          and sum(k.startswith('pck_TS') for k in res) == 20,
          ('exp_mupots 3DPCK', {k: res[k] for k in list(res)[:4]}))
    sweep = {k: sum(b[k] for b in batches) for k in labels}
    phase('mupots', f'run_test(device_preprocess=True) over {len(ds)} '
          f'synthetic MuPoTS-3D 1920x1080 JPEGs (TS1-TS20), '
          f'{len(batches)} batches of B=4 {MUPOTS_HW[0]}x{MUPOTS_HW[1]} '
          f'bf16 in {secs:.2f} s ({len(ds) / secs:.2f} images/s); people '
          f'per image {people}; MuPoTS evaluator on the card\'s outputs '
          f'({ev_secs:.1f} s, 4 spawned workers): 3DPCK '
          f"{res['PCK_MEAN:']}, PCK_abs {res['PCK_MEAN_ABS:']} (random "
          f'weights); launches per batch as a request\'s: '
          + ', '.join(f'{v} {k}' for k, v in labels.items()))
    del model
    torch.cuda.empty_cache()
    kernel_path_vs_plain_path(MUPOTS_CFG, (0, 0))
    return n, sweep


def write_muco_data(root, rng, n=8, h=2048, w=2048):
    """``n`` MuCo-3DHP composite frames (h x w JPEGs) with 3 people each
    (21 joints, the pelvis 14 the root, visible, well inside the frame;
    pseudo cameras f 1500) and their json; returns the json's path."""
    import cv2
    import numpy as np
    images, anns = [], []
    for i in range(n):
        fname = f'muco_{i:02d}.jpg'
        cv2.imwrite(os.path.join(root, fname), block_frame(rng, h, w))
        images.append(dict(id=i + 1, file_name=fname, width=w, height=h,
                           f=[MUPOTS_F, MUPOTS_F], c=[w / 2, h / 2]))
        for p in range(3):
            cx, cy = w * (0.3 + 0.2 * p), h * (0.45 + 0.04 * p)
            img = np.array([cx, cy]) + rng.randn(21, 2) * [w / 40, h / 12]
            img[14] = [cx, cy]
            z = 3000.0 + 300 * p + rng.randn(21) * 80
            cam = np.stack([(img[:, 0] - w / 2) / MUPOTS_F * z,
                            (img[:, 1] - h / 2) / MUPOTS_F * z, z], 1)
            vis = (rng.rand(21) > 0.1).astype(float)
            vis[14] = 1.0
            u, v = img.T
            bbox = [float(u.min()), float(v.min()), float(np.ptp(u) + 4),
                    float(np.ptp(v) + 4)]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0,
                keypoints_img=img.tolist(), keypoints_cam=cam.tolist(),
                keypoints_vis=vis.tolist()))
    return dump_coco_json(os.path.join(root, 'muco_train.json'), images,
                          anns)


def remat_vs_plain(cfg_path, opts, B, hw):
    """exp_mupots's gradient pass at ``B`` ``hw`` bf16, from the same
    weights and batch, with ``remat`` as shipped (the backbone's stages)
    and with ``remat=False``: the peak memory of each and a timed step of
    each (CUDA events, after one untimed). Four passes (remat, plain,
    plain, remat): the loss terms and the BatchNorm running statistics
    after the first pass of each equal bit for bit (the forward is the same
    computation, and the recompute leaves the statistics alone); the
    gradients as ``grads_vs_plain`` holds kernel against plain (GRAD_NOISE
    times each leaf's own pass-to-pass spread, or 1e-3 of its largest: K4's
    adjoint and cuDNN's weight gradients add in no fixed order, so two
    passes of one model differ too). Raises torch.cuda.OutOfMemoryError
    where the plain step does not fit."""
    import torch
    from das_tpu_torch.config import Config
    from das_tpu_torch.tools.profile_train import make_trainer, \
        synthetic_batch
    cfg = Config.fromfile(cfg_path)
    cfg.merge_from_dict(opts)
    head = cfg.model.bbox_head
    batch = synthetic_batch(B, *hw, int(head.num_joints),
                            int(head.root_idx), seed=2)
    featmaps = [(hw[0] // (4 * 2 ** i), hw[1] // (4 * 2 ** i))
                for i in range(4)]
    out = {}
    passes = {}
    for name, on in (('remat', True), ('plain', False)):
        c = Config.fromfile(cfg_path)
        c.merge_from_dict(dict(opts, **{'model.backbone.remat': on}))
        state, step, _, max_pos = make_trainer(c, torch.bfloat16, 'cuda', B,
                                               hw, seed=5)
        args = (c, batch, featmaps, max_pos)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        la, ga = loss_grads(state.model, *args)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = {k: v.clone() for k, v in state.model.state_dict().items()
                 if k.endswith(('running_mean', 'running_var'))}
        lb, gb = loss_grads(state.model, *args)
        dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        state, _ = step(state, dev_batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        state, _ = step(state, dev_batch)
        ev[1].record()
        torch.cuda.synchronize()
        passes[name] = (la, ga, lb, gb, stats)
        out[name] = dict(peak_gib=peak, step_ms=ev[0].elapsed_time(ev[1]))
        del state, step, ga, gb
        torch.cuda.empty_cache()
    la, ga, ld, gd, sa = passes['remat']
    lb, gb, lc, gc, sb = passes['plain']
    check(la == lb and lc == lb and ld == la,
          ('exp_mupots loss terms, remat vs plain', la, lb))
    check(sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k])
                                           for k in sb),
          'exp_mupots BN running statistics, remat vs plain')
    ab, bc, ad, own, real, held, worst, where = grads_vs_plain(
        ga, gb, gc, gd, 'remat')
    out.update(real=len(real), held=held, worst=worst, where=where,
               ab=max(ab[k] / own[k] for k in real),
               bc=max(bc[k] / own[k] for k in real),
               ad=max(ad[k] / own[k] for k in real),
               equal=sum(ab[k] == 0.0 for k in gb), leaves=len(gb),
               stats=len(sb), losses=la)
    return out


def mupots_training(smi):
    """Phase 14 ("mupots"): exp_mupots trained through ``train_model`` on
    its shipped MuCo-3DHP + COCO mix (``RepeatDataset(convert_ids='muco')``)
    from disk: 8 synthetic 2048x2048 MuCo frames and 8 COCO-17 frames
    under ``build/``, its random pipelines, its 800x1280 bucket, B=4 bf16
    on f32 master weights, MUPOTS_TRAIN_STEPS steps (K4's launches a step
    as ``train_step_launches`` derives them: 'clip' DCNs, two RU layers, no
    K1 or K3; one step profiled for the device's busy ms); then
    ``remat_vs_plain`` at B=4: the step with ``remat`` as shipped and with
    ``remat=False``. If the plain step does not fit on the card, that is
    printed as a finding and the comparison runs at B=2 (named as the
    cut). Returns the run's launches."""
    import numpy as np
    import torch
    from das_tpu_torch.apis import train_model
    from das_tpu_torch.config import Config
    from das_tpu_torch.datasets.loader import train_pad_hw_from_cfg
    from das_tpu_torch.ops import dcn_shift, gather, oks_nms
    root = os.path.join(RECIPES_DIR, 'muco')
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(3)
    opts = {'data.train.0.data_root': root,
            'data.train.0.ann_file': write_muco_data(root, rng),
            'data.train.1.dataset.data_root': root,
            'data.train.1.dataset.img_prefix': root,
            'data.train.1.dataset.ann_file': write_coco_data(root, rng),
            'checkpoint_config.max_keep_ckpts': 1,
            'model.pretrained': None}
    cfg = Config.fromfile(MUPOTS_CFG)
    cfg.merge_from_dict(opts)
    hw = train_pad_hw_from_cfg(cfg.data.train[0].pipeline)
    check(tuple(hw) == MUPOTS_TRAIN_HW, ('exp_mupots train bucket', hw))
    per_step = train_step_launches(cfg, hw, 128 * 4)
    work = os.path.join(RECIPES_DIR, 'mupots_work')
    if os.path.isdir(work):
        import shutil
        shutil.rmtree(work)
    counts = [(dcn_shift, 'launches'), (dcn_shift, 'backward_launches'),
              (oks_nms, 'launches'), (gather, 'launches'),
              (gather, 'backward_launches'), (gather, 'sampler_launches')]
    for mod, attr in counts:
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with TrainWatch({}, per_step, profile_at=1).watching() as w:
        state = train_model(cfg, work_dir=work,
                            max_steps=MUPOTS_TRAIN_STEPS, log_interval=1)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {count_label(k): getattr(*k) for k in counts}
    check(state.step == MUPOTS_TRAIN_STEPS
          and len(w.steps) == MUPOTS_TRAIN_STEPS,
          ('exp_mupots train_model steps', state.step, len(w.steps)))
    check(sorted(os.listdir(os.path.join(work, 'ckpts'))) ==
          ['meta.json', f'step_{MUPOTS_TRAIN_STEPS:08d}.pt'],
          'exp_mupots train_model checkpoint')
    plain = [x for i, x in enumerate(w.steps) if i != w.profile_at]
    phase('mupots', f'train_model exp_mupots (MuCo + COCO from disk, '
          f'ResizePose ranges, B=4 {hw[0]}x{hw[1]} bf16 on f32 master '
          f'weights): {MUPOTS_TRAIN_STEPS} steps in {secs:.1f} s (build, '
          f'loader, save included); steps (CUDA events) '
          + ', '.join(f'{x:.2f}' for x in w.steps)
          + f' ms, step {w.profile_at} profiled: device busy '
          f'{w.busy_ms:.2f} ms; peak memory {peak:.2f} GiB; K4 '
          f'{per_step[0]} + {per_step[1]} a step, no K1, no K3; losses '
          + ', '.join(f"{m['loss']:.5g}" for m in w.losses) + f'; {smi}')
    del state
    torch.cuda.empty_cache()

    B = 4
    try:
        r = remat_vs_plain(MUPOTS_CFG, opts, B, MUPOTS_TRAIN_HW)
    except torch.cuda.OutOfMemoryError as e:
        r = None
        err = str(e).splitlines()[0]
    if r is None:
        torch.cuda.empty_cache()
        phase('mupots', f'FINDING: exp_mupots with remat=False does not fit '
              f'on the card at B={B} {MUPOTS_TRAIN_HW[0]}x'
              f'{MUPOTS_TRAIN_HW[1]} ({err}); the comparison below is cut '
              f'to B=2')
        B = 2
        r = remat_vs_plain(MUPOTS_CFG, opts, B, MUPOTS_TRAIN_HW)
    phase('mupots', f'exp_mupots step B={B} {MUPOTS_TRAIN_HW[0]}x'
          f'{MUPOTS_TRAIN_HW[1]} bf16, same weights and batch: remat as '
          f"shipped (the backbone's stages) {r['remat']['step_ms']:.2f} ms, "
          f"peak memory of its gradient pass {r['remat']['peak_gib']:.2f} "
          f"GiB; remat=False {r['plain']['step_ms']:.2f} ms, "
          f"{r['plain']['peak_gib']:.2f} GiB; loss terms equal bit for bit "
          f"({', '.join(f'{k} {v:.6g}' for k, v in r['losses'].items())}), "
          f"{r['stats']} BN running statistics equal bit for bit; "
          f"gradients: remat vs plain max err / max|leaf| {r['ab']:.3g} "
          f"over {r['real']} leaves, plain vs plain {r['bc']:.3g}, remat vs "
          f"remat {r['ad']:.3g}; {r['equal']} of {r['leaves']} leaves "
          f"equal; worst leaf at {r['worst']:.3g} of its tolerance "
          f"({r['where']}); {smi}")
    return launches


def train_run_short(smi):
    """Phase 15 ("train_run"): ``das_tpu_torch/tools/train_run.py`` in this
    process on exp_panoptic_tpu ('shift': K1 forward and backward) for
    RUN_STEPS steps of B=4 512x960 bf16 from RUN_IMAGES synthetic JPEGs (2
    epochs: 2 saves, the DCN-offset check at each): its artifact parses
    from its file, its losses are finite, the run's K4 adjoint and K1
    backward launches are ``train_step_launches``'s a step. Returns the
    run's launches."""
    import torch
    from das_tpu_torch.config import Config
    from das_tpu_torch.ops import dcn_shift, gather, oks_nms
    from das_tpu_torch.tools import train_run
    base = os.path.join(RECIPES_DIR, 'train_run')
    work, out = os.path.join(base, 'work'), os.path.join(base, 'run.json')
    if os.path.isdir(work):
        import shutil
        shutil.rmtree(work)
    counts = [(dcn_shift, 'launches'), (dcn_shift, 'backward_launches'),
              (dcn_shift, 'backward_tiled_launches'), (oks_nms, 'launches'),
              (gather, 'launches'), (gather, 'backward_launches'),
              (gather, 'sampler_launches')]
    for mod, attr in counts:
        setattr(mod, attr, 0)
    t = time.perf_counter()
    art = train_run.main([
        '--config', SERVING_CFG, '--steps', str(RUN_STEPS),
        '--images', str(RUN_IMAGES), '--workers', '4',
        '--data-dir', os.path.join(base, 'data'), '--work-dir', work,
        '--out', out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {count_label(k): getattr(*k) for k in counts}
    with open(out) as f:
        check(json.load(f) == art, 'train_run: the artifact file')
    per_step = train_step_launches(Config.fromfile(SERVING_CFG), (512, 960),
                                   128 * 4)
    check(art['finite'] and art['steps'] == RUN_STEPS
          and art['device'] == torch.cuda.get_device_name(0)
          and art['checkpoints'][-1] == f'step_{RUN_STEPS:08d}.pt',
          ('train_run artifact', art))
    check(launches['gather.backward_launches'] == per_step[1] * RUN_STEPS
          and launches['dcn_shift.backward_launches']
          == per_step[3] * RUN_STEPS
          and launches['dcn_shift.backward_tiled_launches']
          == launches['dcn_shift.backward_launches']
          and launches['gather.launches'] >= per_step[0] * RUN_STEPS
          and launches['dcn_shift.launches'] >= per_step[2] * RUN_STEPS,
          ('train_run launches', launches, per_step))
    phase('train_run', f'python -m das_tpu_torch.tools.train_run --config '
          f'configs/das/exp_panoptic_tpu.py --steps {RUN_STEPS} (B=4 '
          f'512x960 bf16, {RUN_IMAGES} synthetic JPEGs): {secs:.1f} s; '
          f"finite {art['finite']}, decreasing {art['decreasing']}, loss "
          f"first-10 {art['loss_first10']}, last-10 {art['loss_last10']}, "
          f"step s p50 {art['step_s_p50']} p90 {art['step_s_p90']}, "
          f"checkpoints {art['checkpoints']}; launches {launches} (K4 "
          f'{per_step[0]} + {per_step[1]} and K1 {per_step[2]} + '
          f'{per_step[3]} a step, the DCN checks\' forwards beside); {smi}')
    return launches


def main():
    import torch
    name, smi = environment()
    from das_tpu_torch.ops import conv_gn, dcn_shift, gather, oks_nms
    build()
    k1 = dcn_vs_plain()
    k1b = dcn_backward_vs_plain()
    k2 = conv_gn_vs_plain()
    oks_nms_vs_plain()
    k4, k4b = gather_vs_plain()
    grouped_gather_vs_plain()
    k4s = sampler_vs_plain()

    def expect(convs):
        return {(dcn_shift, 'launches'): 16,
                (dcn_shift, 'wgmma_launches'): 16,
                (dcn_shift, 'backward_launches'): 0,
                (conv_gn, 'launches'): convs, (oks_nms, 'launches'): 1,
                (gather, 'launches'): 3, (gather, 'backward_launches'): 0,
                (gather, 'sampler_launches'): K4_SAMPLES}
    eval_data = write_eval_data('full', 8, 1080, 1920, seed=0)
    model, _, n1, _, _ = main_path(SERVING_CFG, 2, expect(0))
    e1, ips1, outs1 = eval_sweep(model, SERVING_CFG, eval_data, expect(0))
    served_sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    model, cfg, n2, img, sf = main_path(FUSED_CFG, 3, expect(36))
    k3 = nms_on_served_request(model, cfg, img, sf)
    e2, ips2, _ = eval_sweep(model, FUSED_CFG, eval_data, expect(36))
    del model
    torch.cuda.empty_cache()
    img, sf, _, _ = device_preprocess_vs_float64(eval_data, smi)
    fuse_at_full_width(img, sf, smi)
    del img
    torch.cuda.empty_cache()
    eval_card_vs_cpu()
    eval_cli(eval_data)
    phase('eval', f'sweep images/s (device preprocessing, B=4 640x1152 bf16,'
          f' 8 frames): exp_panoptic_tpu {ips1:.2f}, '
          f'exp_panoptic_tpu_fused_gn {ips2:.2f}; {smi}')
    torch.cuda.empty_cache()
    (fwd, bwd), (k1_fwd, k1_bwd), run = train_full_width()
    for n, e in ((n1, e1), (n2, e2)):
        for k in n:
            n[k] += e[k]
    k1['launches'] = n1['dcn_shift.launches'] + n2['dcn_shift.launches'] \
        + k1_fwd
    k1b['launches'] = k1_bwd
    k1b['tiled_launches'] = run['k1_tiled']
    k1b['in_step_ms'] = run['k1_in_step_ms']
    k1b['step_ms'] = run['step_ms']
    k2['launches'] = n2['conv_gn.launches']
    k3['launches'] = n1['oks_nms.launches'] + n2['oks_nms.launches']
    k4['launches'] = n1['gather.launches'] + n2['gather.launches'] + fwd
    k4b['launches'] = bwd
    k4s['launches'] = n1['gather.sampler_launches'] \
        + n2['gather.sampler_launches']
    train_k4_vs_plain_on_card(run, ('bf16', 'f32'))
    train_k1_vs_plain_on_card(run)
    synthetic_median = run['median_ms']
    del run
    torch.cuda.empty_cache()
    n8, train_opts, median8 = trainrun(eval_data, synthetic_median, smi)
    for k in (k1, k1b, k2, k3, k4, k4b, k4s):
        check(k['launches'] > 0, f'the main path launched no {k["name"]}')
    k1['launches'] += n8['dcn_shift.launches']
    k1b['launches'] += n8['dcn_shift.backward_launches']
    k1b['tiled_launches'] += n8['dcn_shift.backward_tiled_launches']
    check(n8['dcn_shift.backward_tiled_launches']
          == n8['dcn_shift.backward_launches'],
          ('the training entry point\'s K1 backward calls off the tiled '
           'pass', n8))
    k3['launches'] += n8['oks_nms.launches']
    k4['launches'] += n8['gather.launches']
    k4b['launches'] += n8['gather.backward_launches']
    k4s['launches'] += n8['gather.sampler_launches']
    check(n8['gather.launches'] > 0 and n8['gather.backward_launches'] > 0
          and n8['dcn_shift.launches'] > 0
          and n8['dcn_shift.backward_launches'] > 0
          and n8['oks_nms.launches'] > 0
          and n8['gather.sampler_launches'] > 0,
          ('the training entry point left a kernel of its path unlaunched',
           n8))
    torch.cuda.empty_cache()
    n9 = dataparallel(eval_data, served_sd, outs1, train_opts, median8, smi)
    for k, key in ((k1, 'dcn_shift.launches'),
                   (k1b, 'dcn_shift.backward_launches'),
                   (k2, 'conv_gn.launches'),
                   (k3, 'oks_nms.launches'), (k4, 'gather.launches'),
                   (k4b, 'gather.backward_launches'),
                   (k4s, 'gather.sampler_launches')):
        k['phase9_launches_per_rank'] = [n[key] for n in n9]
    n10 = tools(served_sd, expect(0), smi)
    del served_sd
    check(n10['dcn_shift.launches'] > 0 and n10['oks_nms.launches'] > 0
          and n10['gather.launches'] > 0
          and n10['gather.sampler_launches'] > 0,
          ('the demo left a kernel of its path unlaunched', n10))
    for k, key in ((k1, 'dcn_shift.launches'), (k3, 'oks_nms.launches'),
                   (k4, 'gather.launches'), (k4s, 'gather.sampler_launches')):
        k['launches'] += n10[key]
        k['phase10_launches'] = n10[key]
    torch.cuda.empty_cache()
    # the reference's recipes: exp_panoptic served and trained ('patch' /
    # 'clip': K4 alone), exp_mupots served, evaluated and trained, and the
    # sustained run's tool
    n11 = panoptic_serving()
    n12 = panoptic_training()
    n13, n13_sweep = mupots_serving()
    n14 = mupots_training(smi)
    n15 = train_run_short(smi)
    recipes = {
        'oks_nms.launches': n11['oks_nms.launches']
        + n13['oks_nms.launches'] + n13_sweep['oks_nms.launches'],
        'gather.launches': n11['gather.launches'] + n13['gather.launches']
        + n13_sweep['gather.launches'] + n12[0] + n14['gather.launches']
        + n15['gather.launches'],
        'gather.backward_launches': n12[1]
        + n14['gather.backward_launches'] + n15['gather.backward_launches'],
        'gather.sampler_launches': n11['gather.sampler_launches']
        + n13['gather.sampler_launches']
        + n13_sweep['gather.sampler_launches']
        + n15['gather.sampler_launches'],
        'dcn_shift.launches': n15['dcn_shift.launches'],
        'dcn_shift.backward_launches': n15['dcn_shift.backward_launches']}
    check(n11['gather.sampler_launches'] > 0 and n12[0] > 0 and n12[1] > 0
          and n13['oks_nms.launches'] > 0 and n14['gather.launches'] > 0
          and n14['gather.backward_launches'] > 0
          and n15['dcn_shift.backward_launches'] > 0,
          ('the recipes left a kernel of their path unlaunched', recipes))
    for k, key in ((k1, 'dcn_shift.launches'),
                   (k1b, 'dcn_shift.backward_launches'),
                   (k3, 'oks_nms.launches'), (k4, 'gather.launches'),
                   (k4b, 'gather.backward_launches'),
                   (k4s, 'gather.sampler_launches')):
        k['launches'] += recipes[key]
        k['recipes_launches'] = recipes[key]
    k1b['tiled_launches'] += n15['dcn_shift.backward_tiled_launches']
    phase('recipes', f'exp_panoptic served ({n11}), trained (K4 {n12[0]} + '
          f'{n12[1]}); exp_mupots served ({n13}), evaluated ({n13_sweep}), '
          f'trained ({n14}); train_run ({n15})')
    kernel_path_vs_plain_path(SERVING_CFG, (16, 0))
    kernel_path_vs_plain_path(FUSED_CFG, (16, 36))
    train_kernel_vs_plain()
    print(json.dumps({'kernels': [k1, k1b, k2, k3, k4, k4b, k4s]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
