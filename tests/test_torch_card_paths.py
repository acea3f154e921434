"""The port's main paths at full width on one NVIDIA H100, and every entry
point on the card: what a served request, a train step, an evaluation, a
training run, data parallelism and the tools launch and compute there.

- the serving paths (B=4 bf16 requests through ``make_predict_fn``) of
  ``exp_panoptic_tpu``, its fused-GN twin and the reference's
  ``exp_panoptic`` and ``exp_mupots`` recipes, each request launching the
  kernels the config derives; K3 on a served request's candidates and in
  the decode; each config's kernel path on the card against the plain
  path on the CPU;
- training at full width: steps of ``apis.train.make_trainer`` with the
  launches ``train_step_launches`` derives, the gradient pass with K4 and
  with K1 against their plain versions on the card, the cut fp32 step
  against the CPU;
- evaluation (``run_test`` with device preprocessing over synthetic PNG
  frames, its launches a batch, ``fuse_conv_bn``, card against CPU, the
  CLI); ``train_model`` from synthetic frames on disk (steps, saves, the
  DCN check, the eval hook, resume, the CLI, the checkpoint tools); data
  parallelism (a NCCL world of one, two gloo ranks on the one card,
  ``torch.distributed.run``); the host library, the demo,
  ``validate_hybrid`` and a traced request; the recipes' training runs,
  remat against the plain step, and ``tools/train_run.py``.

These tests need an NVIDIA GPU (sm_90), nvcc and g++; without a card they
skip. They import neither JAX nor ``das_tpu``:

    python -m pytest --noconftest -m cuda tests/test_torch_card_paths.py

Synthetic data is written under ``tmp_path``. TF32 is off throughout.
"""

import contextlib
import io
import json
import math
import multiprocessing as mp
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from das_tpu_torch.apis import init_model, make_predict_fn, run_test
from das_tpu_torch.apis.train import make_trainer
from das_tpu_torch.config import Config
from das_tpu_torch.core.targets import get_targets
from das_tpu_torch.datasets import build_dataset
from das_tpu_torch.models import build_trainable_model
from das_tpu_torch.models.layers import (BatchNorm, DeformConv2d,
                                         keep_master_weights)
from das_tpu_torch.ops import (bn_act, conv_gn, dcn_shift, deform_conv,
                               gather, oks_nms)
from das_tpu_torch.parallel import (frozen_mask, mspn_frozen_prefixes,
                                    param_groups, replicate)
from das_tpu_torch.tools.profile_kernels import (pose_template,
                                                 served_candidates)
from das_tpu_torch.tools.profile_train import synthetic_batch, train_pad_hw

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_DIR = os.path.join(ROOT, 'configs', 'das')
SERVING_CFG = os.path.join(CFG_DIR, 'exp_panoptic_tpu.py')
FUSED_CFG = os.path.join(CFG_DIR, 'exp_panoptic_tpu_fused_gn.py')
PANOPTIC_CFG = os.path.join(CFG_DIR, 'exp_panoptic.py')
MUPOTS_CFG = os.path.join(CFG_DIR, 'exp_mupots.py')
HRNET_CFG = os.path.join(CFG_DIR, 'exp_panoptic_hrnet48.py')
BF16_STEP = 2.0 ** -7         # bf16's spacing relative to a value in [1, 2)
# a gradient leaf that is zero to rounding: its largest value below this
# fraction of the largest of all leaves (a conv bias before a norm)
ZERO_GRAD = 1e-6
# how many times its measured rounding noise a gradient leaf may be off
GRAD_NOISE = 10.0
# a gradient leaf of the card's train step against the CPU's, relative to
# its largest CPU value (see test_cut_train_step_card_vs_cpu)
CARD_CPU_RTOL = 2e-2
# K4 launches (row gathers and fused samples) that a served request of
# exp_panoptic_tpu may make: a quarter of the 210 it made with one launch
# per corner. A request makes 3 grouped gathers (take_at at the sparse
# levels 0-2), 8 fused samples (two per level) and one fused sample per
# DCN call that repairs, of 16 DCN calls
K4_PER_REQUEST = 52
K4_SAMPLES = (9, 24)
TRAIN_HW = (640, 1344)        # exp_panoptic's train bucket
# exp_mupots's test bucket: a 1920x1080 MuPoTS-3D frame at its test scale
# (1280, 768), ratio kept (1280x720), padded to a multiple of 32; and its
# train bucket, the largest of its ResizePose scales (1280, 800)
MUPOTS_HW = (736, 1280)
MUPOTS_TRAIN_HW = (800, 1280)
MUPOTS_F = 1500.0
EVAL_J = 15
EVAL_F = 1000.0
# decoded people of two runs that should agree (fused against unfused, card
# against CPU): scores within EVAL_SCORE_TOL, each pose within EVAL_POSE_RTOL
# of its largest coordinate (the kernel path's tolerances)
EVAL_SCORE_TOL = 1e-4
EVAL_POSE_RTOL = 1e-3
# validate_hybrid's max|off| on the card against the CPU, relative
VALIDATE_RTOL = 1e-5
# the losses of a resumed step against the same step from the run's own
# final state in memory, on the same batch, relative to each loss
RESUME_RTOL = 1e-3
# 16 frames at B=4 are 4 steps an epoch: 6 steps cross one epoch end (a
# save, the DCN-offset check and the eval hook), then the final save
TRAIN_STEPS = 6
# the same 16 frames at a global batch of 4, 2 a rank, are one epoch
DP_STEPS = 4
DP_BATCH = 2
DP_RANK_TIMEOUT = 600
DP_DEVICE = 'cuda:0'


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _release_memory():
    yield
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ------------------------------------------------------ launch counts

def train_step_launches(cfg, hw, max_pos):
    """(K4 row gathers, their adjoints, K4 samples, their backwards, K1
    forward, K1 backward) launches of one train step of ``cfg`` at the
    ``hw`` bucket with ``max_pos``, derived from the model code:

    - the DCN calls: the 3 towers' last convs and each RU layer's update
      conv at 4 levels, all of whose inputs ask for gradients; each is one
      K1 forward and one K1 backward under ``'shift'``, or one fused sample
      of the nine taps and its backward under ``'clip'``;
    - the RU's sampling, one fused sample and its backward a sample, two
      a level in every layer; the last layer at a level of more than
      ``max_pos`` points (sparse) also makes the grouped take_at before
      them, one row gather and its adjoint;
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
    assert mode in ('clip', 'shift'), ('no launch count for the lowering',
                                       mode)
    sparse = bool((cfg.model.get('train_cfg') or {}).get('sparse_refine'))
    points = [(hw[0] // (4 * 2 ** i)) * (hw[1] // (4 * 2 ** i))
              for i in range(4)]
    take_at = sum(sparse and n > max_pos for n in points)
    ru_samples = 8 * layers
    towers, ru_dcn = 12, 4 * layers
    k4_dcn = int(mode == 'clip')
    samples = (towers + ru_dcn) * k4_dcn + ru_samples
    samples_again = towers * k4_dcn * head_remat \
        + (ru_dcn * k4_dcn + ru_samples) * ru_remat
    k1 = (towers + ru_dcn) * (1 - k4_dcn)
    k1_again = (towers * head_remat + ru_dcn * ru_remat) * (1 - k4_dcn)
    return (take_at * (1 + ru_remat), take_at, samples + samples_again,
            samples, k1 + k1_again, k1)


# the counters that train_step_launches predicts, in its order
STEP_COUNTS = ('gather.launches', 'gather.backward_launches',
               'gather.sampler_launches', 'gather.sampler_backward_launches',
               'dcn_shift.launches', 'dcn_shift.backward_launches')
KERNEL_COUNTS = ('dcn_shift.launches', 'dcn_shift.backward_launches',
                 'conv_gn.launches', 'oks_nms.launches', 'gather.launches',
                 'gather.backward_launches', 'gather.sampler_launches',
                 'gather.sampler_backward_launches', 'bn_act.launches')
_MODULES = dict(dcn_shift=dcn_shift, conv_gn=conv_gn, oks_nms=oks_nms,
                gather=gather, bn_act=bn_act)


def counts(names):
    """The named counters' values now (``module.attribute``)."""
    return [getattr(_MODULES[k.split('.')[0]], k.split('.')[1])
            for k in names]


def step_counts():
    return counts(STEP_COUNTS)


def kernel_counts():
    return dict(zip(KERNEL_COUNTS, counts(KERNEL_COUNTS)))


def tpu_step():
    """``train_step_launches`` of exp_panoptic_tpu at its train bucket and
    max_pos 512 (128 an image of a global batch of 4)."""
    return train_step_launches(Config.fromfile(SERVING_CFG), TRAIN_HW, 512)


def serve_launches(cfg, hw):
    """(row gathers, fused samples, of them masked) of one served B=4
    request of an exact-gather ('patch') config at the ``hw`` bucket,
    derived from the model code: every DCN call (the 3 towers' last convs
    and each RU layer's update conv at 4 levels) one masked fused sample
    of its nine taps; each RU layer but the last two samples a level; the
    last, at a level of more than ``nms_pre`` points, the grouped take_at
    and two samples, else two samples."""
    head = cfg.model.bbox_head
    assert head.get('dcn_gather_mode', 'patch') == 'patch', \
        'serve_launches counts the exact gather only'
    layers = int(head.recursive_update.get('num_layers', 1))
    nms_pre = int(cfg.model.test_cfg.nms_pre)
    sparse = bool(cfg.model.test_cfg.get('sparse_refine'))
    big = [(hw[0] // (4 * 2 ** i)) * (hw[1] // (4 * 2 ** i)) > nms_pre
           for i in range(4)]
    gathers = sum(big) if sparse else 0
    dcn = 12 + 4 * layers
    return gathers, dcn + 8 * layers, dcn


def batchnorms(cfg):
    """The BatchNorms of ``cfg``'s model (the backbone's and the FPN's),
    built on the meta device: a served bf16 request launches the one-pass
    BatchNorm (``ops.bn_act``) once for each."""
    from das_tpu_torch.config import wrap_cfg
    from das_tpu_torch.config.registry import MODELS, build_from_cfg
    with torch.device('meta'):
        model = build_from_cfg(dict(wrap_cfg(cfg.model)), MODELS)
    return sum(isinstance(m, BatchNorm) for m in model.modules())


def shift_expect(convs):
    """The launches of one served request of exp_panoptic_tpu (``convs``
    K2 launches: 36 on its fused-GN twin): 16 K1, all on the wgmma pass,
    one K3 (the decode's), 3 grouped gathers and K4_SAMPLES fused samples,
    one one-pass BatchNorm a BatchNorm."""
    return {(bn_act, 'launches'): batchnorms(Config.fromfile(SERVING_CFG)),
            (dcn_shift, 'launches'): 16, (dcn_shift, 'wgmma_launches'): 16,
            (dcn_shift, 'backward_launches'): 0,
            (conv_gn, 'launches'): convs, (oks_nms, 'launches'): 1,
            (gather, 'launches'): 3, (gather, 'backward_launches'): 0,
            (gather, 'sampler_launches'): K4_SAMPLES,
            (gather, 'sampler_backward_launches'): 0}


def recipe_expect(cfg, hw):
    """The launches of one served request of a 'patch' config: no K1 or
    K2, one K3 (the decode's), ``serve_launches``'s K4, one one-pass
    BatchNorm a BatchNorm (136 exp_panoptic, 204 exp_mupots, 313
    exp_panoptic_hrnet48: 128, 196 and 305 the backbone's, 8 the FPN's)."""
    gathers, samples, masked = serve_launches(cfg, hw)
    return {(bn_act, 'launches'): batchnorms(cfg),
            (dcn_shift, 'launches'): 0, (dcn_shift, 'wgmma_launches'): 0,
            (dcn_shift, 'backward_launches'): 0, (conv_gn, 'launches'): 0,
            (oks_nms, 'launches'): 1, (gather, 'launches'): gathers,
            (gather, 'backward_launches'): 0,
            (gather, 'sampler_launches'): samples,
            (gather, 'sampler_masked_launches'): masked,
            (gather, 'sampler_backward_launches'): 0}


def count_label(key):
    return f'{key[0].__name__.rsplit(".", 1)[-1]}.{key[1]}'


def within(got, expect, k4_cap=None):
    """Every count of ``expect`` ({label: n or (lo, hi)}) in ``got``
    ({label: launches}) exactly, or within (lo, hi); with ``k4_cap``, K4's
    launches together (row gathers and fused samples; the masked samples
    are counted among the samples too) no more than it."""
    ok = all(n[0] <= got[k] <= n[1] if isinstance(n, tuple) else got[k] == n
             for k, n in expect.items())
    k4 = sum(v for k, v in got.items() if 'gather' in k
             and k != 'gather.sampler_masked_launches')
    return ok and (k4_cap is None or k4 <= k4_cap)


# --------------------------------------------------------------- models

def perturb_offsets(model, seed=1, spread=0.3, shift=0.5):
    """Seeded conv_offset weights at spread/sqrt(fan_in), so that offsets
    are O(spread), and ``shift`` added to tap 0's dy bias, so that a few of
    those pass radius 1: the shift base and the exact repair both run, and
    the flagged pixels stay within the repair budget."""
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
    from das_tpu_torch.ops.deform_conv import deform_offset_overflow
    found, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, DeformConv2d):
            def hook(mod, inp, out, name=name):
                off = out[:, :18].permute(0, 2, 3, 1)
                found.append((name, int(deform_offset_overflow(
                    off, 1, 0).sum())))
            hooks.append(m.conv_offset.register_forward_hook(hook))
    with torch.inference_mode():
        model(img)
    for h in hooks:
        h.remove()
    return found


def served_model_of(cfg_path, dtype=torch.bfloat16, device='cuda'):
    """The served model of ``cfg_path`` as the serving tests build it:
    seeded weights, offsets perturbed (``perturb_offsets``), and the pose
    template with the cls bias at 0 (``pose_template``), so that people
    pass score_thr and neighbouring candidates overlap in the NMS."""
    model, cfg = init_model(cfg_path, dtype=dtype, device=device)
    perturb_offsets(model)
    pose_template(model)
    return model, cfg


@contextlib.contextmanager
def no_tf32():
    """f32 convs and matmuls in f32, as the CPU computes them, for the
    block; the flags as they were after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def trainer(cfg, dtype, device, batch, hw, seed=0, group=None):
    """(state, step_fn, lr_fn, max_pos) of ``cfg`` through
    ``apis.train.make_trainer`` on a synthetic pool: the model from
    ``seed`` (replicated over ``group``), 1000 steps an epoch, the config's
    image normalisation on the device (the batch is raw pixels)."""
    model = build_trainable_model(cfg.model, dtype=dtype, device=device,
                                  seed=seed)
    if group is not None:
        replicate(model, group)
    return make_trainer(cfg, model, hw, batch,
                        img_norm=cfg.get('img_norm_cfg'), group=group)


def cut_train_cfg():
    """exp_panoptic_tpu with the backbone cut to one stage of one block per
    unit, widths kept: a random-init train-mode forward at full depth
    amplifies two devices' (or two reduction orders') rounding to ~1e-2 at
    the FPN outputs (see test_cut_train_step_card_vs_cpu)."""
    cfg = Config.fromfile(SERVING_CFG)
    cfg.model.backbone.update(num_stages=1, num_blocks=[1, 1, 1, 1])
    return cfg


# ----------------------------------------------------------------- data

def png_bytes(rgb):
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8: zlib over filter-0
    rows."""
    import struct
    import zlib
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


def block_frame(rng, h, w):
    """An h x w uint8 frame of 40-pixel blocks with a little noise."""
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


def panoptic_people(rng, n, w, h, f, root_at_mid_hip):
    """``n`` CMU-Panoptic annotations of one frame (pinhole camera of focal
    ``f`` at the centre): pixel+depth joints, world joints, full
    visibility; with ``root_at_mid_hip`` the roots lie well inside the
    frame (the training warp keeps at least 2) and joint 2 is the root."""
    anns = []
    for p in range(n):
        if root_at_mid_hip:
            base = np.array([w * (0.32 + 0.36 * p / (n - 1)),
                             h * (0.45 + 0.04 * p), 300.0 + 30 * p])
            joints = base + rng.randn(EVAL_J, 3) * [w / 40, h / 12, 15]
            joints[2] = base
        else:
            base = np.array([w * (0.2 + 0.3 * p), h * 0.45, 300.0 + 40 * p])
            joints = base + rng.randn(EVAL_J, 3) * [w / 30, h / 10, 15]
        u, v, z = joints.T
        world = np.stack([(u - w / 2) / f * z, (v - h / 2) / f * z, z], 1)
        bbox = [float(u.min()), float(v.min()), float(np.ptp(u)),
                float(np.ptp(v))]
        anns.append(dict(
            category_id=1, bbox=bbox, area=bbox[2] * bbox[3], iscrowd=0,
            joints3d_img=joints.tolist(), joints3d=world.tolist(),
            joints2d_vis=[[1, 1]] * EVAL_J,
            joints3d_vis=[[1, 1, 1]] * EVAL_J))
    return anns


def panoptic_image(i, fname, w, h, f):
    return dict(id=i + 1, file_name=fname, width=w, height=h,
                cam=dict(K=[[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.]],
                         R=np.eye(3).tolist(), t=[[0.], [0.], [0.]]))


def write_eval_data(root, n, h, w, seed):
    """``n`` synthetic h x w PNG frames and a CMU-Panoptic-format
    annotation json beside them (the layout of
    tests/test_datasets.py::make_panoptic_json: focal EVAL_F / 1920 * w, 2
    or 3 people an image). Returns (folder, json path)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    f = EVAL_F * w / 1920
    images, anns = [], []
    for i in range(n):
        rgb = block_frame(rng, h, w)
        fname = f'frame_{i:02d}.png'
        with open(os.path.join(root, fname), 'wb') as fh:
            fh.write(png_bytes(rgb))
        images.append(panoptic_image(i, fname, w, h, f))
        for a in panoptic_people(rng, 2 + i % 2, w, h, f, False):
            anns.append(dict(a, id=len(anns) + 1, image_id=i + 1))
    return root, dump_coco_json(os.path.join(root, 'annotations.json'),
                                images, anns)


def eval_config(cfg_path, root, ann, img_scale=None):
    """``cfg_path`` with its test data set to ``ann`` and the images under
    ``root`` (and the test scale to ``img_scale``, where given), as
    ``--cfg-options`` sets them."""
    cfg = Config.fromfile(cfg_path)
    opts = {'data.test.ann_file': ann, 'data.test.img_prefix': root}
    if img_scale is not None:
        opts['data.test.pipeline.2.img_scale'] = img_scale
    cfg.merge_from_dict(opts)
    return cfg


def write_coco_data(root, rng, n=8, h=480, w=640):
    """``n`` COCO-17 keypoint frames (h x w JPEGs) with 3 people each, both
    hips visible, under ``root``; returns the json's path."""
    import cv2
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


def write_train_data(root, seed=0):
    """The shipped mix on disk: 8 CMU-Panoptic-format 1920x1080 JPEG frames
    with 3-4 people each (the layout of tests/test_train_api.py's
    make_train_dataset) and 8 COCO-17 keypoint frames at 640x480 with 3
    people each. Returns the --cfg-options that point exp_panoptic_tpu's
    data.train at them."""
    import cv2
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w, f = 1080, 1920, EVAL_F
    images, anns = [], []
    for i in range(8):
        fname = f'panoptic_{i:02d}.jpg'
        cv2.imwrite(os.path.join(root, fname), block_frame(rng, h, w))
        images.append(panoptic_image(i, fname, w, h, f))
        for a in panoptic_people(rng, 3 + i % 2, w, h, f, True):
            anns.append(dict(a, id=len(anns) + 1, image_id=i + 1))
    pan = dump_coco_json(os.path.join(root, 'panoptic_train.json'), images,
                         anns)
    coco = write_coco_data(root, rng)
    return {'data.train.0.data_root': root, 'data.train.0.ann_file': pan,
            'data.train.0.img_prefix': root,
            'data.train.1.data_root': root, 'data.train.1.ann_file': coco,
            'data.train.1.img_prefix': root,
            'checkpoint_config.max_keep_ckpts': 2}


def write_mupots_data(root, n_seq=20, people=2, h=1080, w=1920, seed=0):
    """One synthetic MuPoTS-3D frame per sequence TS1..TS20 (an h x w JPEG
    ``TS{k}/img_000000.jpg``, the names the evaluator reads) and the
    annotations in the reference's layout (tests/test_mupots_evaluate.py):
    a COCO json with ``intrinsic`` and 21 image/camera joints a person, and
    ``TS{k}/annot.mat`` + ``occlusion.mat`` (MATLAB cell arrays of
    annot2/annot3/univ_annot3/isValidFrame structs, ``scipy.io.savemat``).
    Returns the data root."""
    import cv2
    import scipy.io as sio
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


def write_muco_data(root, rng, n=8, h=2048, w=2048):
    """``n`` MuCo-3DHP composite frames (h x w JPEGs) with 3 people each
    (21 joints, the pelvis 14 the root, visible, well inside the frame;
    pseudo cameras f 1500) and their json; returns the json's path."""
    import cv2
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


@pytest.fixture(scope='module')
def eval_data(tmp_path_factory):
    """8 synthetic 1920x1080 PNG frames and their CMU-Panoptic json."""
    return write_eval_data(str(tmp_path_factory.mktemp('eval')), 8, 1080,
                           1920, seed=0)


@pytest.fixture(scope='module')
def train_opts(tmp_path_factory, eval_data):
    """The shipped training mix on disk, and the eval frames as its val
    set: exp_panoptic_tpu's ``--cfg-options``."""
    opts = write_train_data(str(tmp_path_factory.mktemp('train')))
    opts.update({'data.val.ann_file': eval_data[1],
                 'data.val.img_prefix': eval_data[0],
                 'data.val.data_root': eval_data[0]})
    return opts


@pytest.fixture(scope='module')
def served_sd(cuda):
    """exp_panoptic_tpu's served bf16 weights (``served_model_of``), on the
    host."""
    model, _ = served_model_of(SERVING_CFG)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


@pytest.fixture(scope='module')
def served_outs(served_sd, eval_data):
    """``run_test`` of the served weights over the eval frames, one
    process, on the card: the reference of the group paths."""
    cfg = eval_config(SERVING_CFG, *eval_data)
    return run_test(load_served(served_sd, 'cuda'),
                    build_dataset(cfg.data['test']), cfg, batch_size=4,
                    progress=False, device_preprocess=True)


def load_served(sd, dev):
    """exp_panoptic_tpu's served model with the state ``sd`` (a dict, or
    its file) on ``dev``, in the config's DCN mode."""
    model, _ = init_model(SERVING_CFG, dtype=torch.bfloat16, device=dev,
                          validate_dcn=False)
    if isinstance(sd, str):
        sd = torch.load(sd, map_location=dev)
    model.load_state_dict(sd, strict=True)
    return model


# ------------------------------------------------------ people and grads

def people_agree(ref, got, what):
    """Two runs' decoded people of each image (``run_test``'s output dicts):
    the same count, scores in the same order within EVAL_SCORE_TOL, and each
    pose of ``got`` within EVAL_POSE_RTOL (of its largest coordinate) of a
    ``ref`` pose whose score is within EVAL_SCORE_TOL; the lowest-scored
    entries, where a near tie can cross the nms_post cut, are skipped.
    Returns the people."""
    worst, people = 0.0, 0
    for i, (r, g) in enumerate(zip(ref, got)):
        sr, sg = np.asarray(r['scores']), np.asarray(g['scores'])
        assert len(sr) == len(sg), (what, 'people', i, len(sr), len(sg))
        people += len(sg)
        if not len(sg):
            continue
        assert np.abs(sr - sg).max() <= EVAL_SCORE_TOL, (what, 'scores', i)
        cut = sr.min() + EVAL_SCORE_TOL
        for p in range(len(sg)):
            if sg[p] <= cut:
                continue
            near = np.abs(sr - sg[p]) <= EVAL_SCORE_TOL
            err = np.abs(r['poses'][near] - g['poses'][p]).max(axis=(1, 2))
            worst = max(worst, float(err.min()) / max(
                1.0, float(np.abs(g['poses'][p]).max())))
    assert worst <= EVAL_POSE_RTOL, (what, 'poses', worst)
    return people


def loss_grads(model, cfg, batch, featmaps, max_pos):
    """The train step's gradient pass without its update, on the model's
    device: ``batch`` (the TrainLoader's numpy arrays) normalised as
    ``make_train_step`` normalises it, its targets, ``model.loss`` and the
    backward of the sum of the loss terms. Returns ({term: value},
    {parameter name: gradient})."""
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


def featmaps_of(hw):
    return [(hw[0] // (4 * 2 ** i), hw[1] // (4 * 2 ** i)) for i in range(4)]


def leaf_errors(x, y):
    """{leaf: max |x - y|} over the gradient leaves of ``y``."""
    return {k: float((x[k].float() - y[k].float()).abs().max()) for k in y}


def grads_vs_plain(ga, gb, gc, gd, what, reordered=None):
    """Gradient leaves of four passes, kernel (a), plain (b), plain again
    (c), kernel again (d): each leaf's kernel-vs-plain error within
    GRAD_NOISE times the larger of its plain-vs-plain and kernel-vs-kernel
    errors (and of ``reordered``, {leaf: error} of a plain pass whose sums
    were taken in another order, where given), or within 1e-3 of the leaf's
    largest plain value where that is more; a leaf that is zero to rounding
    within ZERO_GRAD of the largest of all."""
    assert sorted(ga) == sorted(gb), ('gradient keys', what)
    own = {k: float(v.abs().max()) for k, v in gb.items()}
    top = max(own.values())
    ab, bc, ad = leaf_errors(ga, gb), leaf_errors(gc, gb), \
        leaf_errors(gd, ga)
    noise = {k: max(bc[k], ad[k], (reordered or {}).get(k, 0.0))
             for k in gb}
    for k in gb:
        t = max(1e-3 * own[k], GRAD_NOISE * noise[k])
        if own[k] < ZERO_GRAD * top:
            t = max(t, ZERO_GRAD * top)
        assert ab[k] <= t, ('gradient, kernel vs plain on the card', what, k,
                            ab[k], own[k], noise[k])


def leaves_close(got, want, what, rtol=CARD_CPU_RTOL):
    """Each leaf of ``got`` within ``rtol`` of the largest value of its leaf
    in ``want``, a leaf that is zero to rounding (below ZERO_GRAD of the
    largest of all) within 10 x ZERO_GRAD of that largest; returns the
    tolerances."""
    top = max(float(w.abs().max()) for w in want.values())
    tols = {}
    for k, w in want.items():
        own = float(w.abs().max())
        tol = 10 * ZERO_GRAD * top if own < ZERO_GRAD * top else rtol * own
        err = float((got[k] - w).abs().max())
        assert err <= tol, (what, k, err, own, top)
        tols[k] = tol
    return tols


# -------------------------------------------------------- serving paths

SERVED = [(SERVING_CFG, 2, (640, 1152)), (FUSED_CFG, 3, (640, 1152)),
          (PANOPTIC_CFG, 3, (640, 1152)), (MUPOTS_CFG, 3, MUPOTS_HW),
          (HRNET_CFG, 3, (640, 1152))]


def served_expect(cfg_path, cfg, hw):
    """The launches of one served request of ``cfg_path`` at ``hw``."""
    if cfg_path == SERVING_CFG:
        return shift_expect(0)
    if cfg_path == FUSED_CFG:
        return shift_expect(36)
    return recipe_expect(cfg, hw)


@pytest.mark.parametrize('cfg_path,requests,hw', SERVED,
                         ids=[os.path.basename(c)[:-3] for c, _, _ in SERVED])
def test_served_requests_launch_what_the_config_derives(cuda, cfg_path,
                                                        requests, hw):
    """B=4 bf16 requests at the config's bucket through ``make_predict_fn``,
    offsets perturbed (``perturb_offsets``). Each request launches exactly
    its share of the config's counts, or a number within (lo, hi) where the
    share is such a pair (the fused sampler, whose count follows the DCN
    calls that repair), K4's launches together within K4_PER_REQUEST on
    the shift configs; its outputs are finite and its poses (4, 100, J, 3).
    A hybrid DCN config flags pixels beyond radius 1 (the repair runs)."""
    model, cfg = init_model(cfg_path, dtype=torch.bfloat16, device='cuda')
    perturb_offsets(model)
    head = cfg.model.bbox_head
    expect = served_expect(cfg_path, cfg, hw)
    labels = {count_label(k): n for k, n in expect.items()}
    cap = K4_PER_REQUEST if cfg_path in (SERVING_CFG, FUSED_CFG) else None
    predict = make_predict_fn(model, cfg.model.test_cfg, head.num_joints,
                              head.strides, device='cuda')
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.randn(4, *hw, 3).astype(np.float32))
            .cuda() for _ in range(requests + 1)]
    sf = torch.ones(4, 2, device='cuda')
    if head.get('dcn_gather_mode', 'patch').startswith('hybrid'):
        flagged = flagged_per_layer(model, imgs[0])
        assert sum(c for _, c in flagged) > 0, \
            'no offset left radius 1: the repair never ran'
    predict(imgs[0], sf)                     # warm-up request
    torch.cuda.synchronize()
    for img in imgs[1:]:
        before = {key: getattr(*key) for key in expect}
        out = predict(img, sf)
        torch.cuda.synchronize()
        got = {count_label(key): getattr(*key) - before[key]
               for key in expect}
        for k, v in out.items():
            if v.is_floating_point():
                assert torch.isfinite(v).all(), k
        assert out['poses'].shape == (4, 100, head.num_joints, 3)
        assert within(got, labels, cap), got


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


def test_k3_on_a_served_request(cuda):
    """K3 on the NMS candidates of one served fused-GN request (B=4
    640x1152 bf16, the pose template): the keep mask equals the plain
    version's, also with ``max_keep``; every image keeps more than
    nms_post and fewer than all; ``oks_nms_sorted`` equals
    ``oks_nms_fixed`` up to equal-score swaps; ``decode_batch``'s own
    output equals the one built from ``oks_nms_fixed``'s indices: validity
    and scores, and each pose that of a candidate of that score. One K3
    launch a call."""
    from das_tpu_torch.core.decode import decode_batch
    model, cfg = served_model_of(FUSED_CFG)
    head = cfg.model.bbox_head
    test_cfg = dict(cfg.model.test_cfg)
    J = int(head.num_joints)
    img = torch.from_numpy(np.random.RandomState(0).randn(4, 640, 1152, 3)
                           .astype(np.float32)).cuda()
    sf = torch.ones(4, 2, device='cuda')
    r = served_candidates(model, cfg, img, sf)
    kpts, areas, valid, c = r['kpts'], r['areas'], r['valid'], r['cand']
    thr, sig, post = r['thr'], r['sigmas'], r['nms_post']
    with torch.inference_mode():
        B, M = c['nms_scores'].shape
        assert bool(c['valid'].any()), 'no valid candidate'
        torch.cuda.synchronize()
        before = oks_nms.launches
        keep = oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig)
        capped = oks_nms.oks_nms_keep(kpts, areas, valid, thr, sig,
                                      max_keep=post)
        torch.cuda.synchronize()
        assert oks_nms.launches == before + 2
        plain = oks_nms.oks_nms_keep_plain(kpts, areas, valid, thr, sig)
        assert torch.equal(keep, plain)
        assert torch.equal(capped, plain & (plain.cumsum(-1) <= post))
        kept = keep.sum(1).tolist()
        assert all(post < k < M for k in kept), (kept, M)
        args = (c['xy'], c['nms_scores'], c['areas'], c['valid'], thr, sig)
        before = oks_nms.launches
        mine, mine_ok = oks_nms.oks_nms_sorted(*args, max_dets=post)
        assert oks_nms.launches == before + 1
        fixed, fixed_ok = oks_nms.oks_nms_fixed(*args, max_dets=post)
        scores = c['nms_scores'].cpu()
        for b in range(B):
            assert same_up_to_ties(mine[b][mine_ok[b]].cpu(),
                                   fixed[b][fixed_ok[b]].cpu(), scores[b],
                                   post), b
        before = oks_nms.launches
        out = decode_batch(*r['heads'], tuple(head.strides), sf, J, test_cfg)
        assert oks_nms.launches == before + 1
        nidx = torch.arange(B, device=fixed.device)[:, None]
        assert torch.equal(out['valid'], fixed_ok)
        assert torch.equal(out['scores'], torch.where(
            fixed_ok, c['nms_scores'][nidx, fixed], 0.0))
        same = (out['poses'] == c['poses'][nidx, fixed]).flatten(2).all(-1)
        assert torch.equal(out['poses'], c['poses'][nidx, mine])
        for b, i in (~same).nonzero().tolist():
            assert float(c['nms_scores'][b, mine[b, i]]) == \
                float(c['nms_scores'][b, fixed[b, i]]), (b, i)


KERNEL_PATHS = [(SERVING_CFG, (16, 0)), (FUSED_CFG, (16, 36)),
                (PANOPTIC_CFG, (0, 0)), (MUPOTS_CFG, (0, 0))]


@pytest.mark.parametrize('cfg_path,expect', KERNEL_PATHS,
                         ids=[os.path.basename(c)[:-3]
                              for c, _ in KERNEL_PATHS])
def test_kernel_path_on_the_card_matches_the_plain_path(cuda, cfg_path,
                                                        expect):
    """The same fp32 weights on the card (kernels) and on the CPU (plain),
    one B=1 128x160 image, full depth, the refined points taken once from
    the CPU's outputs: the card's forward launches ``expect`` = (K1, K2)
    kernels and some of K4's; head outputs within 1e-3 of max(1, max|ref|);
    the decode: the same number of valid people (> 0), scores within 1e-4,
    each card pose within 1e-3 of a CPU pose of a score within 1e-4 (the
    lowest-scored entries, where a near tie can cross the nms_post cut,
    skipped)."""
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
    assert ran == expect and gathers > 0, (ran, gathers)
    for name, lc, lg in zip(('cls', 'pose', 'ctr', 'ref_uvd'), outs_c,
                            outs_g):
        for lvl, (c, g) in enumerate(zip(lc, lg)):
            err = (g.cpu() - c).abs().max().item() / \
                max(1.0, c.abs().max().item())
            assert err <= 1e-3, (name, lvl, err)
    head = cfg.model.bbox_head
    args = (test_cfg, head.num_joints, head.strides)
    sf = np.ones((1, 2), np.float32)
    dc = make_predict_fn(cpu, *args, device='cpu')(img, sf)
    dg = {k: v.cpu() for k, v in
          make_predict_fn(gpu, *args, device='cuda')(img, sf).items()}
    nv = int(dc['valid'].sum())
    assert int(dg['valid'].sum()) == nv and nv > 0
    sc, sg = dc['scores'][0][:nv], dg['scores'][0][:nv]
    pc, pg = dc['poses'][0][:nv], dg['poses'][0][:nv]
    assert (sc - sg).abs().max().item() <= 1e-4
    cut = sc.min().item() + 1e-4
    for i in range(nv):
        if sg[i] <= cut:
            continue
        near = (sc - sg[i]).abs() <= 1e-4
        d = (pc[near] - pg[i]).abs().amax(dim=(1, 2)).min().item()
        assert d / max(1.0, pg[i].abs().max().item()) <= 1e-3, i


# ------------------------------------------------------------ evaluation

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


@pytest.mark.parametrize('cfg_path,convs', [(SERVING_CFG, 0), (FUSED_CFG, 36)],
                         ids=['exp_panoptic_tpu', 'exp_panoptic_tpu_fused_gn'])
def test_run_test_sweep_on_the_card(cuda, eval_data, cfg_path, convs):
    """``run_test`` with device preprocessing over the 8 synthetic
    1920x1080 frames (-> 640x1138, padded 640x1152, B=4 bf16), on the
    served model: each batch launches exactly a request's share
    (``shift_expect``, K4 within K4_PER_REQUEST), two batches, people
    found, every pose finite and (J, 3), MPJPE finite."""
    model, _ = served_model_of(cfg_path)
    cfg = eval_config(cfg_path, *eval_data)
    ds = build_dataset(cfg.data['test'])
    expect = shift_expect(convs)
    with per_batch_counts(model, expect) as batches:
        outs = run_test(model, ds, cfg, batch_size=4, progress=False,
                        device_preprocess=True)
    labels = {count_label(k): n for k, n in expect.items()}
    for i, got in enumerate(batches):
        assert within(got, labels, K4_PER_REQUEST), (i, got)
    assert len(batches) == len(ds) // 4
    assert sum(len(o['poses']) for o in outs) > 0, 'no person found'
    for o in outs:
        assert np.isfinite(o['poses']).all() and \
            o['poses'].shape[1:] == (EVAL_J, 3)
    assert np.isfinite(ds.evaluate(outs)['mpjpe_mm'])


EVAL_MEAN = np.array([123.675, 116.28, 103.53])
EVAL_STD = np.array([58.395, 57.12, 57.375])


def preprocessed_batch(eval_data):
    """The first 4 eval frames as ``imread`` reads them, and their device
    preprocessing (1080x1920 -> 640x1138 -> 640x1152, on the card) with
    its sizes and scale factors."""
    from das_tpu_torch.datasets.pipelines import _rescale_size
    from das_tpu_torch.ops.preprocess import make_preprocess_fn
    from das_tpu_torch.utils.image import imread
    root, _ = eval_data
    paths = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.endswith('.png'))
    raws = [imread(p) for p in paths]
    h, w = raws[0].shape[:2]
    nh, nw = _rescale_size(h, w, (1333, 640))
    ph, pw = -(-nh // 32) * 32, -(-nw // 32) * 32
    pre = make_preprocess_fn((h, w), (nh, nw), (ph, pw), EVAL_MEAN,
                             EVAL_STD)
    with torch.inference_mode():
        img = pre(torch.from_numpy(np.stack(raws[:4])).cuda())
    sf = torch.tensor([[nw / w, nh / h]] * 4, device='cuda')
    return paths, raws, img.clone(), sf, (h, w, nh, nw, ph, pw)


def test_device_preprocess_against_float64(cuda, eval_data):
    """The PNG reader equals ``imread`` bit for bit on the frames; the
    device preprocessing of one B=4 batch (1080x1920 -> 640x1138 ->
    640x1152) against a float64 numpy reference of the same half-pixel
    resize, BGR->RGB, normalisation and padding: within 1e-4 in normalised
    units (TF32 or a wrong tap would be far off)."""
    from das_tpu_torch.utils.image import read_png
    paths, raws, img, _, (h, w, nh, nw, ph, pw) = \
        preprocessed_batch(eval_data)
    for p, raw in zip(paths, raws):
        with open(p, 'rb') as fh:
            assert np.array_equal(read_png(fh.read(), p), raw), p
    assert (nh, nw, ph, pw) == (640, 1138, 640, 1152)
    got = img.cpu().numpy()
    mean, std = EVAL_MEAN, EVAL_STD

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
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4


def test_fuse_conv_bn_at_full_width(cuda, eval_data):
    """``fuse_conv_bn`` on exp_panoptic_tpu at full width: an f32 model
    (seeded, offsets perturbed, cls bias 0) against its fused copy on the
    preprocessed B=4 640x1152 eval frames, TF32 off: the same people per
    image (some), scores within EVAL_SCORE_TOL, poses within
    EVAL_POSE_RTOL."""
    import copy
    from das_tpu_torch.apis.inference import results_to_host
    from das_tpu_torch.models.fuse import fuse_conv_bn
    model, cfg = init_model(SERVING_CFG, device='cuda', seed=4)
    perturb_offsets(model, seed=3)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    fused, pairs = fuse_conv_bn(copy.deepcopy(model))
    assert pairs > 0
    head = cfg.model.bbox_head
    args = (cfg.model.test_cfg, head.num_joints, head.strides)
    _, _, img, sf, _ = preprocessed_batch(eval_data)
    paths = [f'image {i}' for i in range(4)]
    with no_tf32():
        ref = results_to_host(make_predict_fn(model, *args, device='cuda')(
            img, sf), paths)
        got = results_to_host(make_predict_fn(fused, *args, device='cuda')(
            img, sf), paths)
    assert people_agree(ref, got, 'fused vs unfused') > 0


def test_run_test_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``run_test`` (device preprocessing) at a cut size, the same f32
    weights on the card (kernels) and on the CPU (plain versions): 2
    synthetic 320x240 frames at img_scale (320, 256), cls bias 0. The same
    people per image (some), within the kernel path's tolerances."""
    data = write_eval_data(str(tmp_path / 'cut'), 2, 240, 320, seed=7)
    cfg = eval_config(SERVING_CFG, *data, img_scale=(320, 256))
    cpu, _ = init_model(SERVING_CFG, device='cpu', seed=5)
    perturb_offsets(cpu, seed=6)
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()
    gpu, _ = init_model(SERVING_CFG, device='cuda', seed=5)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    ds = build_dataset(cfg.data['test'])
    kw = dict(batch_size=2, progress=False, device_preprocess=True)
    ref = run_test(cpu, ds, cfg, **kw)
    with no_tf32():
        got = run_test(gpu, ds, cfg, **kw)
    assert people_agree(ref, got, 'card vs CPU') > 0


def test_test_cli_on_the_card(cuda, eval_data, tmp_path):
    """``python -m das_tpu_torch.tools.test`` on exp_panoptic_tpu and the
    synthetic frames, as a user runs it: exit 0 and one finite MPJPE."""
    root, ann = eval_data
    cmd = [sys.executable, '-m', 'das_tpu_torch.tools.test', SERVING_CFG,
           '--cfg-options', f'data.test.ann_file={ann}',
           f'data.test.img_prefix={root}', '--device-preprocess', '--eval',
           'mpjpe', '--res-folder', str(tmp_path / 'results')]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.splitlines()
    mpjpe = [float(x.split()[1]) for x in lines if x.startswith('mpjpe_mm ')]
    assert proc.returncode == 0 and len(mpjpe) == 1 and \
        math.isfinite(mpjpe[0]), (proc.returncode, lines[-5:],
                                  proc.stderr[-2000:])


# --------------------------------------------------- training at width

K4_LAUNCHERS = ('gather_grouped_cuda', 'scatter_grouped_cuda',
                'sample_rows_bilinear_cuda',
                'sample_rows_bilinear_backward_cuda')


def k4_plain():
    """K4's plain versions in the order of K4_LAUNCHERS."""
    return (gather.gather_grouped_plain, gather.scatter_grouped_plain,
            gather._sample_plain, gather.sample_rows_bilinear_backward_plain)


@contextlib.contextmanager
def k4_launchers(*launchers):
    """Within the block, K4's launchers on CUDA tensors (the grouped
    gather and adjoint, through which the one-segment gathers go too, and
    the sampler's pair) are ``launchers``, in K4_LAUNCHERS' order."""
    saved = [getattr(gather, k) for k in K4_LAUNCHERS]
    for k, f in zip(K4_LAUNCHERS, launchers):
        setattr(gather, k, f)
    try:
        yield
    finally:
        for k, f in zip(K4_LAUNCHERS, saved):
            setattr(gather, k, f)


class Seen(list):
    """A witness's records, and its (gather, adjoint, sample, sample
    backward) launches."""

    def __init__(self):
        super().__init__()
        self.launches = [0, 0, 0, 0]


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err / scale if scale else (0.0 if err == 0 else math.inf)


def k4_witness(seen):
    """K4's launchers, each also holding its result against the plain
    version on the very same inputs. ``seen`` gets one (direction, N, R, C,
    P, dtype, max err / max|ref|) per segment of a gather launch, per table
    of an adjoint launch, per sample and per output of a sample backward; a
    forward's error is 0 where it is equal bit for bit and inf
    otherwise."""
    kernel = [getattr(gather, k) for k in K4_LAUNCHERS]
    plain = k4_plain()

    def forward(tables, idxs):
        outs = kernel[0](tables, idxs)
        wants = plain[0](tables, idxs)
        seen.launches[0] += 1
        for t, i, o, w in zip(tables, idxs, outs, wants):
            seen.append(('forward', *t.shape, i.shape[1], t.dtype,
                         0.0 if torch.equal(o, w) else math.inf))
        return outs

    def backward(grads, idxs, which, rows, dtypes):
        gots = kernel[1](grads, idxs, which, rows, dtypes)
        wants = plain[1](grads, idxs, which, rows, dtypes)
        seen.launches[1] += 1
        for u, (got, want) in enumerate(zip(gots, wants)):
            assert (got is None) == (want is None), 'K4 backward: a table'
            if got is not None:
                N, R, C = got.shape
                P = sum(i.shape[1] for i, w, g in zip(idxs, which, grads)
                        if w == u and g is not None)
                seen.append(('backward', N, R, C, P, dtypes[u],
                             rel_err(got, want)))
        return gots

    def sample(flat, x, y, H, W, mask=None):
        out = kernel[2](flat, x, y, H, W, mask)
        want = plain[2](flat, x, y, H, W, mask)
        seen.launches[2] += 1
        seen.append(('sample', *flat.shape, x.shape[1], flat.dtype,
                     0.0 if torch.equal(out, want) else math.inf))
        return out

    def sample_backward(grad, flat, x, y, H, W, needs):
        gots = kernel[3](grad, flat, x, y, H, W, needs)
        wants = plain[3](grad, flat, x, y, H, W, needs)
        seen.launches[3] += 1
        for name, got, want in zip(('image', 'x', 'y'), gots, wants):
            assert (got is None) == (want is None), name
            if got is not None:
                seen.append((f'sample backward {name}', *flat.shape,
                             x.shape[1], flat.dtype, rel_err(got, want)))
        return gots
    return forward, backward, sample, sample_backward


def reordered_scatter(seed):
    """K4's plain adjoint (``gather.scatter_grouped_plain``) with the rows of
    each segment added in a shuffled order (one permutation of its points
    from ``seed``, the same for every image): the same sums as K4's adjoint
    and ``index_add_``, taken in another order."""
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


def reordered_sample_backward(seed):
    """The sampler's closed-form backward with each call's points in a
    shuffled order (one permutation from ``seed``, the same for every
    image): the image gradient's sums taken in another order, dx and dy
    put back in the points' order."""
    gen = None

    def backward(grad, flat, x, y, H, W, needs):
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        p = torch.randperm(x.shape[1], device=x.device, generator=gen)
        dflat, dx, dy = gather.sample_rows_bilinear_backward_plain(
            grad[:, p], flat, x[:, p], y[:, p], H, W, needs)
        back = torch.argsort(p)
        return (dflat, None if dx is None else dx[:, back],
                None if dy is None else dy[:, back])
    return backward


@contextlib.contextmanager
def k1_backward(backward):
    """Within the block, K1's backward on the card (``dcn_shift.
    deform_conv_shift_backward_cuda``, which the wrapper looks up at each
    call) is ``backward``."""
    saved = dcn_shift.deform_conv_shift_backward_cuda
    dcn_shift.deform_conv_shift_backward_cuda = backward
    try:
        yield
    finally:
        dcn_shift.deform_conv_shift_backward_cuda = saved


def plain_backward_on_card(x, offset, mask, weight, grad, radius=1,
                           needs=(True,) * 5, K=3, padding=1):
    """K1's backward replaced by autograd through the plain shift expansion
    ``_deform_conv_shift`` at the same inputs, on the card."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                    weight)]
        bias = torch.zeros(weight.shape[-1], dtype=x.dtype, device=x.device,
                           requires_grad=True)
        out = deform_conv._deform_conv_shift(*ins, bias, K, padding, radius)
        grads = torch.autograd.grad(out, ins + [bias], grad)
    return tuple(g if n else None for g, n in zip(grads, needs))


def k1_witness(seen):
    """K1's backward, each call also holding its result against the closed
    form on the very same inputs: ``seen`` gets one (N, H, W, Cin, Cout,
    dtype, max over the outputs of err / max|ref|) a call."""
    kernel = dcn_shift.deform_conv_shift_backward_cuda

    def backward(x, offset, mask, weight, grad, radius=1,
                 needs=dcn_shift.ALL, K=3, padding=1):
        got = kernel(x, offset, mask, weight, grad, radius, needs, K,
                     padding)
        want = dcn_shift.deform_conv_shift_backward_plain(
            x, offset, mask, weight, grad, radius, needs, K, padding)
        worst = 0.0
        for g, w in zip(got, want):
            assert (g is None) == (w is None), 'K1 backward: an output'
            if g is not None:
                worst = max(worst, rel_err(g, w))
        seen.append((*x.shape, weight.shape[-1], x.dtype, worst))
        return got
    return backward


def full_width_run(cfg_path, steps):
    """``steps`` train steps of ``cfg_path`` at its train bucket, B=4, bf16
    compute on f32 master weights, on a synthetic TrainLoader batch (8
    people an image, one per regress range in turn), K1's backward and the
    plain shift expansion counted: each step's launches (STEP_COUNTS), K1
    backward calls on the tiled pass, plain shift calls, one-pass
    BatchNorm launches (``bn``) and metrics; the
    frozen parameters before and after. Returns the run."""
    cfg = Config.fromfile(cfg_path)
    head = cfg.model.bbox_head
    H, W = train_pad_hw(cfg.train_pipeline)
    B = 4
    state, step, _, max_pos = trainer(cfg, torch.bfloat16, 'cuda', B, (H, W))
    model = state.model
    trainable = frozen_mask(model, mspn_frozen_prefixes(
        int(cfg.model.backbone.frozen_stages)))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    host_batch = synthetic_batch(B, H, W, int(head.num_joints),
                                 int(head.root_idx))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch.items()}
    plain_shift = deform_conv._deform_conv_shift
    plain_calls = [0]

    def counted_plain(*a, **k):
        plain_calls[0] += 1
        return plain_shift(*a, **k)
    run = dict(model=model, cfg=cfg, batch=host_batch,
               featmaps=featmaps_of((H, W)), max_pos=max_pos,
               per_step=train_step_launches(cfg, (H, W), max_pos),
               launches=[], tiled=[], plain_calls=[], metrics=[], bn=[])
    deform_conv._deform_conv_shift = counted_plain
    try:
        for _ in range(steps):
            c0, kt0, p0 = (step_counts(), dcn_shift.backward_tiled_launches,
                           plain_calls[0])
            b0 = bn_act.launches
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            run['bn'].append(bn_act.launches - b0)
            run['launches'].append(tuple(
                b - a for a, b in zip(c0, step_counts())))
            run['tiled'].append(dcn_shift.backward_tiled_launches - kt0)
            run['plain_calls'].append(plain_calls[0] - p0)
            run['metrics'].append({k: float(v) for k, v in metrics.items()})
    finally:
        deform_conv._deform_conv_shift = plain_shift
    run['frozen_same'] = all(torch.equal(p, before[k])
                             for k, p in model.named_parameters()
                             if trainable[k] == 0.0)
    run['moved'] = sum(not torch.equal(p, before[k])
                       for k, p in model.named_parameters()
                       if trainable[k] == 1.0)
    run['trainable'] = sum(trainable.values())
    return run


def hold_steps(run, k1):
    """A full-width run's steps: every metric finite, each step's launches
    ``train_step_launches``'s, no one-pass BatchNorm (autograd records every
    BatchNorm of a step, the frozen stem's too) and no plain shift
    expansion; with ``k1``
    every K1 backward call on the tiled pass; the frozen parameters
    unchanged bit for bit and most trainable ones moved."""
    for i, (got, m) in enumerate(zip(run['launches'], run['metrics'])):
        assert all(math.isfinite(v) for v in m.values()), (i, m)
        assert got == run['per_step'], (i, got, run['per_step'])
        assert run['plain_calls'][i] == 0, i
        assert run['bn'][i] == 0, (i, run['bn'])
        if k1:
            assert run['tiled'][i] == run['per_step'][5], (i, run['tiled'])
    assert run['frozen_same'], 'a frozen parameter moved'
    assert run['moved'] > 0.5 * run['trainable'], run['moved']


@pytest.mark.parametrize('cfg_path', [PANOPTIC_CFG, MUPOTS_CFG, HRNET_CFG],
                         ids=['exp_panoptic', 'exp_mupots',
                              'exp_panoptic_hrnet48'])
def test_train_step_takes_no_one_pass_batchnorm(cuda, cfg_path):
    """Two B=2 train steps of each recipe at 256x384 (bf16 on f32 masters,
    its frozen stem in eval mode) launch no one-pass BatchNorm: autograd
    records every BatchNorm of a step. The model in eval under
    ``inference_mode`` then launches one a BatchNorm."""
    cfg = Config.fromfile(cfg_path)
    head = cfg.model.bbox_head
    state, step, _, _ = trainer(cfg, torch.bfloat16, 'cuda', 2, (256, 384))
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        2, 256, 384, int(head.num_joints), int(head.root_idx)).items()}
    assert any(not m.training for m in state.model.modules()
               if isinstance(m, BatchNorm))
    before = bn_act.launches
    for _ in range(2):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert bn_act.launches == before
    assert all(math.isfinite(float(v)) for v in metrics.values())
    model = state.model.eval()
    with torch.inference_mode():
        model.extract_feat(batch['img'])
    torch.cuda.synchronize()
    assert bn_act.launches - before == batchnorms(cfg)


def k4_gradient_pass(run, dtype):
    """Full depth, full width: the gradient pass of a run's step (its model
    after the steps, its B=4 batch) on the card, with K4 and with K4's
    plain pair in its place, in ``dtype``.

    Five passes: K4 with each launch held against the plain version on its
    own inputs (the gathers and samples bit for bit, the adjoints and the
    sample backwards within 1e-5 (f32) or one bf16 step (bf16) of max|ref|),
    then plain (the plain gather, the adjoint by ``index_add_``, the plain
    composition and the closed-form sample backward, on the card), plain
    again, K4 again, and plain with the rows of each adjoint segment and
    the points of each sample backward added in a shuffled order. The
    launches are the step's; the loss terms equal; each leaf's K4-vs-plain
    error within GRAD_NOISE times the largest of the plain-vs-plain,
    K4-vs-K4 and reordered-vs-plain errors of that leaf, or within 1e-3 of
    the leaf's largest plain gradient where that is more; a leaf that is
    zero to rounding within ZERO_GRAD of the largest of all. The reordered
    pass is there because each adjoint's atomics land in nearly the same
    order every time it runs, so two runs of one adjoint can agree far more
    closely than K4's and ``index_add_``'s orders do."""
    model, cfg = run['model'], run['cfg']
    args = (cfg, run['batch'], run['featmaps'], run['max_pos'])
    plain = k4_plain()
    keep_master_weights(model, dtype)
    try:
        seen = Seen()
        with k4_launchers(*k4_witness(seen)):
            la, ga = loss_grads(model, *args)
        with k4_launchers(*plain):
            lb, gb = loss_grads(model, *args)
            _, gc = loss_grads(model, *args)
        _, gd = loss_grads(model, *args)
        with k4_launchers(plain[0], reordered_scatter(0), plain[2],
                          reordered_sample_backward(0)):
            _, ge = loss_grads(model, *args)
    finally:
        keep_master_weights(model, torch.bfloat16)
    tol = 1e-5 if dtype == torch.float32 else BF16_STEP
    fwd = [s for s in seen if s[0] in ('forward', 'sample')]
    bwd = [s for s in seen if s[0] not in ('forward', 'sample')]
    assert fwd and bwd
    assert all(s[-1] == 0.0 for s in fwd), \
        [s for s in fwd if s[-1] != 0.0][:3]
    assert all(s[-1] <= tol for s in bwd), max(bwd, key=lambda s: s[-1])
    assert seen.launches == list(run['per_step'][:4]), seen.launches
    assert la == lb, (la, lb)
    grads_vs_plain(ga, gb, gc, gd, ('K4', dtype), leaf_errors(ge, gb))


class TestPanopticTpuTraining:
    """exp_panoptic_tpu ('shift' DCNs: K1 forward and backward, K4 in the
    RU) at its 640x1344 bucket: 5 steps, and the gradient passes."""

    @pytest.fixture(scope='class')
    def run(self, cuda):
        yield full_width_run(SERVING_CFG, 5)
        torch.cuda.empty_cache()

    def test_steps_launch_what_the_config_derives(self, run):
        """Under the head's remat a step makes 8 + 4 K4 gathers (the RU's
        take_at and its recompute) and adjoints, 16 + 8 samples and sample
        backwards, 32 + 16 K1 (every DCN conv's forward, its recompute and
        its backward), every K1 backward on its tiled pass."""
        assert run['per_step'] == (8, 4, 16, 8, 32, 16)
        hold_steps(run, k1=True)

    @pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                             ids=['bf16', 'f32'])
    def test_gradient_pass_k4_against_its_plain_pair(self, run, dtype):
        k4_gradient_pass(run, dtype)

    def test_gradient_pass_k1_against_the_plain_expansion(self, run):
        """f32, the gradient pass on the card with K1's backward, and with
        autograd through the plain shift expansion in its place. K1's
        forward runs in both, so the two passes see the same values. Four
        passes: K1 with each backward call held against the closed form on
        its own inputs (within 1e-5 of max|ref|, as many calls as the step
        makes), then plain, plain again and K1 again; the loss terms equal
        and the gradients held as K4's are."""
        model, cfg = run['model'], run['cfg']
        args = (cfg, run['batch'], run['featmaps'], run['max_pos'])
        keep_master_weights(model, torch.float32)
        try:
            seen = []
            with k1_backward(k1_witness(seen)):
                la, ga = loss_grads(model, *args)
            with k1_backward(plain_backward_on_card):
                lb, gb = loss_grads(model, *args)
                _, gc = loss_grads(model, *args)
            _, gd = loss_grads(model, *args)
        finally:
            keep_master_weights(model, torch.bfloat16)
        assert len(seen) == run['per_step'][5]
        assert all(s[-1] <= 1e-5 for s in seen), \
            max(seen, key=lambda s: s[-1])
        assert la == lb, (la, lb)
        grads_vs_plain(ga, gb, gc, gd, 'K1')


class TestPanopticTraining:
    """exp_panoptic's train step, its 'clip' DCNs (K4's sampler and its
    backward at every DCN call), at B=4 640x1344 bf16: 3 steps and the
    gradient pass."""

    @pytest.fixture(scope='class')
    def run(self, cuda):
        yield full_width_run(PANOPTIC_CFG, 3)
        torch.cuda.empty_cache()

    def test_steps_launch_what_the_config_derives(self, run):
        """Under the head's remat 48 + 24 samples and 8 + 4 gathers a step,
        no K1."""
        assert run['per_step'] == (8, 4, 48, 24, 0, 0)
        hold_steps(run, k1=False)

    def test_gradient_pass_k4_against_its_plain_pair(self, run):
        k4_gradient_pass(run, torch.bfloat16)


def test_cut_train_step_card_vs_cpu(cuda):
    """One fp32 step of exp_panoptic_tpu (backbone cut to one stage of one
    block per unit, widths kept) at B=2 128x160 on the card (K4 and K1
    live, the step's launches) and on the CPU (plain), same weights and
    batch, TF32 off: first the loss's gradients, then the step. Loss terms
    rtol 1e-4, grad_norm rtol 1e-3. Each gradient leaf within CARD_CPU_RTOL
    of its largest CPU value (a random-init train-mode step is
    ill-conditioned: a few leaves of the backbone's low-resolution layers
    differ by ~1e-2; a fault moves a leaf by the order of the leaf), a leaf
    zero to rounding on the CPU within 10 x ZERO_GRAD of the largest of all.
    Each update (-lr * lr_mult * trainable * momentum) held the same way,
    the parameters then within that plus one f32 rounding, frozen ones
    unchanged."""
    cfg = cut_train_cfg()
    head = cfg.model.bbox_head
    B, H, W = 2, 128, 160
    cpu, cpu_step, lr_fn, max_pos = trainer(cfg, torch.float32, 'cpu', B,
                                            (H, W), seed=3)
    gpu, gpu_step, _, _ = trainer(cfg, torch.float32, 'cuda', B, (H, W),
                                  seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    batch = synthetic_batch(B, H, W, int(head.num_joints),
                            int(head.root_idx), seed=1)
    args = (cfg, batch, featmaps_of((H, W)), max_pos)
    c0 = step_counts()
    _, gg = loss_grads(gpu.model, *args)
    got = tuple(b - a for a, b in zip(c0, step_counts()))
    gg = {k: v.cpu() for k, v in gg.items()}
    _, gc = loss_grads(cpu.model, *args)
    assert sorted(gg) == sorted(gc)
    assert min(got[:4]) > 0 and \
        got == train_step_launches(cfg, (H, W), max_pos), got
    p0 = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    leaves_close(gg, gc, 'gradient')
    cpu, mc = cpu_step(cpu, batch)
    gpu, mg = gpu_step(gpu, {k: torch.from_numpy(v).cuda()
                             for k, v in batch.items()})
    mc = {k: float(v) for k, v in mc.items()}
    mg = {k: float(v) for k, v in mg.items()}
    for k, v in mc.items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        assert abs(mg[k] - v) <= rtol * abs(v) + 1e-7, (k, mg[k], v)
    lr_mult, _ = param_groups(cpu.model)
    trainable = frozen_mask(cpu.model, mspn_frozen_prefixes(
        int(cfg.model.backbone.frozen_stages)))
    f = {k: -lr_fn(0) * lr_mult[k] * trainable[k] for k in trainable}
    uc = {k: f[k] * m for k, m in cpu.opt_state['momentum'].items()}
    ug = {k: f[k] * m.cpu() for k, m in gpu.opt_state['momentum'].items()}
    u_tol = leaves_close(ug, uc, 'update')
    sc, sg = cpu.model.state_dict(), gpu.model.state_dict()
    for k in uc:
        p = sc[k]
        assert bool(((sg[k].cpu() - p).abs()
                     <= u_tol[k] + torch.finfo(torch.float32).eps * p.abs())
                    .all()), k
        if trainable[k] == 0.0:
            assert torch.equal(p, p0[k]) and torch.equal(sg[k].cpu(), p0[k])


# ------------------------------------------------- training from disk

class TrainWatch:
    """Wraps the step that ``train_model`` builds (``apis/train.py``'s
    ``make_train_step``), its checkpoint manager's save and restore, the
    DCN-offset check, the eval hook's ``run_test`` and its decode, for the
    block. Each step: the counts read just before and just after (K4's
    gathers, adjoints, samples and sample backwards, K1 and its backward,
    K3), a sync, its metrics. The eval model's forward (a module hook: a
    DAS in eval mode) marks the counts, its decode reads what each rose by
    since the mark (a batch's launches). With ``resume_ref`` (a state), the
    first step is also run from that state on the same batch first, its
    losses kept."""

    def __init__(self, expect, resume_ref=None):
        self.expect, self.resume_ref = expect, resume_ref
        self.launches, self.losses, self.saves = [], [], []
        self.restored, self.dcn, self.evals, self.batches = [], [], [], []
        self.ref_losses, self.mark = None, {}

    @contextlib.contextmanager
    def watching(self):
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
            path = real_save(mgr, state, step)
            watch.saves.append(step)
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
            out = real_run(*a, **k)
            watch.evals.append(watch.batches)
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
        def counted(state, batch):
            if not self.launches and self.resume_ref is not None:
                _, m = real(self.resume_ref, batch)
                self.ref_losses = {k: float(v) for k, v in m.items()}
            before = step_counts() + [oks_nms.launches]
            state, metrics = real(state, batch)
            torch.cuda.synchronize()
            after = step_counts() + [oks_nms.launches]
            self.launches.append([b - a for a, b in zip(before, after)])
            self.losses.append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return counted


def restored_equal(mgr, state):
    """The restored state against its file: every model tensor, the
    momentum by name, ``count`` and ``step`` equal bit for bit. Returns the
    step."""
    ckpt = torch.load(mgr.path(mgr.latest_step()), map_location='cpu',
                      weights_only=True)
    sd = state.model.state_dict()
    assert sorted(sd) == sorted(ckpt['model']), 'restore: model keys'
    for k, v in ckpt['model'].items():
        assert torch.equal(sd[k].cpu(), v), ('restore: model tensor', k)
    mom = state.opt_state['momentum']
    assert sorted(mom) == sorted(ckpt['momentum'])
    for k, v in ckpt['momentum'].items():
        assert torch.equal(mom[k].cpu(), v), ('restore: momentum', k)
    assert state.opt_state['count'] == ckpt['count'] and \
        state.step == ckpt['step']
    return state.step


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


# the served launch counts of the eval hook's batches: its model keeps the
# trained offsets, which need not leave radius 1, so 8 fused samples a
# batch and one more per DCN call that repairs
EVAL_HOOK_EXPECT = {(dcn_shift, 'launches'): 16,
                    (dcn_shift, 'wgmma_launches'): 16,
                    (dcn_shift, 'backward_launches'): 0,
                    (oks_nms, 'launches'): 1, (gather, 'launches'): 3,
                    (gather, 'backward_launches'): 0,
                    (gather, 'sampler_launches'): (8, K4_SAMPLES[1]),
                    (gather, 'sampler_backward_launches'): 0}


class TestTrainModel:
    """``train_model`` on exp_panoptic_tpu from the shipped mix on disk
    (8 CMU-Panoptic-format 1920x1080 JPEGs with 3-4 people and 8 COCO-17
    frames at 640x480) through the shipped random pipelines, B=4 640x1344
    bf16 on f32 master weights: TRAIN_STEPS steps of 4 an epoch (the save,
    the DCN-offset check and the eval hook on the eval frames at the epoch
    end, the final save), then a resume from 'latest' for one step."""

    @pytest.fixture(scope='class')
    def run(self, cuda, train_opts, tmp_path_factory):
        from das_tpu_torch.apis import train_model
        cfg = Config.fromfile(SERVING_CFG)
        cfg.merge_from_dict(train_opts)
        work = str(tmp_path_factory.mktemp('train_model') / 'work')
        tiled0 = dcn_shift.backward_tiled_launches
        k1b0 = dcn_shift.backward_launches
        with TrainWatch(EVAL_HOOK_EXPECT).watching() as w:
            state = train_model(cfg, work_dir=work, max_steps=TRAIN_STEPS,
                                log_interval=2)
            torch.cuda.synchronize()
        tiled = (dcn_shift.backward_tiled_launches - tiled0,
                 dcn_shift.backward_launches - k1b0)
        ckpts = sorted(os.listdir(os.path.join(work, 'ckpts')))
        with TrainWatch(EVAL_HOOK_EXPECT, resume_ref=state).watching() as r:
            again = train_model(cfg, work_dir=work, resume_from='latest',
                                max_steps=TRAIN_STEPS + 1, log_interval=2)
            torch.cuda.synchronize()
        steps = (state.step, again.step)
        del state, again
        yield dict(cfg=cfg, work=work, watch=w, resumed=r, steps=steps,
                   tiled=tiled, ckpts=ckpts)
        torch.cuda.empty_cache()

    def test_loader_takes_the_native_path(self, cuda, train_opts):
        """The TrainLoader alone as train_model builds it (the shipped mix,
        its train bucket, its threads): its resizes and warps all through
        the host library, none through cv2."""
        from das_tpu_torch.datasets.loader import (TrainLoader,
                                                   train_pad_hw_from_cfg)
        cfg = Config.fromfile(SERVING_CFG)
        cfg.merge_from_dict(train_opts)
        train = cfg.data['train']
        loader = TrainLoader(build_dataset(train),
                             int(cfg.data.samples_per_gpu),
                             train_pad_hw_from_cfg(train[0]['pipeline']),
                             int(cfg.model.bbox_head.num_joints),
                             num_workers=int(cfg.data.workers_per_gpu),
                             seed=0)
        with resize_and_warp_calls() as calls:
            it = iter(loader)
            for _ in range(4):
                next(it)
            it.close()
        assert calls.get('resize_bilinear', 0) > 0 and \
            calls.get('affine_warp', 0) > 0, calls
        assert not calls.get('resize') and not calls.get('warpAffine'), \
            calls

    def test_steps_launch_what_the_config_derives(self, run):
        """Every loss finite; each step K4's 8 + 4 gathers and 16 + 8
        samples, K1's 32 + 16 launches, no K3; every K1 backward call on
        the tiled pass."""
        w = run['watch']
        assert run['steps'][0] == TRAIN_STEPS == len(w.launches)
        for i, (got, m) in enumerate(zip(w.launches, w.losses)):
            assert all(math.isfinite(v) for v in m.values()), (i, m)
            assert got == list(tpu_step()) + [0], (i, got)
        assert run['tiled'][0] == run['tiled'][1] > 0, run['tiled']

    def test_saves_checks_and_eval_hook(self, run):
        """Saves at the epoch end and the last step; the DCN-offset check at
        each; the eval hook once, its two batches launching a served
        request's counts; the eval and DCN lines in the log; the kept
        checkpoints."""
        w, work = run['watch'], run['work']
        assert w.saves == [4, TRAIN_STEPS]
        assert len(w.dcn) == 2
        assert len(w.evals) == 1 and len(w.evals[0]) == 2, w.evals
        labels = {count_label(k): n for k, n in EVAL_HOOK_EXPECT.items()}
        for i, got in enumerate(w.evals[0]):
            assert within(got, labels), (i, got)
        text = ''.join(open(os.path.join(work, x)).read()
                       for x in os.listdir(work) if x.endswith('.log'))
        assert 'eval @ step 4: MPJPE' in text and \
            'dcn offsets @ step 4' in text
        assert run['ckpts'] == ['meta.json', 'step_00000004.pt',
                                'step_00000006.pt'], run['ckpts']

    def test_resume_from_latest(self, run):
        """The resume restores step TRAIN_STEPS's tensors, count and step
        bit for bit, runs one step whose losses are within RESUME_RTOL of
        the same step from the first run's final state on the same batch,
        and saves it."""
        r = run['resumed']
        assert run['steps'][1] == TRAIN_STEPS + 1
        assert r.launches == [list(tpu_step()) + [0]], r.launches
        assert all(math.isfinite(v) for v in r.losses[0].values())
        assert r.restored == [TRAIN_STEPS]
        worst = max(abs(r.losses[0][k] - v) / max(abs(v), 1e-12)
                    for k, v in r.ref_losses.items() if 'loss' in k)
        assert worst <= RESUME_RTOL, (worst, r.losses[0], r.ref_losses)
        assert r.saves == [TRAIN_STEPS + 1]

    def test_checkpoint_tools(self, run, tmp_path):
        """The run's checkpoints through ``export_torch`` (the latest
        step), ``publish_model`` and ``fuse_conv_bn`` on the card; each
        file loads strictly with ``init_model``; the published file keeps
        no training state."""
        from das_tpu_torch.tools import export_torch, fuse_conv_bn, \
            publish_model
        exported = str(tmp_path / 'exported.pth')
        text, code = run_cli(export_torch, [
            SERVING_CFG, os.path.join(run['work'], 'ckpts'), exported,
            '--device', 'cuda'])
        assert code == 0, text
        text, code = run_cli(publish_model, [exported,
                                             str(tmp_path / 'published.pth')])
        published = text.split()[-1]
        assert code == 0 and os.path.exists(published), text
        fused = str(tmp_path / 'fused.pth')
        text, code = run_cli(fuse_conv_bn, [SERVING_CFG, published, fused,
                                            '--device', 'cuda'])
        assert code == 0 and any(ln.startswith('fused ')
                                 for ln in text.splitlines()), text
        for path in (exported, published, fused):
            init_model(SERVING_CFG, path, device='cuda')
        ckpt = torch.load(published, map_location='cpu', weights_only=False)
        assert not set(ckpt) & {'optimizer', 'momentum', 'count', 'step'}


def test_train_cli_on_the_card(cuda, train_opts, tmp_path):
    """``python -m das_tpu_torch.tools.train`` on exp_panoptic_tpu and the
    mix on disk for 2 steps, as a user runs it: exit 0, step 2 saved."""
    work = str(tmp_path / 'cli')
    cmd = [sys.executable, '-m', 'das_tpu_torch.tools.train', SERVING_CFG,
           '--work-dir', work, '--max-steps', '2', '--cfg-options'] + [
        f'{k}={v}' for k, v in train_opts.items()]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and \
        '[das_tpu_torch] trained to step 2' in proc.stdout and \
        os.path.exists(os.path.join(work, 'ckpts', 'step_00000002.pt')), \
        (proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:])


def run_cli(tool, argv):
    """A port CLI's ``main(argv)`` in this process: (stdout, exit code)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = tool.main(argv)
    return out.getvalue(), code


# ---------------------------------------------------- data parallelism

def replica_mismatches(tensors, group):
    """Elements of ``tensors`` that differ from rank 0's copy (broadcast
    through the same flat buffers as ``replicate``)."""
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
    import torch.distributed as dist
    ref = torch.load(ref_path, weights_only=False)
    B, H, W = ref['batch']['img'].shape[:3]
    share = B // dist.get_world_size(group)
    state, step, _, max_pos = trainer(cut_train_cfg(), torch.float32, dev,
                                      share, (H, W), seed=3, group=group)
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
    """``train_model`` on exp_panoptic_tpu from the mix on disk, this
    rank's DP_BATCH a step of the global batch, bf16 on f32 master weights,
    DP_STEPS steps (one epoch: the save, the DCN-offset check, the sharded
    eval hook). Each step's launches (STEP_COUNTS and K3) and metrics;
    the run's launches and this rank's elements that differ from rank 0's
    replica."""
    import das_tpu_torch.apis.train as train_api
    from das_tpu_torch.apis import train_model
    cfg = Config.fromfile(SERVING_CFG)
    cfg.merge_from_dict(dict(opts, **{'data.samples_per_gpu': DP_BATCH}))
    real_make = train_api.make_train_step
    steps, losses = [], []

    def make(*a, **k):
        real = real_make(*a, **k)

        def counted(state, batch):
            before = kernel_counts()
            state, metrics = real(state, batch)
            torch.cuda.synchronize(dev)
            after = kernel_counts()
            steps.append([after[k] - before[k] for k in STEP_COUNTS
                          + ('oks_nms.launches',)])
            losses.append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return counted

    start = kernel_counts()
    train_api.make_train_step = make
    try:
        state = train_model(cfg, work_dir=work, max_steps=DP_STEPS,
                            log_interval=2, device=dev, group=group)
        torch.cuda.synchronize(dev)
    finally:
        train_api.make_train_step = real_make
    end = kernel_counts()
    mism = replica_mismatches(
        [*state.model.state_dict().values(),
         *state.opt_state['momentum'].values()], group)
    return dict(step=state.step, steps=steps, losses=losses,
                launches={k: end[k] - start[k] for k in KERNEL_COUNTS},
                mismatches=mism)


def dp_eval_job(rank, group, dev, served_path, eval_data):
    """``run_test`` of the served model over the group: this rank sweeps
    frames rank, rank + W, ...; every rank returns all 8."""
    cfg = eval_config(SERVING_CFG, *eval_data)
    return run_test(load_served(served_path, dev),
                    build_dataset(cfg.data['test']), cfg, batch_size=4,
                    progress=False, device_preprocess=True, group=group)


def dp_rank_main(rank, world, backend, devices, store, jobs, out):
    """A spawned rank: join the group through the FileStore at ``store``,
    run each job ``(name, fn, kwargs)`` as ``fn(rank, group, device,
    **kwargs)``, save the results to ``out.<rank>``; on an error save the
    traceback to ``out.<rank>.err`` and exit nonzero."""
    import torch.distributed as dist
    from das_tpu_torch.parallel import init_distributed
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def dp_spawn(tmp, backend, devices, jobs):
    """Spawn one rank per entry of ``devices`` that runs ``jobs``; their
    results by rank. A rank that fails ends the others and the test."""
    out, store = os.path.join(tmp, 'result'), os.path.join(tmp, 'store')
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
    errs = [open(os.path.join(tmp, f)).read()[-3000:]
            for f in sorted(os.listdir(tmp)) if f.endswith('.err')]
    assert codes == [0] * len(devices), (codes, errs)
    return [torch.load(f'{out}.{r}', weights_only=False)
            for r in range(len(devices))]


@pytest.fixture(scope='module')
def parity_ref(cuda, tmp_path_factory):
    """One process's cut fp32 step at B=4 128x160 on the card (TF32 off):
    the weights before it, its batch, metrics, momentum and weights after,
    saved for the ranks; and the lr schedule."""
    cfg = cut_train_cfg()
    head = cfg.model.bbox_head
    B, H, W = 4, 128, 160
    state, step, lr_fn, max_pos = trainer(cfg, torch.float32, DP_DEVICE, B,
                                          (H, W), seed=3)
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
    path = str(tmp_path_factory.mktemp('parity') / 'parity_ref.pt')
    torch.save(ref, path)
    return ref, lr_fn, path


def hold_step(got, ref, lr_fn, what):
    """A step through the group path against ``ref``'s one-process step
    from the same weights: metrics rtol 1e-4 (grad_norm 1e-3), each update
    (-lr * lr_mult * trainable * momentum) within CARD_CPU_RTOL of its
    leaf's largest (``leaves_close``), the weights within that plus one f32
    rounding, frozen weights unchanged."""
    assert got['max_pos'] == ref['max_pos'], what
    for k, v in ref['metrics'].items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        assert abs(got['metrics'][k] - v) <= rtol * abs(v) + 1e-7, \
            (what, k, got['metrics'][k], v)
    cfg = cut_train_cfg()
    model = build_trainable_model(cfg.model, device='cpu')
    lr_mult, _ = param_groups(model)
    trainable = frozen_mask(model, mspn_frozen_prefixes(
        int(cfg.model.backbone.frozen_stages)))
    f = {k: -lr_fn(0) * lr_mult[k] * trainable[k] for k in trainable}
    tol = leaves_close(
        {k: f[k] * m for k, m in got['momentum'].items()},
        {k: f[k] * m for k, m in ref['momentum'].items()}, (what, 'update'))
    for k in trainable:
        p = ref['sd'][k]
        assert bool(((got['sd'][k] - p).abs()
                     <= tol[k] + torch.finfo(torch.float32).eps * p.abs())
                    .all()), (what, k)
        if trainable[k] == 0.0:
            assert torch.equal(got['sd'][k], ref['sd0'][k]), (what, k)


@contextlib.contextmanager
def nccl_world_of_one(tmp):
    """A process group of this process alone over NCCL (through a FileStore
    under ``tmp``), on the card; the group within the block."""
    import torch.distributed as dist
    from das_tpu_torch.parallel import init_distributed
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', LOCAL_WORLD_SIZE='1')
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dev = init_distributed('pytorch', 'nccl',
                               init_method=f'file://{tmp}/nccl1.store')
        assert dist.get_backend() == 'nccl'
        yield dist.group.WORLD, dev
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_nccl_world_of_one(cuda, parity_ref, served_sd, served_outs,
                           eval_data, tmp_path):
    """A NCCL process group of this process alone (the card's own NCCL
    path): the cut fp32 step at B=4 through the group path against the
    same step with no group (``hold_step``), the replica bit-equal; one
    full-width B=4 640x1344 bf16 step of exp_panoptic_tpu over NCCL beside
    the same step without a group, each with the step's K4 and K1
    launches and finite metrics; and ``run_test`` through the group
    against one process's."""
    ref, lr_fn, ref_path = parity_ref
    cfg = Config.fromfile(SERVING_CFG)
    head = cfg.model.bbox_head
    with nccl_world_of_one(str(tmp_path)) as (group, dev):
        one = dp_parity_job(0, group, dev, ref_path)
        assert one['mismatches'] == 0
        hold_step(one, ref, lr_fn, 'NCCL world of one, cut step')
        torch.cuda.empty_cache()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
            4, *TRAIN_HW, int(head.num_joints), int(head.root_idx)).items()}
        for g in (None, group):
            state, step, _, _ = trainer(cfg, torch.bfloat16, dev, 4,
                                        TRAIN_HW, group=g)
            before = step_counts()
            state, metrics = step(state, batch)
            torch.cuda.synchronize(dev)
            n = tuple(b - a for a, b in zip(before, step_counts()))
            assert n == tpu_step(), (g, n)
            assert all(math.isfinite(float(v)) for v in metrics.values())
            del state, step
            torch.cuda.empty_cache()
        cfg = eval_config(SERVING_CFG, *eval_data)
        outs = run_test(load_served(served_sd, dev),
                        build_dataset(cfg.data['test']), cfg, batch_size=4,
                        progress=False, device_preprocess=True, group=group)
    people_agree(served_outs, outs, 'run_test, NCCL world of one')


def test_two_gloo_ranks_on_one_card(cuda, parity_ref, served_sd,
                                    served_outs, eval_data, train_opts,
                                    tmp_path):
    """Two ranks spawned on the one card over gloo (NCCL takes one rank a
    card): the cut fp32 step at B=2 a rank against one process at B=4
    (``hold_step``), replicas bit-equal, both ranks' metrics equal;
    ``train_model`` on the mix at B=2 a rank for one epoch (DP_STEPS
    steps: on each rank every step's K4 and K1 launches the step's and no
    K3, every loss finite and both ranks' equal, replicas and momentum
    bit-equal, one checkpoint by rank 0, the DCN check and the sharded eval
    hook in rank 0's log, every kernel of the path launched); the sharded
    ``run_test`` against one process's, both ranks' lists equal."""
    ref, lr_fn, ref_path = parity_ref
    served_path = str(tmp_path / 'served.pt')
    torch.save(served_sd, served_path)
    work = str(tmp_path / 'work')
    ranks = tmp_path / 'ranks'
    ranks.mkdir()
    gloo = dp_spawn(str(ranks), 'gloo', [DP_DEVICE, DP_DEVICE], [
        ('parity', dp_parity_job, dict(ref_path=ref_path)),
        ('train', dp_train_job, dict(opts=train_opts, work=work)),
        ('eval', dp_eval_job, dict(served_path=served_path,
                                   eval_data=eval_data))])
    par = [r['parity'] for r in gloo]
    assert [p['mismatches'] for p in par] == [0, 0]
    assert par[0]['metrics'] == par[1]['metrics']
    hold_step(par[0], ref, lr_fn, 'W=2 gloo, cut step')
    tr = [r['train'] for r in gloo]
    assert [t['step'] for t in tr] == [DP_STEPS] * 2
    assert [t['mismatches'] for t in tr] == [0, 0]
    assert tr[0]['losses'] == tr[1]['losses']
    for t in tr:
        assert t['steps'] == [list(tpu_step()) + [0]] * DP_STEPS, t['steps']
        assert all(math.isfinite(v) for m in t['losses'] for v in m.values())
        n = t['launches']
        assert n['dcn_shift.launches'] > 0 and n['oks_nms.launches'] > 0 \
            and n['gather.launches'] > 0 and n['gather.sampler_launches'] > 0
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == \
        ['meta.json', f'step_{DP_STEPS:08d}.pt']
    logs = [x for x in os.listdir(work) if x.endswith('.log')]
    text = ''.join(open(os.path.join(work, x)).read() for x in logs)
    assert len(logs) == 1 and f'eval @ step {DP_STEPS}: MPJPE' in text and \
        f'dcn offsets @ step {DP_STEPS}' in text
    evals = [r['eval'] for r in gloo]
    people_agree(served_outs, evals[0], 'run_test, 2 ranks over gloo')
    for a, b in zip(*evals):
        assert all(np.array_equal(a[k], b[k]) for k in ('poses', 'centers'))
        assert a['scores'] == b['scores']


def test_torchrun_two_ranks_on_one_card(cuda, train_opts, tmp_path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2
    -m das_tpu_torch.tools.train ... --launcher pytorch --dist-backend
    gloo --device cuda:0`` for 2 steps: exit 0, step 2 saved by rank 0."""
    work = str(tmp_path / 'cli')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc-per-node', '2', '-m', 'das_tpu_torch.tools.train',
           SERVING_CFG, '--work-dir', work, '--launcher', 'pytorch',
           '--dist-backend', 'gloo', '--device', DP_DEVICE, '--max-steps',
           '2', '--cfg-options', f'data.samples_per_gpu={DP_BATCH}'] + [
        f'{k}={v}' for k, v in train_opts.items()]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0 and \
        '[das_tpu_torch] trained to step 2 on 2 rank(s)' in proc.stdout and \
        os.path.exists(os.path.join(work, 'ckpts', 'step_00000002.pt')), \
        (proc.returncode, proc.stdout[-2000:], proc.stderr[-3000:])


def test_train_model_over_nccl_one_card_a_rank(cuda, train_opts, tmp_path):
    """``train_model`` over NCCL with one card a rank: DP_STEPS steps,
    replicas bit-equal. NCCL takes one rank a card, so this needs two."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two cards: NCCL takes one rank a card')
    ranks = tmp_path / 'ranks'
    ranks.mkdir()
    nccl = dp_spawn(str(ranks), 'nccl', [None, None], [
        ('train', dp_train_job, dict(opts=train_opts,
                                     work=str(tmp_path / 'work')))])
    tn = [r['train'] for r in nccl]
    assert [t['mismatches'] for t in tn] == [0, 0]
    assert [t['step'] for t in tn] == [DP_STEPS] * 2


# ---------------------------------------------------------------- tools

def warp_reference(src, trans, out_hw, border):
    """cv2.warpAffine's INTER_LINEAR with a constant border, exactly, in
    float64: (the warped image, the mask of output pixels whose four taps
    all lie inside the source)."""
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


def test_host_library_against_cv2(cuda):
    """The port's C++ host library (``datasets/native.py``) on the card
    host, a smooth 1920x1080 float32 frame (a 27x48 random grid upsampled
    bilinearly, as smooth as a camera's): the resize to the serving scale
    (640x1138) within 0.51 of ``cv2.resize``; the training warp
    (GlobalRotScaleTransPose's affine at a 20 degree rotation, scale 1.1,
    the config's border) within 1e-3 of the exact warp in float64
    everywhere, and within 0.5 of ``cv2.warpAffine`` where all four taps
    lie inside the frame (cv2 4.x rounds each sample position to 1/32 of a
    pixel, so at the frame's edge it is off the exact warp by more)."""
    import cv2
    from das_tpu_torch.datasets import native
    from das_tpu_torch.datasets.pipelines import get_affine_transform
    assert native.available(), 'the host library did not load'
    rng = np.random.RandomState(0)
    src = cv2.resize((rng.rand(27, 48, 3) * 255).astype(np.float32),
                     (1920, 1080), interpolation=cv2.INTER_LINEAR)
    trans = get_affine_transform(np.array([960.0, 540.0]) * 1.05,
                                 np.array([1920.0, 1080.0]) * 1.1, 20.0,
                                 [1920, 1080])
    border = [103.53, 116.28, 123.675]
    resized = native.resize_bilinear(src, (640, 1138))
    assert float(np.abs(resized - cv2.resize(
        src, (1138, 640), interpolation=cv2.INTER_LINEAR)).max()) <= 0.51
    warped = native.affine_warp(src, trans, (1080, 1920), border)
    exact, inside = warp_reference(src, trans, (1080, 1920), border)
    assert float(np.abs(warped - exact).max()) <= 1e-3
    diff = np.abs(warped - cv2.warpAffine(
        src, trans, (1920, 1080), flags=cv2.INTER_LINEAR,
        borderValue=border)).max(-1)
    assert float(diff[inside].max()) <= 0.5


@pytest.fixture(scope='module')
def served_ckpt(served_sd, tmp_path_factory):
    """The served weights as a ``.pth`` (f32), and a 640x480 frame."""
    import cv2
    root = tmp_path_factory.mktemp('tools')
    ckpt = str(root / 'served.pth')
    torch.save(dict(state_dict={k: v.float() for k, v in served_sd.items()},
                    meta={}), ckpt)
    frame = str(root / 'frame_640x480.png')
    cv2.imwrite(frame, block_frame(np.random.RandomState(4), 480, 640))
    return ckpt, frame


def demo_people(res):
    """The demo's JSON -> run_test's per-image dict, for people_agree."""
    people = res['people']
    return [dict(scores=[p['score'] for p in people], poses=np.array(
        [p['joints_uvd'] for p in people], np.float32).reshape(-1, EVAL_J,
                                                             3))]


def test_demo_on_the_card_and_the_cpu(cuda, served_ckpt, tmp_path):
    """``python -m das_tpu_torch.tools.demo`` on exp_panoptic_tpu with the
    served weights on a 640x480 frame (-> 853x640, padded 864x640),
    ``--score-thr`` at the config's decode threshold: in bf16 on the card
    as a user runs it, the request launching a served request's counts
    (``shift_expect``, K4 within K4_PER_REQUEST) and people found, finite;
    then in f32 on the card (TF32 off) and on the CPU, whose people agree
    (``people_agree``, some); the CPU launches no kernel."""
    import das_tpu_torch.apis.inference as inf_api
    from das_tpu_torch.tools import demo
    ckpt, img = served_ckpt
    expect = shift_expect(0)
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
    inf_api.make_predict_fn = counted
    try:
        for name, dev, dtype in (('bf16', 'cuda', 'bfloat16'),
                                 ('f32', 'cuda', 'float32'),
                                 ('cpu', 'cpu', 'float32')):
            argv = [SERVING_CFG, ckpt, img, '--device', dev, '--dtype',
                    dtype, '--score-thr', thr, '--out',
                    str(tmp_path / f'demo_{name}.png')]
            with no_tf32() if name == 'f32' else contextlib.nullcontext():
                text, code = run_cli(demo, argv)
            assert code == 0, (name, text)
            out[name] = json.loads(text[:text.rindex('}') + 1])
    finally:
        inf_api.make_predict_fn = real
    labels = {count_label(k): n for k, n in expect.items()}
    assert len(requests) == 3 and within(requests[0], labels,
                                         K4_PER_REQUEST), requests
    assert requests[2] == {k: 0 for k in labels}, requests[2]
    bf16 = out['bf16']
    assert bf16['num_people'] > 0 and all(
        np.isfinite(p['joints_uvd']).all() for p in bf16['people'])
    assert people_agree(demo_people(out['cpu']), demo_people(out['f32']),
                        'demo card vs CPU') > 0


def test_validate_hybrid_on_the_card_and_the_cpu(cuda, served_ckpt):
    """``python -m das_tpu_torch.tools.validate_hybrid`` on the card and
    with ``--device cpu``, the served weights, B=2 256x320 inputs, radius
    1: 16 DCN calls, some pixels flagged, the same flagged pixels per call,
    max|off| within VALIDATE_RTOL relative (the rows the CLI computed), the
    same exit code."""
    import das_tpu_torch.apis.inference as inf_api
    from das_tpu_torch.tools import validate_hybrid
    ckpt, _ = served_ckpt
    real = inf_api.dcn_offset_table
    rows, codes = {}, {}
    for dev in ('cuda', 'cpu'):
        def capture(*a, dev=dev):
            rows[dev] = real(*a)
            return rows[dev]
        inf_api.dcn_offset_table = capture
        try:
            _, codes[dev] = run_cli(validate_hybrid, [
                '--config', SERVING_CFG, '--ckpt', ckpt, '--height', '256',
                '--width', '320', '--radius', '1', '--device', dev])
        finally:
            inf_api.dcn_offset_table = real
    got, want = rows['cuda'], rows['cpu']
    assert len(got) == len(want) == 16 and sum(r[2] for r in want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2], (g, w)
        assert abs(g[1] - w[1]) / max(abs(w[1]), 1e-12) <= VALIDATE_RTOL
    assert codes['cuda'] == codes['cpu']


def test_profiling_trace_of_a_request_names_k1(cuda, served_ckpt, tmp_path):
    """One bf16 request of the demo's frame under ``utils/profiling.trace``
    and a span: the Chrome trace it writes holds the span and 16 kernel
    events named after K1."""
    import glob
    import cv2
    from das_tpu_torch.tools import demo
    from das_tpu_torch.utils import profiling
    ckpt, frame = served_ckpt
    model, cfg = init_model(SERVING_CFG, ckpt, dtype=torch.bfloat16,
                            device='cuda')
    head = cfg.model.bbox_head
    predict = make_predict_fn(model, cfg.model.test_cfg, head.num_joints,
                              head.strides, device='cuda')
    padded, sf = demo.preprocess(cv2.imread(frame))
    x = torch.from_numpy(padded)[None].cuda()
    sf = torch.from_numpy(sf).cuda()
    predict(x, sf)
    log_dir = str(tmp_path / 'trace')
    with profiling.trace(log_dir):
        with profiling.span('demo_request'):
            predict(x, sf)
    files = glob.glob(os.path.join(log_dir, '*.pt.trace.json'))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    k1 = [e for e in events if e.get('cat') == 'kernel'
          and 'dcn_shift' in e.get('name', '')]
    assert len(k1) == 16
    assert any(e.get('name') == 'demo_request' for e in events)


# ------------------------------------------------- the reference recipes

def test_mupots_sweep_and_evaluator(cuda, tmp_path):
    """exp_mupots (21 joints, root 14, a 3-stage MSPN2, two RU layers of
    which the last sparsifies, nms_thr 0.9) served through ``run_test``
    with device preprocessing over a synthetic MuPoTS-3D set (20 frames
    TS1-TS20, 5 batches of B=4 736x1280 bf16), each batch launching a
    request's counts (``serve_launches``, K3 at J=21); people found, poses
    finite (21, 3); the MuPoTS evaluator's 3DPCK of the card's outputs
    finite (random weights: near 0) for each of the 20 sequences."""
    model, cfg = init_model(MUPOTS_CFG, dtype=torch.bfloat16, device='cuda')
    perturb_offsets(model)
    pose_template(model)
    expect = recipe_expect(cfg, MUPOTS_HW)
    root = write_mupots_data(str(tmp_path / 'mupots'))
    cfg.merge_from_dict({
        'data.test.data_root': root, 'data.test.num_workers': 4,
        'data.test.ann_file': os.path.join(root, 'annotations',
                                           'MuPoTS-3D.json')})
    ds = build_dataset(cfg.data['test'])
    with per_batch_counts(model, expect) as batches:
        outs = run_test(model, ds, cfg, batch_size=4, progress=False,
                        device_preprocess=True)
    labels = {count_label(k): v for k, v in expect.items()}
    assert len(batches) == len(ds) // 4
    assert all(b == labels for b in batches), (batches, labels)
    assert sum(len(o['poses']) for o in outs) > 0
    assert all(np.isfinite(o['poses']).all()
               and o['poses'].shape[1:] == (21, 3) for o in outs)
    res = ds.evaluate(outs)
    assert np.isfinite(res['pck_mean']) and np.isfinite(res['pck_mean_abs'])
    assert sum(k.startswith('pck_TS') for k in res) == 20


@pytest.fixture(scope='module')
def muco_opts(tmp_path_factory):
    """exp_mupots's shipped MuCo-3DHP + COCO mix on disk
    (``RepeatDataset(convert_ids='muco')``): 8 synthetic 2048x2048 MuCo
    frames and 8 COCO-17 frames; its ``--cfg-options``."""
    root = str(tmp_path_factory.mktemp('muco'))
    rng = np.random.RandomState(3)
    return {'data.train.0.data_root': root,
            'data.train.0.ann_file': write_muco_data(root, rng),
            'data.train.1.dataset.data_root': root,
            'data.train.1.dataset.img_prefix': root,
            'data.train.1.dataset.ann_file': write_coco_data(root, rng),
            'checkpoint_config.max_keep_ckpts': 1,
            'model.pretrained': None}


def test_mupots_train_model_from_disk(cuda, muco_opts, tmp_path):
    """``train_model`` on exp_mupots from the mix on disk through its random
    pipelines, its 800x1280 bucket, B=4 bf16 on f32 master weights, 3
    steps: each step's launches ``train_step_launches``'s ('clip' DCNs, two
    RU layers, no K1) and no K3, every loss finite, one checkpoint."""
    from das_tpu_torch.apis import train_model
    from das_tpu_torch.datasets.loader import train_pad_hw_from_cfg
    cfg = Config.fromfile(MUPOTS_CFG)
    cfg.merge_from_dict(muco_opts)
    hw = train_pad_hw_from_cfg(cfg.data.train[0].pipeline)
    assert tuple(hw) == MUPOTS_TRAIN_HW
    per_step = train_step_launches(cfg, hw, 128 * 4)
    work = str(tmp_path / 'work')
    with TrainWatch({}).watching() as w:
        state = train_model(cfg, work_dir=work, max_steps=3, log_interval=1)
        torch.cuda.synchronize()
    assert state.step == 3 and len(w.launches) == 3
    for got, m in zip(w.launches, w.losses):
        assert got == list(per_step) + [0], (got, per_step)
        assert all(math.isfinite(v) for v in m.values()), m
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == \
        ['meta.json', 'step_00000003.pt']


def remat_vs_plain(opts, B, hw):
    """exp_mupots's gradient pass at ``B`` ``hw`` bf16, from the same
    weights and batch, with ``remat`` as shipped (the backbone's stages)
    and with ``remat=False``, then a step of each. Four passes (remat,
    plain, plain, remat): the loss terms and the BatchNorm running
    statistics after the first pass of each equal bit for bit (the forward
    is the same computation, and the recompute leaves the statistics
    alone); the gradients held as kernel against plain (GRAD_NOISE times
    each leaf's own pass-to-pass spread, or 1e-3 of its largest). Raises
    torch.cuda.OutOfMemoryError where the plain step does not fit."""
    cfg = Config.fromfile(MUPOTS_CFG)
    cfg.merge_from_dict(opts)
    head = cfg.model.bbox_head
    batch = synthetic_batch(B, *hw, int(head.num_joints),
                            int(head.root_idx), seed=2)
    passes = {}
    for name, on in (('remat', True), ('plain', False)):
        c = Config.fromfile(MUPOTS_CFG)
        c.merge_from_dict(dict(opts, **{'model.backbone.remat': on}))
        state, step, _, max_pos = trainer(c, torch.bfloat16, 'cuda', B, hw,
                                          seed=5)
        args = (c, batch, featmaps_of(hw), max_pos)
        la, ga = loss_grads(state.model, *args)
        stats = {k: v.clone() for k, v in state.model.state_dict().items()
                 if k.endswith(('running_mean', 'running_var'))}
        lb, gb = loss_grads(state.model, *args)
        dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        state, metrics = step(state, dev_batch)
        assert all(math.isfinite(float(v)) for v in metrics.values())
        passes[name] = (la, ga, lb, gb, stats)
        del state, step, ga, gb
        torch.cuda.empty_cache()
    la, ga, ld, gd, sa = passes['remat']
    lb, gb, lc, gc, sb = passes['plain']
    assert la == lb and lc == lb and ld == la, (la, lb)
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sb)
    grads_vs_plain(ga, gb, gc, gd, 'remat')


def test_mupots_remat_against_the_plain_step(cuda, muco_opts):
    """``remat_vs_plain`` at B=4 800x1280, as the recipe ships; where the
    plain step does not fit on the card, at B=2."""
    try:
        remat_vs_plain(muco_opts, 4, MUPOTS_TRAIN_HW)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        remat_vs_plain(muco_opts, 2, MUPOTS_TRAIN_HW)


def test_train_run_tool(cuda, tmp_path):
    """``tools/train_run.py`` in this process on exp_panoptic_tpu for 40
    steps of B=4 512x960 bf16 from 80 synthetic JPEGs (2 epochs: 2 saves,
    the DCN-offset check at each): its artifact parses from its file, its
    losses are finite, it names the card and its last checkpoint; the
    run's K4 adjoint, sample backward and K1 backward launches are
    ``train_step_launches``'s a step, every K1 backward on the tiled pass,
    and at least as many forwards (the DCN checks' forwards beside)."""
    from das_tpu_torch.tools import train_run
    steps = 40
    work, out = str(tmp_path / 'work'), str(tmp_path / 'run.json')
    before = kernel_counts()
    tiled0 = dcn_shift.backward_tiled_launches
    art = train_run.main([
        '--config', SERVING_CFG, '--steps', str(steps), '--images', '80',
        '--workers', '4', '--data-dir', str(tmp_path / 'data'),
        '--work-dir', work, '--out', out])
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in kernel_counts().items()}
    tiled = dcn_shift.backward_tiled_launches - tiled0
    with open(out) as f:
        assert json.load(f) == art
    assert art['finite'] and art['steps'] == steps
    assert art['device'] == torch.cuda.get_device_name(0)
    assert art['checkpoints'][-1] == f'step_{steps:08d}.pt'
    per_step = train_step_launches(Config.fromfile(SERVING_CFG), (512, 960),
                                   128 * 4)
    assert n['gather.backward_launches'] == per_step[1] * steps
    assert n['gather.sampler_backward_launches'] == per_step[3] * steps
    assert n['dcn_shift.backward_launches'] == per_step[5] * steps == tiled
    assert n['gather.launches'] >= per_step[0] * steps
    assert n['gather.sampler_launches'] >= per_step[2] * steps
    assert n['dcn_shift.launches'] >= per_step[4] * steps
