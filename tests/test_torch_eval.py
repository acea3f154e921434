"""The port's evaluation entry point against the JAX package's: device
preprocessing, ``fuse_conv_bn``, the flip-test merge, ``run_test`` through
both sweeps, ``init_model``'s switches and the ``das_tpu_torch.tools.test``
CLI, on the CPU in fp32 (TF32 off).

The model is tests/test_torch_model.py's TINY_MODEL at the Panoptic
evaluator's 15 joints with ``sparse_refine`` and the exact ``'patch'`` DCN
gathers (the serving modes' parity is tests/test_torch_model.py's; the
JAX forward compiles in a third of the time without the Pallas kernel's
interpret mode), with one set of seeded numpy weights in both packages
(``state_dict_from_flax``) and the cls bias at 0, so that people pass
``score_thr``. The data is synthetic Panoptic-format PNGs on disk, built as
tests/test_e2e.py builds its JPEGs. The JAX forwards are jitted once per
module.
"""

import copy
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.apis import test as jtest  # noqa: E402
from das_tpu.config import Config as JConfig  # noqa: E402
from das_tpu.datasets import build_dataset as jbuild_dataset  # noqa: E402
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu.models.fuse import fuse_conv_bn as jfuse_conv_bn  # noqa: E402
from das_tpu.ops import preprocess as jpre  # noqa: E402
from das_tpu_torch.apis import (inference_detector, init_model,  # noqa
                                run_test)
from das_tpu_torch.apis import test as ptest  # noqa: E402
from das_tpu_torch.checkpoint import (load_checkpoint_report,  # noqa: E402
                                      state_dict_from_flax)
from das_tpu_torch.config import Config  # noqa: E402
from das_tpu_torch.datasets import build_dataset  # noqa: E402
from das_tpu_torch.models import build_model  # noqa: E402
from das_tpu_torch.models.fuse import fuse_conv_bn  # noqa: E402
from das_tpu_torch.models.layers import (BatchNorm,  # noqa: E402
                                         DeformConv2d, cast_compute)
from das_tpu_torch.ops import preprocess as pre  # noqa: E402

from test_e2e import make_dataset_on_disk  # noqa: E402
from test_torch_model import (TINY_MODEL, _seeded_tree,  # noqa: E402
                              _tree_shapes)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = 15
PAIRS = [[3, 9], [4, 10], [5, 11], [6, 12], [7, 13], [8, 14]]
IMG_NORM = dict(mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)
TEST_CFG = dict(nms_pre=50, nms_post=10, nms_thr=0.9, score_thr=0.05,
                sparse_refine=True)
TINY15 = copy.deepcopy(TINY_MODEL)
TINY15['bbox_head'].update(num_joints=J, root_idx=2,
                           dcn_gather_mode='patch')
TINY15['bbox_head']['recursive_update']['num_joints'] = J
TINY15['train_cfg'] = dict(code_weight=[1.0, 1.0, 1] + [2] * J * 6)
TINY15['test_cfg'] = TEST_CFG
# the images are 90x120 and the scale fits them to 120x160: both sweeps
# resize (x4/3), and pad to 128x160
IMG_SCALE = (160, 120)
# a decoded person of the port against JAX's: score within SCORE_TOL and
# every joint within POSE_RTOL of the person's largest coordinate (fp32;
# the forwards agree to 1e-4 of each level's largest value,
# tests/test_torch_model.py; 2.1e-3 px seen on a person reaching 160 px)
# the fused forward against the unfused one, relative to each level's
# largest value: folding rounds the weights differently, and a sampling
# offset's change moves the bilinear weights it feeds (1.3e-5 seen on
# this model; the JAX package's own test allows 2e-3)
FUSE_RTOL = 1e-4
SCORE_TOL = 1e-4
POSE_RTOL = 1e-4


def _pipeline(flip=False):
    return [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotationsPose3D', with_pose_3d=True,
             with_label_3d=False),
        dict(type='MultiScaleFlipAug', img_scale=IMG_SCALE, flip=flip,
             flip_pairs=PAIRS,
             transforms=[
                 dict(type='Resize', keep_ratio=True),
                 dict(type='Normalize', **IMG_NORM),
                 dict(type='Pad', size_divisor=32),
                 dict(type='Collect3D', keys=['img', 'gt_poses_3d',
                                              'depths']),
             ])]


def _cfg_dict(root, ann, flip=False):
    return dict(model=TINY15, data=dict(test=dict(
        type='CMUPanopticDataset', ann_file=ann, img_prefix=root,
        pipeline=_pipeline(flip), test_mode=True, norm_depth=True,
        abs_dz=True, depth_factor=1)))


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """make_dataset_on_disk's annotations (3 images of one person) with
    the images as 90x120 PNGs of smooth random colour."""
    root = str(tmp_path_factory.mktemp('eval'))
    ann = make_dataset_on_disk(root, n_images=3)
    import json
    with open(ann) as f:
        d = json.load(f)
    rng = np.random.RandomState(4)
    for im in d['images']:
        im['file_name'] = im['file_name'].replace('.jpg', '.png')
        im['height'], im['width'] = 90, 120
        small = rng.randint(0, 255, (12, 16, 3)).astype(np.float32)
        img = cv2.resize(small, (120, 90), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(os.path.join(root, im['file_name']),
                    img.astype(np.uint8))
    with open(ann, 'w') as f:
        json.dump(d, f)
    return root, ann


@pytest.fixture(scope='module')
def tiny():
    """The JAX model, its seeded tree and jitted forward; the port model
    holding the same weights (eval, fp32, CPU)."""
    jmodel = jbuild_model(TINY15)
    tree = _seeded_tree(_tree_shapes(jmodel), seed=0, offset_std=0.8)
    jvars = {c: jax.tree_util.tree_map(jnp.asarray, t)
             for c, t in tree.items()}
    jfwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    model = build_model(TINY15, device='cpu')
    model.load_state_dict(
        state_dict_from_flax(tree['params'], tree['batch_stats']),
        strict=True)
    return jmodel, jvars, jfwd, model


def _assert_people_agree(got, want, what):
    """Per image: the same number of people and the same scores in the
    same order (within SCORE_TOL); each person's joints within POSE_RTOL
    (of its largest coordinate) of a person of the other side whose score
    is within SCORE_TOL (two nearly equal scores may swap)."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g['poses']) == len(w['poses']), (what, i)
        assert g['image_paths'] == w['image_paths'], (what, i)
        sg, sw = np.asarray(g['scores']), np.asarray(w['scores'])
        np.testing.assert_allclose(sg, sw, atol=SCORE_TOL,
                                   err_msg=f'{what} image {i}')
        for p in range(len(sg)):
            near = np.abs(sw - sg[p]) <= SCORE_TOL
            pose = np.asarray(g['poses'])[p]
            err = np.abs(np.asarray(w['poses'])[near] - pose) \
                .max(axis=(1, 2))
            tol = POSE_RTOL * max(1.0, float(np.abs(pose).max()))
            assert err.min() <= tol, (what, i, p, err.min(), tol)


def test_preprocess_matches_jax():
    """resize_bilinear (down and up, odd sizes), make_preprocess_fn on a
    uint8 batch and affine_warp against the JAX functions: within 1e-5 of
    max(1, |value|). The resize's taps are the JAX matrices' entries."""
    rng = np.random.RandomState(13)
    img = (rng.rand(2, 41, 67, 3) * 255).astype(np.float32)
    for hw in [(24, 40), (90, 101), (41, 30)]:
        want = np.asarray(jpre.resize_bilinear(jnp.asarray(img), *hw))
        got = pre.resize_bilinear(torch.from_numpy(img), *hw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(hw))
    for src, dst in [(41, 24), (67, 101), (1080, 640), (1920, 1138)]:
        lo, hi, w_lo, w_hi = pre._taps_halfpixel(src, dst)
        m = np.zeros((dst, src), np.float32)
        m[np.arange(dst), lo] += w_lo
        m[np.arange(dst), hi] += w_hi
        np.testing.assert_array_equal(
            m, jpre._interp_matrix_halfpixel(src, dst))
    raw = rng.randint(0, 255, (2, 60, 80, 3)).astype(np.uint8)
    args = ((60, 80), (45, 61), (64, 64))
    want = np.asarray(jpre.make_preprocess_fn(*args)(jnp.asarray(raw)))
    got = pre.make_preprocess_fn(*args)(torch.from_numpy(raw)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    img = (rng.rand(2, 40, 60, 3) * 255).astype(np.float32)
    trans = np.array([[[0.95, 0.05, 3.0], [-0.02, 1.05, -2.0]],
                      [[1.1, -0.1, -4.0], [0.07, 0.9, 5.5]]], np.float32)
    border = np.array([100.0, 110.0, 120.0], np.float32)
    want = np.asarray(jpre.affine_warp(jnp.asarray(img), jnp.asarray(trans),
                                       36, 52, border))
    got = pre.affine_warp(torch.from_numpy(img), torch.from_numpy(trans),
                          36, 52, border).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 255)


def test_fuse_conv_bn_matches_jax(tiny):
    """The port fuses as many pairs as the JAX function on the same
    config; the fused forward equals the unfused one within FUSE_RTOL of
    each level's largest value, and the JAX fused tree's forward within
    1e-4 of it (as tests/test_torch_model.py holds the unfused ones)."""
    _, jvars, jfwd, model = tiny
    fused = copy.deepcopy(model)
    fused, n = fuse_conv_bn(fused)
    jfused, jn = jfuse_conv_bn(jvars)
    assert n == jn > 10
    assert not any(isinstance(m, BatchNorm) for m in fused.modules())
    assert fuse_conv_bn(fused)[1] == 0
    img = np.random.RandomState(3).randn(2, 64, 96, 3).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(img))
        got = fused(torch.from_numpy(img))
    jouts = jfwd(jfused, jnp.asarray(img))
    for name, gl, wl, jl in zip(('cls', 'pose', 'ctr', 'ref_uvd'), got,
                                want, jouts):
        for lvl, (g, w, j) in enumerate(zip(gl, wl, jl)):
            scale = max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=FUSE_RTOL,
                                       atol=FUSE_RTOL * scale,
                                       err_msg=f'{name} level {lvl}')
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=f'{name} level {lvl} jax')


def _flip_inputs():
    """tests/test_flip_test.py's people: a direct view and a flipped one
    (mirrored about W=200, two people, one spurious)."""
    def person(x, y, z=2.0):
        pose = np.zeros((J, 3), np.float32)
        pose[:, 0] = x + np.arange(J)
        pose[:, 1] = y + np.arange(J) * 0.5
        pose[:, 2] = z
        return pose
    xs = [40, 50, 60]
    direct = dict(
        poses=np.stack([person(x, 25) for x in xs]),
        centers=np.array([[x, 25, 2.0] for x in xs], np.float32),
        vis=np.ones((3, J), np.float32), scores=[0.9, 0.8, 0.7],
        image_paths=['a'])
    flipped = dict(
        poses=np.stack([person(x + 2, 25) for x in xs]
                       + [person(150, 90)]),
        centers=np.array([[x + 2, 25, 2.0] for x in xs]
                         + [[150, 90, 2.0]], np.float32),
        vis=np.ones((4, J), np.float32), scores=[0.85, 0.8, 0.75, 0.4],
        image_paths=['a'])
    return direct, flipped


def test_flip_merge_matches_jax(monkeypatch):
    """_sample_views, _unflip_result and merge_flip_results equal JAX's on
    tests/test_flip_test.py's inputs; _sweep with a fake predict (a blob
    detector with a +2 px bias) merges the flip views as JAX's does."""
    direct, flipped = _flip_inputs()
    for a, b in [(direct, flipped), (flipped, direct),
                 (direct, dict(flipped, poses=flipped['poses'][:0],
                               centers=flipped['centers'][:0]))]:
        got, want = ptest.merge_flip_results(a, b), \
            jtest.merge_flip_results(a, b)
        for k in ('poses', 'centers'):
            np.testing.assert_array_equal(got[k], want[k])
    for w in (200, 97):
        got = ptest._unflip_result(flipped, w, PAIRS)
        want = jtest._unflip_result(flipped, w, PAIRS)
        for k in ('poses', 'centers'):
            np.testing.assert_array_equal(got[k], want[k])
    sample = dict(img=[np.zeros((4, 4, 3)), np.ones((4, 4, 3))],
                  img_metas=[dict(flip=False), dict(flip=True)],
                  scale_factor=[1.0, 1.0, 1.0, 1.0], extra=[1, 2])
    for s in (sample, dict(img=np.zeros((4, 4, 3)), extra=[1, 2, 3])):
        got, want = ptest._sample_views(s), jtest._sample_views(s)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert np.array_equal(g[k], w[k]) if isinstance(
                    w[k], np.ndarray) else g[k] == w[k]

    H, W = 64, 96

    def fake_make_predict_fn(model, test_cfg, num_joints, strides,
                             device=None):
        def predict(imgs, sfs):
            imgs = np.asarray(imgs)
            B, K = imgs.shape[0], 4
            poses = np.zeros((B, K, num_joints, 3), np.float32)
            valid = np.zeros((B, K), bool)
            centers = np.zeros((B, K, 3), np.float32)
            for b in range(B):
                ys, xs = np.nonzero(imgs[b, :, :, 0] > 0.5)
                cx, cy = xs.mean() + 2.0, ys.mean()
                poses[b, 0, :, :2] = cx, cy
                poses[b, 0, 3, 0], poses[b, 0, 9, 0] = cx + 5, cx - 5
                centers[b, 0] = (cx, cy, 2.0)
                valid[b, 0] = True
            out = dict(scores=np.where(valid, 0.9, 0.0), poses=poses,
                       centers=centers,
                       vis=np.ones((B, K, num_joints), np.float32),
                       valid=valid)
            return {k: torch.from_numpy(np.asarray(v)) for k, v in
                    out.items()}
        return predict

    monkeypatch.setattr(ptest, 'make_predict_fn', fake_make_predict_fn)
    monkeypatch.setattr(jtest, 'make_predict_fn',
                        lambda m, t, j, s: (lambda v, i, f: {
                            k: v.numpy() for k, v in
                            fake_make_predict_fn(m, t, j, s)(i, f).items()}))
    img = np.zeros((H, W, 3), np.float32)
    img[20:30, 30:40] = 1.0
    meta = dict(filename='a.png', ori_shape=(H, W, 3),
                scale_factor=np.ones(4, np.float32))

    def get_sample(i):
        return dict(img=[img, np.ascontiguousarray(img[:, ::-1])],
                    img_metas=[dict(meta, flip=False, flip_pairs=PAIRS),
                               dict(meta, flip=True, flip_pairs=PAIRS)])

    cfg = dict(model=dict(bbox_head=dict(num_joints=J,
                                         strides=[8, 16, 32, 64]),
                          test_cfg=dict(nms_post=4)))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(1))

    got = ptest._sweep(Model(), get_sample, 3, Config(cfg), 2, False)
    want = jtest._sweep(None, None, get_sample, 3, JConfig(cfg), 2, False)
    for g, w in zip(got, want):
        for k in ('poses', 'centers'):
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_allclose(got[0]['centers'][0, 0], 34.5, atol=1e-4)


@pytest.fixture(scope='module')
def sweeps(tiny, data):
    """run_test of both packages, through the host pipeline and through
    device preprocessing, on the same dataset and weights."""
    jmodel, jvars, _, model = tiny
    root, ann = data
    cfg, jcfg = Config(_cfg_dict(root, ann)), JConfig(_cfg_dict(root, ann))
    ds, jds = build_dataset(cfg.data['test']), \
        jbuild_dataset(jcfg.data['test'])
    out = {}
    for dev_pre in (False, True):
        out[dev_pre] = (
            run_test(model, ds, cfg, batch_size=2, progress=False,
                     device_preprocess=dev_pre),
            jtest.run_test(jmodel, jvars, jds, jcfg, batch_size=2,
                           progress=False, device_preprocess=dev_pre))
    return ds, jds, out


@pytest.mark.parametrize('device_preprocess', [False, True])
def test_run_test_matches_jax(sweeps, device_preprocess):
    """run_test through _sweep (host cv2 pipeline) and through
    _device_pre_sweep, port against JAX, 3 images in batches of 2 (the
    last padded): the same people per image (counts equal, scores within
    SCORE_TOL, poses within POSE_RTOL), and MPJPE within 1e-3 mm."""
    ds, jds, out = sweeps
    got, want = out[device_preprocess]
    assert len(got) == len(ds) == 3
    assert sum(len(g['poses']) for g in got) > 0
    _assert_people_agree(got, want, f'device_preprocess={device_preprocess}')
    g, w = ds.evaluate(got), jds.evaluate(want)
    assert np.isfinite(g['mpjpe_mm'])
    assert abs(g['mpjpe_mm'] - w['mpjpe_mm']) <= 1e-3, (g, w)


def test_inference_detector_is_the_device_sweep(tiny, data):
    """inference_detector on one image file (scale (1333, 640): 90x120 ->
    640x853, padded to 640x864) gives what run_test's device sweep gives
    at that scale, and the same for the decoded array."""
    _, _, _, model = tiny
    root, ann = data
    cfg_d = _cfg_dict(root, ann)
    cfg_d['data']['test']['pipeline'][2]['img_scale'] = (1333, 640)
    cfg = Config(cfg_d)
    ds = build_dataset(cfg.data['test'])
    want = run_test(model, ds, cfg, batch_size=1, progress=False,
                    device_preprocess=True)[0]
    path = os.path.join(root, ds.data_infos[0]['file_name'])
    got = inference_detector(model, cfg, path)
    assert len(got['poses']) == len(want['poses']) > 0
    for k in ('poses', 'centers', 'scores'):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    arr = inference_detector(model, cfg, cv2.imread(path))
    np.testing.assert_array_equal(arr['poses'], got['poses'])
    assert arr['image_paths'] == ['<array>']


def test_init_model_switches_and_missing_key_report(tmp_path, capsys):
    """validate_dcn=False keeps the configured DCN mode where offsets far
    beyond the radius would switch it to 'patch'; a checkpoint without
    some keys loads with strict=False (they keep init values, the count is
    printed, the report lists them) and raises with strict=True."""
    served = dict(TINY15, bbox_head=dict(TINY15['bbox_head'],
                                         dcn_gather_mode='hybrid_pallas'))
    cfg = Config(dict(model=served))
    model = build_model(served, device='cpu', seed=3)
    sd = model.state_dict()
    for k in sd:
        if k.endswith('conv_offset.bias'):
            sd[k] = torch.full_like(sd[k], 5.0)
    path = str(tmp_path / 'far.pth')
    torch.save(dict(state_dict=sd), path)
    kept, _ = init_model(cfg, checkpoint=path, device='cpu',
                         validate_dcn=False)
    assert {m.gather_mode for m in kept.modules()
            if isinstance(m, DeformConv2d)} == {'hybrid_pallas'}
    switched, _ = init_model(Config(dict(model=served)), checkpoint=path,
                             device='cpu')
    assert {m.gather_mode for m in switched.modules()
            if isinstance(m, DeformConv2d)} == {'patch'}

    drop = [k for k in sd if k.startswith('bbox_head.cls_convs.0.')]
    part = {k: v for k, v in sd.items() if k not in drop}
    part['extra.weight'] = torch.zeros(1)
    path = str(tmp_path / 'part.pth')
    torch.save(dict(state_dict=part), path)
    fresh = build_model(served, device='cpu', seed=9)
    init = {k: v.clone() for k, v in fresh.state_dict().items()}
    report = load_checkpoint_report(fresh, path, strict=False)
    assert sorted(report['missing']) == sorted(drop)
    assert report['unexpected'] == ['extra.weight']
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, init[k] if k in drop else sd[k]), k
    capsys.readouterr()
    init_model(cfg, checkpoint=path, device='cpu', strict=False,
               validate_dcn=False)
    assert f'checkpoint missing {len(drop)} keys' in capsys.readouterr().out
    with pytest.raises(RuntimeError, match='Missing key'):
        init_model(cfg, checkpoint=path, device='cpu')


def test_cli_evaluates_on_the_cpu(tiny, data, tmp_path):
    """python -m das_tpu_torch.tools.test on a config file of the tiny
    model, --device cpu, --device-preprocess and --fuse-conv-bn, with a
    .pth of the seeded weights (cls bias 0): exit 0, the fused pair count
    and an MPJPE line equal to that of the port's own run_test on the
    fused model in bf16 (the CLI's dtype)."""
    _, _, _, model = tiny
    root, ann = data
    ckpt = str(tmp_path / 'tiny.pth')
    torch.save(dict(state_dict=model.state_dict()), ckpt)
    cfg_path = str(tmp_path / 'tiny_cfg.py')
    with open(cfg_path, 'w') as f:
        d = _cfg_dict(root, ann)
        f.write(f"model = {d['model']!r}\ndata = {d['data']!r}\n")
    res = str(tmp_path / 'res')
    # the CLI fuses in f32 and serves in bf16, as this does
    fused, n = fuse_conv_bn(copy.deepcopy(model))
    cast_compute(fused, torch.bfloat16)
    proc = subprocess.run(
        [sys.executable, '-m', 'das_tpu_torch.tools.test', cfg_path, ckpt,
         '--device', 'cpu', '--device-preprocess', '--fuse-conv-bn',
         '--batch-size', '2', '--res-folder', res, '--eval', 'mpjpe'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert f'[das_tpu_torch] fused {n} conv+bn pairs' in lines
    mpjpe = [float(l.split()[1]) for l in lines if l.startswith('mpjpe_mm')]
    assert len(mpjpe) == 1 and np.isfinite(mpjpe[0])
    assert os.path.exists(os.path.join(res, 'result_keypoints.json'))
    cfg = Config(_cfg_dict(root, ann))
    ds = build_dataset(cfg.data['test'])
    want = ds.evaluate(run_test(fused, ds, cfg, batch_size=2,
                                progress=False, device_preprocess=True))
    assert f"MPJPE: {want['MPJPE:']}" in lines
    assert abs(mpjpe[0] - want['mpjpe_mm']) <= 1e-6 * max(1.0, mpjpe[0])
