"""The port's image decoding, test transforms, datasets and evaluators
against the JAX package's, on the same synthetic on-disk data.

``imread``'s own PNG reader is held bit for bit against ``cv2.imread``;
each test transform, ``MultiScaleFlipAug``, ``CMUPanopticDataset`` (parsed
annotations, samples, ``format_results``, ``evaluate``) and
``MuPots3DHP.evaluate`` give exactly what the JAX package's give: both run
the same numpy and cv2 code on the same files. The data is built as
tests/test_datasets.py, tests/test_e2e.py and tests/test_mupots_evaluate.py
build it.
"""

import copy
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from das_tpu.core import camera as jcamera
from das_tpu.datasets import build_dataset as jbuild_dataset
from das_tpu.datasets import pipelines as jpipes
from das_tpu.datasets.mupots import MuPots3DHP as JMuPots3DHP
from das_tpu_torch.core import camera
from das_tpu_torch.datasets import (CMUPanopticDataset, ConcatDataset,
                                    MuPots3DHP, RepeatDataset,
                                    build_dataset)
from das_tpu_torch.datasets import pipelines as pipes
from das_tpu_torch.utils import image as image_mod
from das_tpu_torch.utils.image import imread, read_png

from test_datasets import make_panoptic_json
from test_mupots_evaluate import _perfect_outputs, make_mupots_root

J = 15
PAIRS = [[3, 9], [4, 10], [5, 11], [6, 12], [7, 13], [8, 14]]
IMG_NORM = dict(mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)


def encode_png(img: np.ndarray, filters) -> bytes:
    """A PNG of ``img`` ((H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8) whose row y carries filter ``filters[y % len(filters)]``."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[bpp]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (a + up) // 2
        else:
            p = a + up - c
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, c))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8)
                   .tobytes())

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    return (image_mod.PNG_SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0,
                                         0))
            + chunk(b'IDAT', zlib.compress(b''.join(out)))
            + chunk(b'IEND', b''))


def png_filters(data: bytes):
    """The set of row filters a PNG file uses."""
    w, h, _, ctype = struct.unpack('>IIBB', data[16:26])
    bpp = {0: 1, 2: 3, 6: 4}[ctype]
    idat, pos = [], 8
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        if kind == b'IDAT':
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    return set(raw.reshape(h, w * bpp + 1)[:, 0].tolist())


def _image(channels, h=23, w=37, seed=0):
    """A smooth gradient plus noise, so that every filter has work."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (3 * xx + 5 * yy)[..., None] + 40 * np.arange(max(channels, 1))
    img = (base + rng.randint(0, 9, (h, w, max(channels, 1)))) % 256
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('filt', [0, 1, 2, 3, 4])
def test_png_reader_matches_cv2_per_filter(tmp_path, channels, filt):
    """Colour types 0, 2 and 6 under each of the five row filters (all
    rows one filter; the first row's 'up' is zero): the reader's array is
    cv2.imread's (IMREAD_COLOR: grey replicated, RGB(A) -> BGR), bit for
    bit."""
    img = _image(channels, seed=filt)
    data = encode_png(img, [filt])
    path = str(tmp_path / 'f.png')
    with open(path, 'wb') as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = read_png(data, path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_reader_matches_cv2_on_cv2_files(tmp_path, channels):
    """Files that cv2.imwrite wrote (its encoder picks a filter row by
    row: Sub alone for grey, several for colour), and rows of all five
    filters mixed in one file of our own."""
    seen = set()
    for seed in range(3):
        img = _image(channels, h=41, w=53, seed=seed)
        path = str(tmp_path / f'cv2_{seed}.png')
        cv2.imwrite(path, img)
        with open(path, 'rb') as f:
            data = f.read()
        seen |= png_filters(data)
        np.testing.assert_array_equal(read_png(data, path),
                                      cv2.imread(path, cv2.IMREAD_COLOR))
    assert seen and seen <= {0, 1, 2, 3, 4}, seen
    mixed = encode_png(_image(channels, seed=9), [4, 0, 3, 1, 2])
    path = str(tmp_path / 'mixed.png')
    with open(path, 'wb') as f:
        f.write(mixed)
    np.testing.assert_array_equal(read_png(mixed, path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_imread_without_cv2_reads_png_and_names_cv2_for_jpeg(
        tmp_path, monkeypatch):
    """With cv2 hidden, imread decodes a PNG itself (equal to what cv2
    gave) and refuses a JPEG with an error that names cv2; a missing file
    is FileNotFoundError either way."""
    img = _image(3, seed=4)
    png = str(tmp_path / 'a.png')
    jpg = str(tmp_path / 'a.jpg')
    cv2.imwrite(png, img)
    cv2.imwrite(jpg, img)
    want_png = imread(png)
    want_jpg = imread(jpg)
    np.testing.assert_array_equal(want_jpg, cv2.imread(jpg))
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / 'missing.png'))
    monkeypatch.setitem(sys.modules, 'cv2', None)     # import cv2 fails
    np.testing.assert_array_equal(imread(png), want_png)
    with pytest.raises(ValueError, match='cv2'):
        imread(jpg)
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / 'missing.png'))
    grey = encode_png(np.zeros((2, 2), np.uint8), [0])
    sixteen = grey[:24] + bytes([16]) + grey[25:]     # IHDR bit depth
    with pytest.raises(ValueError, match='cv2'):
        read_png(sixteen, 'sixteen-bit')


def _assert_same(got, want, what=''):
    """Recursive equality of transform outputs: arrays bit for bit (dtype
    and shape too), containers key by key."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f'{what}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


@pytest.fixture(scope='module')
def panoptic_root(tmp_path_factory):
    """make_panoptic_json's annotations (1920x1080 frames, 2 images of 3
    people) beside real image files: PNGs at 90x160 (so the test scale
    resizes them) under the json's file names."""
    root = str(tmp_path_factory.mktemp('panoptic'))
    ann = make_panoptic_json(root, n_images=2, n_people=3)
    with open(ann) as f:
        data = json.load(f)
    rng = np.random.RandomState(1)
    for im in data['images']:
        im['file_name'] = im['file_name'].replace('.jpg', '.png')
        cv2.imwrite(os.path.join(root, im['file_name']),
                    rng.randint(0, 255, (90, 160, 3)).astype(np.uint8))
    with open(ann, 'w') as f:
        json.dump(data, f)
    return root, ann


def _dataset_cfg(root, ann, flip=False):
    pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotationsPose3D', with_pose_3d=True,
             with_label_3d=False),
        dict(type='MultiScaleFlipAug', img_scale=(160, 120), flip=flip,
             flip_pairs=PAIRS,
             transforms=[
                 dict(type='Resize', keep_ratio=True),
                 dict(type='Normalize', **IMG_NORM),
                 dict(type='Pad', size_divisor=32),
                 dict(type='DefaultFormatBundlePose3D'),
                 dict(type='Collect3D', keys=['img', 'gt_poses_3d',
                                              'depths']),
             ])]
    return dict(type='CMUPanopticDataset', ann_file=ann, img_prefix=root,
                pipeline=pipeline, test_mode=True, norm_depth=True,
                abs_dz=True, depth_factor=1)


def _results(root, ann, idx=0):
    """A pipeline's input dict for image ``idx``, as the dataset makes it."""
    ds = jbuild_dataset(dict(_dataset_cfg(root, ann), pipeline=None))
    ann_info = ds.get_ann_info(idx)
    res = dict(img_info=ds.data_infos[idx], ann_info=ann_info,
               img_prefix=root, bbox_fields=[], img_fields=[],
               pose3d_fields=[])
    return res


def test_each_test_transform_matches_jax(panoptic_root):
    """Load, annotations, Resize, RandomFlipPose3D (flip forced on, and
    off), Normalize, Pad, DefaultFormatBundlePose3D and Collect3D, one
    after another, each on the output of the last: every output array and
    meta equals the JAX transform's, bit for bit."""
    root, ann = panoptic_root
    steps = [
        ('LoadImageFromFile', {}),
        ('LoadAnnotationsPose3D', dict(with_bbox=True, with_label=True)),
        ('Resize', dict(img_scale=(160, 120), keep_ratio=True)),
        ('RandomFlipPose3D', dict(flip_ratio_bev_horizontal=1.0,
                                  flip_pairs=PAIRS, num_joints=J)),
        ('Normalize', IMG_NORM),
        ('Pad', dict(size_divisor=32)),
        ('DefaultFormatBundlePose3D', {}),
        ('Collect3D', dict(keys=['img', 'gt_poses_3d', 'depths',
                                 'gt_bboxes'])),
    ]
    for flip in (True, False):
        mine = _results(root, ann)
        theirs = copy.deepcopy(mine)
        mine['flip'] = theirs['flip'] = flip
        for name, kw in steps:
            mine = getattr(pipes, name)(**kw)(mine)
            theirs = getattr(jpipes, name)(**kw)(theirs)
            _assert_same(mine, theirs, f'{name} flip={flip}')
    assert pipes._rescale_size(1080, 1920, (1333, 640)) == (640, 1138)
    for hw in [(1080, 1920), (90, 160), (241, 97)]:
        assert pipes._rescale_size(*hw, (1333, 640)) == \
            jpipes._rescale_size(*hw, (1333, 640))


@pytest.mark.parametrize('flip', [False, True])
def test_multiscale_flip_aug_matches_jax(panoptic_root, flip):
    """The whole test pipeline through the dataset (MultiScaleFlipAug with
    one view, and with the mirrored second view): samples equal."""
    root, ann = panoptic_root
    cfg = _dataset_cfg(root, ann, flip=flip)
    mine, theirs = build_dataset(cfg), jbuild_dataset(cfg)
    assert len(mine) == len(theirs) == 2
    for i in range(len(mine)):
        got, want = mine[i], theirs[i]
        assert len(got['img']) == (2 if flip else 1)
        _assert_same(got, want, f'sample {i}')


def test_panoptic_dataset_matches_jax(panoptic_root, tmp_path):
    """data_infos, parsed annotations, format_results (the json file) and
    evaluate (MPJPE) on perfect and on noisy predictions, and on an image
    left without predictions (the mean-pose fallback): equal to JAX's."""
    root, ann = panoptic_root
    cfg = dict(_dataset_cfg(root, ann), pipeline=None)
    mine, theirs = build_dataset(cfg), jbuild_dataset(cfg)
    assert isinstance(mine, CMUPanopticDataset)
    assert mine.data_infos == theirs.data_infos
    assert mine.img_ids == theirs.img_ids
    for i in range(len(mine)):
        _assert_same(mine.get_ann_info(i), theirs.get_ann_info(i), f'ann {i}')

    rng = np.random.RandomState(3)
    perfect, noisy = [], []
    for i, info in enumerate(mine.data_infos):
        gt = mine.get_ann_info(i)['gt_poses_3d'][:, 3:3 + 3 * J] \
            .reshape(-1, J, 3).copy()
        gt[..., 2] += mine.get_ann_info(i)['gt_poses_3d'][:, [2]]
        gt[:, CMUPanopticDataset.ROOT_IDX, 2] = \
            mine.get_ann_info(i)['gt_poses_3d'][:, 2]
        path = os.path.join(root, info['file_name'])
        for outs, poses in ((perfect, gt),
                            (noisy, gt + rng.randn(*gt.shape) * [4, 4, 0.01])):
            outs.append(dict(poses=poses.astype(np.float32),
                             scores=list(rng.rand(len(gt))),
                             vis=np.ones((len(gt), J), np.float32),
                             centers=poses[:, 0].astype(np.float32),
                             image_paths=[path]))
    empty = [dict(noisy[0]), dict(noisy[1], poses=np.zeros((0, J, 3)),
                                  scores=[], vis=np.zeros((0, J)))]
    for name, outs in (('perfect', perfect), ('noisy', noisy),
                       ('empty', empty)):
        got = mine.evaluate(outs, res_folder=str(tmp_path / f'm_{name}'))
        want = theirs.evaluate(outs, res_folder=str(tmp_path / f'j_{name}'))
        assert got == want, (name, got, want)
        with open(tmp_path / f'm_{name}' / 'result_keypoints.json') as f:
            got_json = f.read()
        with open(tmp_path / f'j_{name}' / 'result_keypoints.json') as f:
            assert got_json == f.read(), name
    assert mine.evaluate(perfect)['mpjpe_mm'] < 1e-3      # f32 poses
    assert mine.evaluate(noisy)['mpjpe_mm'] > 1.0
    entries, _ = mine.format_results(noisy, res_folder=str(tmp_path / 'f'))
    assert entries == theirs.format_results(
        noisy, res_folder=str(tmp_path / 'g'))[0]


@pytest.fixture(scope='module')
def mupots_root(tmp_path_factory):
    return make_mupots_root(tmp_path_factory.mktemp('mupots_port'),
                            n_seq=20, n_frames=2, n_people=2)


@pytest.mark.parametrize('noise', [0.0, 30.0])
def test_mupots_evaluate_matches_jax(mupots_root, noise, capsys):
    """MuPots3DHP.evaluate on the same TS*/annot.mat root (20 sequences of
    2 frames of 2 people), perfect and noisy predictions: every key equal
    to the JAX evaluator's. The port evaluates in 2 spawned
    worker processes, the JAX one in-process."""
    root, gt = mupots_root
    kw = dict(data_root=root, ann_file='annotations/MuPoTS-3D.json',
              norm_depth=True, abs_dz=True, depth_factor=1, pipeline=None)
    mine = MuPots3DHP(num_workers=2, **kw)
    theirs = JMuPots3DHP(num_workers=1, **kw)
    assert mine.data_infos == theirs.data_infos
    outs = _perfect_outputs(mine, gt)
    rng = np.random.RandomState(int(noise) + 1)
    for o in outs:
        o['poses'] = o['poses'] + noise * rng.randn(*o['poses'].shape) \
            * np.array([1.0, 1.0, 0.001])
    got = mine.evaluate(outs)
    want = theirs.evaluate(outs)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    if noise == 0.0:
        assert got['pck_mean'] > 0.9
    else:
        assert got['pck_mean'] < 1.0
    assert 'TS20' in capsys.readouterr().out


def test_camera_and_wrappers_match_jax(panoptic_root):
    """pixel2world / world2pixel equal JAX's; ConcatDataset and
    RepeatDataset index as JAX's."""
    rng = np.random.RandomState(7)
    x = rng.rand(3, 11) * [[1900], [1000], [500]] + [[0], [0], [100]]
    K = np.array([[1000., 0.5, 960.], [0., 990., 540.], [0., 0., 1.]])
    R = np.linalg.qr(rng.randn(3, 3))[0]
    t = rng.randn(3, 1) * 50
    np.testing.assert_array_equal(camera.pixel2world(x, K, R, t),
                                  jcamera.pixel2world(x, K, R, t))
    np.testing.assert_array_equal(camera.world2pixel(x, K, R, t),
                                  jcamera.world2pixel(x, K, R, t))
    root, ann = panoptic_root
    cfg = dict(_dataset_cfg(root, ann), pipeline=None)
    cat = build_dataset([cfg, dict(type='RepeatDataset', times=2,
                                   dataset=cfg)])
    jcat = jbuild_dataset([cfg, dict(type='RepeatDataset', times=2,
                                     dataset=cfg)])
    assert isinstance(cat, ConcatDataset)
    assert isinstance(cat.datasets[1], RepeatDataset)
    assert len(cat) == len(jcat) == 6
    np.testing.assert_array_equal(cat.cum, jcat.cum)
    assert len(cat.datasets[1]) == len(jcat.datasets[1]) == 4
