"""The port's training data path against the JAX package's, on the CPU.

Each training transform (``ResizePose``, ``RandomFlipPose3D``,
``PhotoMetricDistortion``, ``GlobalRotScaleTransPose``, the multi-scale
``Resize``) gets the same input and a generator ``RandomState(s)`` where
the JAX one runs after ``np.random.seed(s)``, over 12 seeds: the outputs
are equal bit for bit (both run the same numpy and cv2 code) and both have
taken the same number of draws. The datasets (MuCo, COCO with the panoptic
and the muco joint maps, the shipped exp_mupots mix), ``pad_batch`` and
``TrainLoader`` are held the same way on synthetic on-disk data; the
thread and process loaders against each other with the random pipeline.

Both packages take their C++ resize and warp (``datasets/native.py``) for a
float32 HxWx3 image, the JAX package's default path: the port builds its
own copy of ``csrc/das_host.cpp`` with g++, the JAX package loads
``das_tpu/libdas_host.so``. Every case runs twice (the ``host_path``
fixture): with both packages on that native path, where the images agree
within NATIVE_ATOL (bit for bit where both libraries were compiled for the
same instruction set, tests/test_torch_native.py), and with both on cv2
(each package's ``available`` answering False), where they are equal bit
for bit.
"""

import copy
import json
import os

import cv2
import numpy as np
import pytest

from das_tpu.datasets import build_dataset as jbuild_dataset
from das_tpu.datasets import loader as jloader
from das_tpu.datasets import native as jnative
from das_tpu.datasets import pipelines as jpipes
from das_tpu_torch.config import Config
from das_tpu_torch.datasets import (COCOKeypointsDataset, ConcatDataset,
                                    MuCo3DHPDataset, RepeatDataset,
                                    build_dataset)
from das_tpu_torch.datasets import loader
from das_tpu_torch.datasets import native as pnative
from das_tpu_torch.datasets import pipelines as pipes
from das_tpu_torch.tools.profile_train import train_pad_hw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(12)
J = 15
PAIRS = [[3, 9], [4, 10], [5, 11], [6, 12], [7, 13], [8, 14]]
IMG_NORM = dict(mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)
H, W = 96, 128
# the images of the two packages' native paths (pixel levels 0-255, or
# normalised): the same C++ source, compiled apart
NATIVE_ATOL = 1e-3
# the image tolerance of assert_same on the current path (0: bit for bit)
IMG_ATOL = {'img': 0.0}
NATIVE_AVAILABLE = pnative.available


@pytest.fixture(autouse=True, params=['native', 'cv2'])
def host_path(request, monkeypatch):
    """Both packages on their native resize and warp (the default), or both
    on cv2 (each ``available`` answering False)."""
    if request.param == 'native':
        assert jnative.available() and pnative.available()
        monkeypatch.setitem(IMG_ATOL, 'img', NATIVE_ATOL)
    else:
        monkeypatch.setattr(jnative, 'available', lambda: False)
        monkeypatch.setattr(pnative, 'available', lambda: False)
    return request.param


def _image(rng, h, w):
    blocks = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(blocks, np.ones((8, 8, 1), np.int64))[:h, :w]
    return (img + rng.randint(0, 24, (h, w, 3))).clip(0, 255) \
        .astype(np.uint8)


def _centres(i, n, h, w, edge):
    """Person roots of image ``i``: ``n`` well inside, or (``edge``) near
    the border, where the random warp often pushes them out."""
    if edge:
        return [(4.0 + 3 * p, h - 5.0) for p in range(n)]
    return [(w * (0.3 + 0.4 * p / max(n - 1, 1)), h * (0.45 + 0.05 * p))
            for p in range(n)]


def write_panoptic(root, n=6, seed=0, edge=(5,)):
    """CMU-Panoptic-format frames (H x W JPEGs, 3-4 people each; the
    images in ``edge`` have theirs at the border) and their json."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        fname = f'pan_{i}.jpg'
        cv2.imwrite(os.path.join(root, fname), _image(rng, H, W))
        f = 150.0
        images.append(dict(
            id=i + 1, file_name=fname, width=W, height=H,
            cam=dict(K=[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.]],
                     R=np.eye(3).tolist(), t=[[0.], [0.], [0.]])))
        for cx, cy in _centres(i, 3 + i % 2, H, W, i in edge):
            joints = np.array([cx, cy, 300.0]) + \
                rng.randn(J, 3) * [6, 9, 4]
            joints[2] = [cx, cy, 300.0]
            u, v = joints[:, 0], joints[:, 1]
            bbox = [float(u.min()), float(v.min()), float(np.ptp(u) + 4),
                    float(np.ptp(v) + 4)]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0,
                joints3d_img=joints.tolist(), joints3d=joints.tolist(),
                joints2d_vis=[[1, 1]] * J,
                joints3d_vis=[[1, 1, 1]] * J))
    path = os.path.join(root, 'panoptic.json')
    with open(path, 'w') as fh:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), fh)
    return path


def write_coco(root, n=6, seed=1):
    """COCO-17 keypoint frames, 3 people each (both hips visible, one
    person a crowd and one with an invisible hip in image 0)."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        fname = f'coco_{i}.jpg'
        cv2.imwrite(os.path.join(root, fname), _image(rng, H, W))
        images.append(dict(id=i + 1, file_name=fname, width=W, height=H))
        for p, (cx, cy) in enumerate(_centres(i, 3, H, W, False)):
            kp = np.array([cx, cy]) + rng.randn(17, 2) * [6, 10]
            kp[11] = [cx - 3, cy]
            kp[12] = [cx + 3, cy + 1]
            vis = rng.choice([0, 1, 2], 17, p=[0.1, 0.3, 0.6])
            vis[11] = vis[12] = 2
            if i == 0 and p == 1:
                vis[12] = 0
            u, v = kp[:, 0], kp[:, 1]
            bbox = [float(u.min() - 2), float(v.min() - 2),
                    float(np.ptp(u) + 4), float(np.ptp(v) + 4)]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=int(i == 1 and p == 2),
                num_keypoints=int((vis > 0).sum()),
                keypoints=np.concatenate([kp, vis[:, None]], 1)
                .reshape(-1).tolist()))
    path = os.path.join(root, 'coco.json')
    with open(path, 'w') as fh:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), fh)
    return path


def write_muco(root, n=6, seed=2):
    """MuCo-3DHP frames (21 joints, pelvis 14 the root, pseudo cameras),
    3 people each; image 0 has one person with an invisible root."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        fname = f'muco_{i}.jpg'
        cv2.imwrite(os.path.join(root, fname), _image(rng, H, W))
        images.append(dict(id=i + 1, file_name=fname, width=W, height=H,
                           f=[150.0, 151.0], c=[W / 2, H / 2]))
        for p, (cx, cy) in enumerate(_centres(i, 3, H, W, False)):
            img = np.array([cx, cy]) + rng.randn(21, 2) * [6, 10]
            img[14] = [cx, cy]
            cam = np.concatenate([rng.randn(21, 2) * 300,
                                  3000 + rng.randn(21, 1) * 80], 1)
            vis = (rng.rand(21) > 0.1).astype(float)
            vis[14] = float(not (i == 0 and p == 0))
            u, v = img[:, 0], img[:, 1]
            bbox = [float(u.min()), float(v.min()), float(np.ptp(u) + 4),
                    float(np.ptp(v) + 4)]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, bbox=bbox,
                area=bbox[2] * bbox[3], iscrowd=0,
                keypoints_img=img.tolist(), keypoints_cam=cam.tolist(),
                keypoints_vis=vis.tolist()))
    path = os.path.join(root, 'muco.json')
    with open(path, 'w') as fh:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), fh)
    return path


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('train_data'))
    return dict(root=root, panoptic=write_panoptic(root),
                coco=write_coco(root), muco=write_muco(root))


def assert_same(got, want, what=''):
    """Equal, bit for bit: dicts key for key (the sample's generator
    aside), arrays in dtype, shape and value; an ``img`` array within
    IMG_ATOL['img'] on the native path."""
    if isinstance(want, dict):
        keys = set(want) - {'rng'}
        assert set(got) - {'rng'} == keys, (what, set(got) ^ set(want))
        for k in keys:
            assert_same(got[k], want[k], f'{what}/{k}')
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype, what
        if what.rsplit('/', 1)[-1] == 'img' and IMG_ATOL['img']:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=IMG_ATOL['img'], err_msg=what)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, (list, tuple)) and want and \
            isinstance(want[0], (np.ndarray, dict, list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{what}[{i}]')
    else:
        assert got == want, (what, got, want)


def panoptic_cfg(data, pipeline):
    return dict(type='CMUPanopticDataset', ann_file=data['panoptic'],
                img_prefix=data['root'], norm_depth=True, abs_dz=True,
                depth_factor=1, pipeline=pipeline)


def loaded(data, idx=0):
    """Image ``idx``'s results after LoadImageFromFile(to_float32) and
    LoadAnnotationsPose3D(with_bbox, with_label), as the train pipeline
    gives them to the first random transform."""
    ds = jbuild_dataset(panoptic_cfg(data, None))
    res = dict(img_info=ds.data_infos[idx], ann_info=ds.get_ann_info(idx),
               img_prefix=data['root'], bbox_fields=[], img_fields=[],
               pose3d_fields=[])
    res = jpipes.LoadImageFromFile(to_float32=True)(res)
    return jpipes.LoadAnnotationsPose3D(with_bbox=True,
                                        with_label=True)(res)


def run_both(name, kw, results, seed):
    """The port's transform with RandomState(seed) and the JAX one after
    np.random.seed(seed), each on its own copy of ``results``; also checks
    that both took the same number of draws."""
    mine = copy.deepcopy(results)
    mine['rng'] = rng = np.random.RandomState(seed)
    got = getattr(pipes, name)(**kw)(mine)
    np.random.seed(seed)
    want = getattr(jpipes, name)(**kw)(copy.deepcopy(results))
    assert rng.randint(1 << 30) == np.random.randint(1 << 30), \
        (name, seed, 'draws')
    return got, want


SHIPPED = Config.fromfile(os.path.join(REPO, 'configs', 'das',
                                       'exp_panoptic_tpu.py'))


def shipped_step(pipeline, name, **small):
    """A transform's arguments in a shipped train pipeline (the resize
    scales cut to this test's image size)."""
    kw = dict(next(t for t in pipeline if t['type'] == name))
    kw.pop('type')
    kw.update(small)
    return kw


SMALL_SCALES = dict(img_scale=[(160, 96), (160, 120)])
TRANSFORMS = [
    ('ResizePose', shipped_step(SHIPPED.train_pipeline, 'ResizePose',
                                **SMALL_SCALES)),
    ('ResizePose', shipped_step(SHIPPED.train_pipeline_coco, 'ResizePose',
                                **SMALL_SCALES)),
    ('RandomFlipPose3D', shipped_step(SHIPPED.train_pipeline,
                                      'RandomFlipPose3D')),
    ('PhotoMetricDistortion', shipped_step(SHIPPED.train_pipeline,
                                           'PhotoMetricDistortion')),
    ('PhotoMetricDistortion', shipped_step(SHIPPED.train_pipeline_coco,
                                           'PhotoMetricDistortion')),
    ('GlobalRotScaleTransPose', shipped_step(SHIPPED.train_pipeline,
                                             'GlobalRotScaleTransPose')),
    ('GlobalRotScaleTransPose', shipped_step(SHIPPED.train_pipeline_coco,
                                             'GlobalRotScaleTransPose')),
    ('GlobalRotScaleTransPose', dict(
        rot_range=0.5, scale_ratio_range=[0.7, 1.3],
        translation_std=[0.2, 0.2], num_joints=J, scale_depth=True,
        abs_dz=True, abs_dz_ref_compat=True, use_bbox_center=True)),
]


@pytest.mark.parametrize('name,kw', TRANSFORMS,
                         ids=[f'{n}-{i}' for i, (n, _) in
                              enumerate(TRANSFORMS)])
def test_training_transform_matches_jax(data, name, kw):
    """Each training transform of the shipped pipelines (and the warp with
    a rotation, the reference-literal abs_dz and the bbox centre), 12
    seeds, two images: outputs equal to the JAX transform's bit for bit,
    the same draws taken. The PhotoMetricDistortion outputs of the seeds
    differ from one another (the draws reach the image)."""
    outs = []
    for idx in (0, 3):
        base = loaded(data, idx)
        for seed in SEEDS:
            got, want = run_both(name, kw, base, seed)
            assert (got is None) == (want is None), (name, seed)
            if want is not None:
                assert_same(got, want, f'{name} seed {seed}')
                outs.append(got['img'])
    if name == 'PhotoMetricDistortion':
        assert len({o.tobytes() for o in outs}) > len(outs) // 2


@pytest.mark.parametrize('mode,scales', [
    ('range', [(160, 96), (200, 120)]),
    ('value', [(160, 96), (200, 120), (180, 100)])])
def test_resize_scale_draws_match_jax(data, mode, scales):
    """Resize._pick_scale draws from the sample's generator (the global
    np.random before), in both multiscale modes, 12 seeds."""
    picked = set()
    for seed in SEEDS:
        got, want = run_both('Resize', dict(img_scale=scales,
                                            multiscale_mode=mode),
                             loaded(data), seed)
        assert_same(got, want, f'{mode} seed {seed}')
        picked.add(got['scale'])
    assert len(picked) > 2


def test_flip_draws_match_jax(data):
    """RandomFlipPose3D at ratio 0.5 draws from the sample's generator: the
    same flips as JAX over 12 seeds, some flipped and some not; with
    ``flip`` already set (the test pipelines) it needs no generator."""
    kw = dict(flip_ratio_bev_horizontal=0.5, flip_pairs=PAIRS, num_joints=J)
    flips = [run_both('RandomFlipPose3D', kw, loaded(data), s)[0]['flip']
             for s in SEEDS]
    assert 0 < sum(flips) < len(flips)
    res = loaded(data)
    res['flip'] = True
    assert pipes.RandomFlipPose3D(**kw)(res)['flip']
    with pytest.raises(KeyError, match="results\\['rng'\\]"):
        pipes.RandomFlipPose3D(**kw)(loaded(data))


def test_affine_transform_matches_jax():
    """get_affine_transform (and get_dir, get_3rd_point) equal JAX's,
    forward and inverse, with a rotation and a shift."""
    for rot, shift, inv in [(0.0, (0, 0), 0), (17.5, (0.1, -0.2), 0),
                            (-40.0, (0.05, 0.0), 1)]:
        args = (np.array([63.5, 40.25]), np.array([130.0, 97.0]), rot,
                [128, 96], np.array(shift, np.float32), inv)
        np.testing.assert_array_equal(pipes.get_affine_transform(*args),
                                      jpipes.get_affine_transform(*args))


def test_resize_pose_against_the_native_path(data, monkeypatch):
    """Both packages on their C++ resize, whatever the ``host_path``: the
    poses equal, the image within NATIVE_ATOL, and the port's resize is
    the one that ran (not cv2's)."""
    monkeypatch.undo()
    assert jnative.available() and pnative.available()
    ran = []
    real = pnative.resize_bilinear
    monkeypatch.setattr(pnative, 'resize_bilinear',
                        lambda *a: ran.append(1) or real(*a))
    kw = TRANSFORMS[0][1]
    for seed in SEEDS[:4]:
        got, want = run_both('ResizePose', kw, loaded(data), seed)
        assert_same({k: v for k, v in got.items() if k != 'img'},
                    {k: v for k, v in want.items() if k != 'img'})
        np.testing.assert_allclose(got['img'], want['img'], rtol=0,
                                   atol=NATIVE_ATOL)
    assert len(ran) == 4


def train_pipeline(pipeline, scales=((160, 96), (160, 120))):
    """A shipped train pipeline at this test's size."""
    pipe = copy.deepcopy([dict(t) for t in pipeline])
    for t in pipe:
        if t['type'] == 'ResizePose':
            t['img_scale'] = [tuple(s) for s in scales]
    return pipe


def _wrap_calls(ds):
    calls = []
    real = ds.prepare_train_img
    ds.prepare_train_img = lambda i, rng: (calls.append(i), real(i, rng))[1]
    return calls


def test_train_sample_and_resample_match_jax(data):
    """The whole shipped train pipeline through CMUPanopticDataset, every
    image, 12 seeds: dataset.sample(i, RandomState(s)) equals JAX's
    dataset[i] after np.random.seed(s), including the samples the warp
    rejects (image 5's people sit at the border) and the index drawn in
    their place; and without a generator, RandomState(i)."""
    cfg = panoptic_cfg(data, train_pipeline(SHIPPED.train_pipeline))
    mine, theirs = build_dataset(cfg), jbuild_dataset(cfg)
    calls = _wrap_calls(mine)
    for seed in SEEDS:
        for i in range(len(mine)):
            got = mine.sample(i, np.random.RandomState(seed))
            np.random.seed(seed)
            assert_same(got, theirs[i], f'sample {i} seed {seed}')
    assert len(calls) > len(SEEDS) * len(mine), 'no sample was rejected'
    np.random.seed(4)
    assert_same(mine[4], theirs[4])


def muco_cfg(data, **kw):
    return dict(type='MuCo3DHPDataset', data_root=data['root'],
                ann_file=data['muco'], norm_depth=True, abs_dz=True,
                depth_factor=1, classes=('person',), **kw)


def coco_cfg(data, convert_ids, **kw):
    return dict(type='COCOKeypointsDataset', convert_ids=convert_ids,
                data_root=data['root'], ann_file=data['coco'],
                img_prefix=data['root'], classes=('person',), **kw)


@pytest.mark.parametrize('which', ['muco', 'coco-panoptic', 'coco-muco',
                                   'coco-none', 'muco-bbox-center'])
def test_parse_ann_info_matches_jax(data, which):
    """MuCo (root 14, invisible-root people ignored) and COCO (hip-midpoint
    root, crowd and invisible-hip people left out, the panoptic-15 and
    muco-21 joint maps, none): data_infos and every image's parsed
    annotations equal JAX's."""
    if which.startswith('muco'):
        cfg = muco_cfg(data, use_bbox_center=which.endswith('center'))
        cls = MuCo3DHPDataset
    else:
        ids = which.split('-')[1]
        cfg = coco_cfg(data, None if ids == 'none' else ids)
        cls = COCOKeypointsDataset
    mine, theirs = build_dataset(cfg), jbuild_dataset(cfg)
    assert type(mine) is cls and len(mine) == len(theirs) == 6
    assert mine.data_infos == theirs.data_infos
    n = 0
    for i in range(len(mine)):
        got, want = mine.get_ann_info(i), theirs.get_ann_info(i)
        assert (got is None) == (want is None)
        if want is not None:
            assert_same(got, want, f'{which} ann {i}')
            n += len(want['gt_poses_3d'])
    assert n > 12


def test_shipped_mupots_mix_builds_and_matches_jax(data):
    """configs/das/exp_mupots.py's train mix, on the synthetic MuCo and
    COCO files at this test's size: a ConcatDataset of MuCo and a
    RepeatDataset of COCO (muco ids), whose samples over 6 seeds equal
    JAX's."""
    ship = Config.fromfile(os.path.join(REPO, 'configs', 'das',
                                        'exp_mupots.py'))
    muco, rep = [dict(c) for c in ship.data.train]
    muco.update(data_root=data['root'], ann_file=data['muco'],
                pipeline=train_pipeline(muco['pipeline']))
    coco = dict(rep['dataset'])
    coco.update(data_root=data['root'], ann_file=data['coco'],
                img_prefix=data['root'],
                pipeline=train_pipeline(coco['pipeline']))
    rep['dataset'] = coco
    cfg = [muco, rep]
    mine, theirs = build_dataset(cfg), jbuild_dataset(cfg)
    assert isinstance(mine, ConcatDataset)
    assert isinstance(mine.datasets[0], MuCo3DHPDataset)
    assert isinstance(mine.datasets[1], RepeatDataset)
    assert mine.datasets[1].dataset.convert_ids == 'muco'
    assert len(mine) == len(theirs) == 12
    for seed in SEEDS[:6]:
        for i in (0, 4, 6, 11):
            got = mine.sample(i, np.random.RandomState(seed))
            np.random.seed(seed)
            assert_same(got, theirs[i], f'mix sample {i} seed {seed}')
            assert got['gt_poses_3d'].shape[1] == 3 + 4 * 21


class FakeDataset:
    """tests/test_loader.py's FakeDataset, with the port's ``sample``."""

    def __init__(self, n=10, j=4):
        self.n, self.j = n, j

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        h, w = 40 + idx % 3 * 8, 60
        g = 1 + idx % 3
        return dict(
            img=rng.rand(h, w, 3).astype(np.float32),
            gt_poses_3d=rng.rand(g, 3 + 4 * self.j).astype(np.float32),
            centers2d=rng.rand(g, 2).astype(np.float32),
            depths=rng.rand(g).astype(np.float32),
            img_metas={})

    def sample(self, idx, rng=None):
        return self[idx]


def test_pad_batch_matches_jax():
    """pad_batch: the JAX keys, shapes, dtypes and values, with more GTs
    than max_gt in one sample."""
    ds = FakeDataset()
    samples = [ds[i] for i in range(3)]
    got = loader.pad_batch(samples, (64, 64), 2, 4)
    want = jloader.pad_batch(samples, (64, 64), 2, 4)
    assert_same(got, want)
    assert sorted(got) == ['gt_centers2d', 'gt_depths', 'gt_poses_3d',
                           'gt_valid', 'img']
    assert got['gt_valid'].sum(1).tolist() == [1, 2, 2]


@pytest.mark.parametrize('n,batch,seed', [(10, 4, 0), (9, 2, 3), (3, 4, 1)])
def test_loader_batches_match_jax(n, batch, seed):
    """TrainLoader over a dataset with no random draw: the JAX loader's
    batches, in order, over several epochs (and for a dataset smaller than
    a batch); the same steps_per_epoch."""
    kw = dict(batch_size=batch, pad_hw=(64, 64), num_joints=4, max_gt=3,
              seed=seed, num_workers=2)
    mine = loader.TrainLoader(FakeDataset(n), **kw)
    theirs = jloader.TrainLoader(FakeDataset(n), **kw)
    assert mine.steps_per_epoch == theirs.steps_per_epoch
    it_m, it_t = iter(mine), iter(theirs)
    for _ in range(3 * max(n // batch, 1) + 1):
        assert_same(next(it_m), next(it_t))
    it_m.close()


def test_loader_on_disk_matches_jax(data):
    """TrainLoader over CMUPanopticDataset with a pipeline of no random
    transform (as tests/test_loader.py builds it): JAX's batches."""
    pipe = [
        dict(type='LoadImageFromFile', to_float32=True),
        dict(type='LoadAnnotationsPose3D', with_bbox=True, with_label=True),
        dict(type='ResizePose', scale_depth=True, abs_dz=True,
             img_scale=(160, 120), keep_ratio=True),
        dict(type='Normalize', **IMG_NORM),
        dict(type='Pad', size_divisor=32),
        dict(type='Collect3D', keys=['img', 'gt_bboxes', 'gt_labels',
                                     'gt_poses_3d', 'gt_labels_3d',
                                     'centers2d', 'depths'],
             num_joints=J)]
    cfg = panoptic_cfg(data, pipe)
    kw = dict(batch_size=2, pad_hw=(128, 160), num_joints=J, max_gt=4,
              seed=5, num_workers=2)
    it_m = iter(loader.TrainLoader(build_dataset(cfg), **kw))
    it_t = iter(jloader.TrainLoader(jbuild_dataset(cfg), **kw))
    for _ in range(4):
        assert_same(next(it_m), next(it_t))
    it_m.close()


def _take(train_loader, n=5):
    it = iter(train_loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_thread_loader_equals_process_loader(data, host_path, monkeypatch):
    """With the whole random train pipeline, the thread loader and the
    spawned process loader give the same batches bit for bit; a second
    thread loader of the same seed too, and one of another seed does not.
    The process loader's workers are new processes, on the default
    (native) path whatever this one patches: on the cv2 path its batches
    are held against a thread loader on the native path."""
    cfg = panoptic_cfg(data, train_pipeline(SHIPPED.train_pipeline))
    ds = build_dataset(cfg)
    kw = dict(batch_size=2, pad_hw=(128, 160), num_joints=J, max_gt=4,
              num_workers=2)
    threads = _take(loader.TrainLoader(ds, seed=7, **kw))
    three = _take(loader.TrainLoader(ds, seed=7, num_workers=3,
                                     **{k: v for k, v in kw.items()
                                        if k != 'num_workers'}))
    other = _take(loader.TrainLoader(ds, seed=8, **kw))
    with monkeypatch.context() as m:
        m.setattr(pnative, 'available', NATIVE_AVAILABLE)
        native = threads if host_path == 'native' else \
            _take(loader.TrainLoader(ds, seed=7, **kw))
    process = _take(loader.TrainLoader(ds, seed=7, worker_type='process',
                                       dataset_cfg=cfg, **kw))
    for b in range(5):
        assert_same(three[b], threads[b], f'batch {b}')
        np.testing.assert_array_equal(process[b]['img'], native[b]['img'])
        assert_same(process[b], native[b], f'batch {b}')
    assert not np.array_equal(other[-1]['img'], threads[-1]['img'])


def test_loader_shards_disjoint():
    """Two shards of one seed: disjoint orders that cover the dataset, and
    per-sample generator keys that differ between the shards."""
    ls = [loader.TrainLoader(FakeDataset(8), 2, (64, 64), 4, seed=3,
                             shard_id=s, num_shards=2) for s in (0, 1)]
    js = [jloader.TrainLoader(FakeDataset(8), 2, (64, 64), 4, seed=3,
                              shard_id=s, num_shards=2) for s in (0, 1)]
    orders = [set(lo._epoch_order().tolist()) for lo in ls]
    assert orders[0] | orders[1] == set(range(8))
    assert not orders[0] & orders[1]
    assert orders == [set(lo._epoch_order().tolist()) for lo in js]
    keys = [set(k for _, ks in zip(range(4), lo._index_batches())
                for k in ks[1]) for lo in ls]
    assert not keys[0] & keys[1]
    assert ls[0].steps_per_epoch == js[0].steps_per_epoch == 2


def test_train_pad_hw_from_cfg_matches_jax():
    """The train bucket: equal to JAX's on the shipped pipelines, the
    exp_mupots one and a single scale; profile_train.train_pad_hw takes it
    from the loader and still raises where the loader guesses 640x1344."""
    mupots = Config.fromfile(os.path.join(REPO, 'configs', 'das',
                                          'exp_mupots.py'))
    small = [dict(type='ResizePose', img_scale=(500, 300), keep_ratio=True)]
    for pipe in (SHIPPED.train_pipeline, SHIPPED.train_pipeline_coco,
                 mupots.train_pipeline_muco, small):
        assert loader.train_pad_hw_from_cfg(pipe) == \
            jloader.train_pad_hw_from_cfg(pipe) == train_pad_hw(pipe)
    assert loader.train_pad_hw_from_cfg(SHIPPED.train_pipeline) == \
        (640, 1344)
    none = [dict(type='LoadImageFromFile')]
    assert loader.train_pad_hw_from_cfg(none) == \
        jloader.train_pad_hw_from_cfg(none) == (640, 1344)
    with pytest.raises(ValueError, match='no train bucket'):
        train_pad_hw(none)
