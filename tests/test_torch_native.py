"""The port's host library (``das_tpu_torch/datasets/native.py`` over
``das_tpu_torch/csrc/das_host.cpp``, built with g++ at first use) against the
JAX package's (``das_tpu/libdas_host.so``), against cv2 and numpy, and the
transforms' choice between it and cv2.

The two libraries compile one source: their outputs agree within 1e-3 pixel
levels (0-255), and bit for bit where both were compiled for the same
instruction set (FMA contraction changes the last bits); each case reports
which. Against cv2 the tolerances are tests/test_native.py's.
"""

import shutil

import cv2
import numpy as np
import pytest

from das_tpu.datasets import native as jnative
from das_tpu_torch.datasets import native as pnative
from das_tpu_torch.datasets import pipelines as pipes

ATOL = 1e-3
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)

# (source h, w) -> (output h, w): down, up, odd, one-pixel rows and a
# full-size frame
RESIZES = [((48, 64), (24, 40)), ((90, 120), (160, 213)),
           ((37, 53), (81, 17)), ((5, 7), (1, 30)),
           ((1080, 1920), (640, 1138))]
# (source h, w, output h, w, forward 2x3): identity, shift past the border,
# rotation with scale, a shrink that leaves border on every side
WARPS = [
    ((40, 60), (40, 60), [[1, 0, 0], [0, 1, 0]]),
    ((40, 60), (40, 60), [[1, 0, 13.5], [0, 1, -9.25]]),
    ((64, 96), (64, 96), [[0.9, 0.35, -8.0], [-0.35, 0.9, 20.0]]),
    ((50, 50), (80, 70), [[0.5, 0.0, 17.3], [0.0, 0.45, 20.1]]),
    ((90, 120), (100, 130), [[1.3, -0.2, -5.0], [0.1, 1.1, 7.0]]),
]
BORDER = (110.0, 120.0, 130.0)


def frame(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255) \
        .astype(np.float32)


def report(got, want, what):
    bit = np.array_equal(got, want)
    print(f'{what}: max |port - JAX library| '
          f'{float(np.abs(got - want).max()):.3g}, bit-equal {bit}')
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


def test_both_libraries_load():
    """The JAX library is the tracked ``das_tpu/libdas_host.so``; the port's
    is built under build/das_tpu_torch/, named by its hash."""
    assert jnative.available()
    assert pnative.available()
    so = pnative.so_path()
    assert so.exists() and so.parent == pnative.BUILD_DIR
    assert so.name.startswith('libdas_host_') and so.suffix == '.so'


@pytest.mark.parametrize('src_hw,out_hw', RESIZES)
def test_resize_matches_the_jax_library(src_hw, out_hw):
    src = frame(*src_hw, seed=src_hw[0])
    report(pnative.resize_bilinear(src, out_hw),
           jnative.resize_bilinear(src, out_hw),
           f'resize {src_hw} -> {out_hw}')


@pytest.mark.parametrize('src_hw,out_hw,trans', WARPS)
def test_warp_matches_the_jax_library(src_hw, out_hw, trans):
    src = frame(*src_hw, seed=src_hw[1])
    t = np.array(trans, np.float64)
    got = pnative.affine_warp(src, t, out_hw, BORDER)
    report(got, jnative.affine_warp(src, t, out_hw, BORDER),
           f'warp {src_hw} -> {out_hw}')
    if trans[0][2] or out_hw != src_hw:
        assert (got == np.float32(BORDER[0])).any(), 'the border was not hit'


@pytest.mark.parametrize('to_rgb', [True, False])
def test_normalize_pad_matches_the_jax_library_and_numpy(to_rgb):
    """Into a slot that held other values: the pad is zeroed."""
    src = frame(37, 53, seed=5)
    got = np.ones((64, 64, 3), np.float32)
    want = np.ones((64, 64, 3), np.float32)
    pnative.normalize_pad_into(src, got, MEAN, STD, to_rgb=to_rgb)
    jnative.normalize_pad_into(src, want, MEAN, STD, to_rgb=to_rgb)
    report(got, want, f'normalize_pad to_rgb={to_rgb}')
    ref = np.zeros((64, 64, 3), np.float32)
    ref[:37, :53] = ((src[..., ::-1] if to_rgb else src) - MEAN) / STD
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize('src_hw,out_hw', RESIZES[:3])
def test_resize_matches_cv2(src_hw, out_hw):
    src = frame(*src_hw, seed=1)
    ref = cv2.resize(src, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(pnative.resize_bilinear(src, out_hw), ref,
                               atol=0.51)


@pytest.mark.parametrize('src_hw,out_hw,trans', WARPS)
def test_warp_matches_cv2(src_hw, out_hw, trans):
    src = frame(*src_hw, seed=2)
    t = np.array(trans, np.float64)
    ref = cv2.warpAffine(src, t, out_hw[::-1], flags=cv2.INTER_LINEAR,
                         borderValue=BORDER)
    np.testing.assert_allclose(pnative.affine_warp(src, t, out_hw, BORDER),
                               ref, atol=0.5)


def test_only_float32_hwc3_takes_the_library(monkeypatch):
    """Resize and GlobalRotScaleTransPose on the JAX condition: a float32
    HxWx3 image through the library, a uint8 one through cv2; the library
    refuses any other shape, and a border, mean or std without one value
    a channel, or a batch slot too small, before it is handed a pointer."""
    calls = []
    for name in ('resize_bilinear', 'affine_warp'):
        real = getattr(pnative, name)
        monkeypatch.setattr(pnative, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    resize = pipes.Resize(img_scale=(80, 60))
    warp = pipes.GlobalRotScaleTransPose(num_joints=1)
    pose = np.array([[20.0, 15.0, 300.0] * 2 + [1.0],
                     [40.0, 25.0, 300.0] * 2 + [1.0]], np.float32)
    ann = dict(gt_poses_3d=pose, gt_bboxes=np.array(
        [[10, 5, 30, 25], [30, 15, 50, 35]], np.float32),
        gt_labels=np.zeros(2, np.int64), gt_labels_3d=np.zeros(2, np.int64))
    for dtype, want in ((np.float32, 2), (np.uint8, 0)):
        calls.clear()
        img = frame(48, 64, seed=3).astype(dtype)
        out = resize(dict(img=img, scale=(80, 60)))
        assert out['img'].dtype == dtype and out['img'].shape == (60, 80, 3)
        warp(dict(img=img, img_shape=img.shape, rng=np.random.RandomState(0),
                  **{k: v.copy() for k, v in ann.items()}))
        assert len(calls) == want, (dtype, calls)
    with pytest.raises(ValueError, match='HxWx3'):
        pnative.resize_bilinear(np.zeros((8, 8), np.float32), (4, 4))
    with pytest.raises(ValueError, match='border'):
        pnative.affine_warp(img.astype(np.float32), np.eye(3), (4, 4),
                            (1.0, 2.0))
    with pytest.raises(ValueError, match='std'):
        pnative.normalize_pad_into(img.astype(np.float32),
                                   np.zeros((64, 64, 3), np.float32), MEAN,
                                   STD[:2])
    with pytest.raises(ValueError, match='slot'):
        pnative.normalize_pad_into(img.astype(np.float32),
                                   np.zeros((8, 8, 3), np.float32), MEAN, STD)


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    """No g++ and no library yet: the first use raises, naming g++; it
    never answers False (so no transform falls back to cv2)."""
    monkeypatch.setattr(pnative, '_LIB', None)
    monkeypatch.setattr(pnative, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        pnative.available()
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        pipes.Resize(img_scale=(80, 60))(
            dict(img=frame(48, 64, seed=0), scale=(80, 60)))


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    broken = tmp_path / 'das_host.cpp'
    broken.write_text(pnative.SOURCE.read_text()
                      + '\nint das_broken( { return 0; }\n')
    monkeypatch.setattr(pnative, '_LIB', None)
    monkeypatch.setattr(pnative, 'SOURCE', broken)
    monkeypatch.setattr(pnative, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed') as err:
        pnative.available()
    assert 'das_broken' in str(err.value)
    assert not list((tmp_path / 'build').glob('*.so'))
