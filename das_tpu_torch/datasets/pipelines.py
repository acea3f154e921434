"""Host test-pipeline transforms (numpy), mmdet-pipeline protocol; the
port's copy of the evaluation transforms of ``das_tpu/datasets/pipelines.py``
(ref: configs/das/exp_panoptic.py:59-155 and
mmdet3d/datasets/pipelines/transforms_3d.py):

* ``LoadImageFromFile`` (through ``utils/image.imread``) /
  ``LoadAnnotationsPose3D``            (ref loading.py:672-736)
* ``Resize``                           (mmdet Resize, keep_ratio)
* ``RandomFlipPose3D``                 (ref transforms_3d.py:236-356)
* ``Normalize`` / ``Pad`` / ``DefaultFormatBundlePose3D`` / ``Collect3D``
  / ``MultiScaleFlipAug``

``Resize`` is ``cv2.resize`` on the image as loaded (uint8 for the test
pipelines), imported where it runs: on a host without ``cv2`` the host
pipeline raises there, and evaluation takes the device path
(``apis/test.py``, ``device_preprocess``), which needs only a decode.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..config.registry import PIPELINES, build_from_cfg
from ..utils.image import imread


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(dict(t), PIPELINES))
            else:
                self.transforms.append(t)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register_module()
class LoadImageFromFile:
    def __init__(self, to_float32=False, color_type='color'):
        self.to_float32 = to_float32

    def __call__(self, results):
        if results.get('img_prefix') is not None:
            filename = os.path.join(results['img_prefix'],
                                    results['img_info']['file_name'])
        else:
            filename = results['img_info']['file_name']
        img = imread(filename)                         # BGR, HWC
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = filename
        results['ori_filename'] = results['img_info']['file_name']
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['img_fields'] = ['img']
        return results


@PIPELINES.register_module()
class LoadAnnotationsPose3D:
    """Copy parsed pose annotations into the results dict
    (ref loading.py:672-736)."""

    def __init__(self, with_pose_3d=True, with_label_3d=True,
                 with_bbox=False, with_label=False, **kwargs):
        self.with_pose_3d = with_pose_3d
        self.with_label_3d = with_label_3d
        self.with_bbox = with_bbox
        self.with_label = with_label

    def __call__(self, results):
        info = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = info['bboxes'].copy()
            results['bbox_fields'] = results.get('bbox_fields', []) + \
                ['gt_bboxes']
        if self.with_label:
            results['gt_labels'] = info['labels'].copy()
        if self.with_pose_3d:
            results['centers2d'] = np.array(info['centers2d'], np.float32)
            results['depths'] = np.array(info['depths'], np.float32)
            results['gt_poses_3d'] = np.array(info['gt_poses_3d'],
                                              np.float32)
        if self.with_label_3d:
            results['gt_labels_3d'] = info['gt_labels_3d'].copy()
        if 'cam' in info:
            results['cam'] = info['cam']
        return results


def _rescale_size(h, w, scale: Tuple[int, int]):
    """mmdet keep-ratio rescale: fit within (max(scale), min(scale))."""
    max_long, max_short = max(scale), min(scale)
    scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return new_h, new_w


@PIPELINES.register_module()
class Resize:
    """mmdet Resize, keep_ratio path only (the DAS configs never disable
    keep_ratio). multiscale_mode='range' samples the short edge uniformly."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 keep_ratio=True, **kwargs):
        assert keep_ratio
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.multiscale_mode = multiscale_mode

    def _pick_scale(self):
        if len(self.img_scale) == 1:
            return self.img_scale[0]
        if self.multiscale_mode == 'range':
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_edge = np.random.randint(min(longs), max(longs) + 1)
            short_edge = np.random.randint(min(shorts), max(shorts) + 1)
            return (long_edge, short_edge)
        idx = np.random.randint(len(self.img_scale))
        return self.img_scale[idx]

    def __call__(self, results):
        import cv2

        if 'scale' not in results:
            results['scale'] = self._pick_scale()
        img = results['img']
        h, w = img.shape[:2]
        new_h, new_w = _rescale_size(h, w, results['scale'])
        resized = cv2.resize(img, (new_w, new_h),
                             interpolation=cv2.INTER_LINEAR)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = resized
        results['img_shape'] = resized.shape
        results['pad_shape'] = resized.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results['keep_ratio'] = True
        for key in results.get('bbox_fields', []):
            results[key] = results[key] * results['scale_factor']
        return results


@PIPELINES.register_module()
class RandomFlipPose3D:
    """Horizontal flip of image + pose with left/right joint swapping
    (ref transforms_3d.py:236-356)."""

    def __init__(self, flip_ratio_bev_horizontal=0.0, num_joints=15,
                 flip_pairs=None, sync_2d=True, **kwargs):
        self.flip_ratio = flip_ratio_bev_horizontal
        self.num_joints = num_joints
        self.flip_pairs = [list(p) for p in (flip_pairs or [])]

    def __call__(self, results):
        if 'flip' not in results:
            results['flip'] = bool(np.random.rand() < self.flip_ratio)
        results['flip_direction'] = 'horizontal'
        results['pcd_horizontal_flip'] = results['flip']
        if not results['flip']:
            return results
        # flip image + bboxes (mmdet RandomFlip)
        for key in results.get('img_fields', ['img']):
            results[key] = np.ascontiguousarray(
                np.flip(results[key], axis=1))
        w = results['img_shape'][1]
        for key in results.get('bbox_fields', []):
            bboxes = results[key].copy()
            bboxes[..., 0::4] = w - results[key][..., 2::4]
            bboxes[..., 2::4] = w - results[key][..., 0::4]
            results[key] = bboxes
        if 'gt_poses_3d' in results:
            J = self.num_joints
            centers2d = results['centers2d']
            depths = results['depths']
            joints = results['gt_poses_3d'][:, 3:3 + J * 3] \
                .reshape(-1, J, 3).copy()
            joints_vis = results['gt_poses_3d'][:, 3 + J * 3:] \
                .reshape(-1, J).copy()
            centers2d[..., 0] = w - centers2d[..., 0] - 1
            joints[:, :, 0] = w - joints[:, :, 0] - 1
            for a, b in self.flip_pairs:
                joints[:, [a, b]] = joints[:, [b, a]]
                joints_vis[:, [a, b]] = joints_vis[:, [b, a]]
            results['centers2d'] = centers2d
            results['gt_poses_3d'] = np.concatenate([
                centers2d, depths.reshape(-1, 1),
                joints.reshape(-1, J * 3), joints_vis
            ], axis=-1).astype(np.float32)
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            img = results[key].astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            results[key] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size=None, size_divisor=None, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            img = results[key]
            if self.size_divisor is not None:
                h = int(np.ceil(img.shape[0] / self.size_divisor)) * \
                    self.size_divisor
                w = int(np.ceil(img.shape[1] / self.size_divisor)) * \
                    self.size_divisor
            else:
                h, w = self.size
            padded = np.full((h, w, *img.shape[2:]), self.pad_val,
                             img.dtype)
            padded[:img.shape[0], :img.shape[1]] = img
            results[key] = padded
        results['pad_shape'] = results['img'].shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        return results


@PIPELINES.register_module()
class DefaultFormatBundlePose3D:
    """Config-compat shim for the reference's tensor/DataContainer bundle
    (ref formating.py:384-442): samples stay numpy (the sweep batches
    them), so this only normalises dtypes and the HWC layout."""

    def __init__(self, class_names=None, with_label=True, **kwargs):
        self.class_names = class_names
        self.with_label = with_label

    def __call__(self, results):
        if 'img' in results:
            results['img'] = np.ascontiguousarray(
                results['img'].astype(np.float32))
        for key in ('gt_poses_3d', 'centers2d', 'depths'):
            if key in results:
                results[key] = np.asarray(results[key], np.float32)
        for key in ('gt_labels', 'gt_labels_3d'):
            if key in results:
                results[key] = np.asarray(results[key], np.int64)
        return results


META_KEYS = ('filename', 'ori_shape', 'img_shape', 'pad_shape',
             'scale_factor', 'flip', 'flip_pairs', 'cam', 'transform_mat',
             'pcd_rot', 'img_norm_cfg')


@PIPELINES.register_module()
class Collect3D:
    """Package the final sample: data keys + img_metas
    (ref formating.py:84-180; plain numpy instead of DataContainers)."""

    def __init__(self, keys, meta_keys=META_KEYS, **kwargs):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {}
        img_metas = {k: results[k] for k in self.meta_keys if k in results}
        data['img_metas'] = img_metas
        for key in self.keys:
            data[key] = results[key]
        return data


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time wrapper; the DAS configs use a single scale and
    flip=False, optionally flip=True for flip-test averaging.

    With ``flip=True`` the second view's raw image is mirrored
    horizontally *before* the transforms run (so resize keeps ratio and
    padding stays on the right in both views); ``apis/test.py`` unflips
    the decoded predictions about the original width and averages them
    with the direct view, swapping ``flip_pairs`` joints.
    """

    def __init__(self, transforms, img_scale, flip=False,
                 flip_pairs=None, **kwargs):
        self.transforms = Compose(transforms)
        self.img_scale = [tuple(img_scale)] if isinstance(
            img_scale, (tuple, list)) and not isinstance(
                img_scale[0], (tuple, list)) else [tuple(s)
                                                  for s in img_scale]
        self.flip = flip
        self.flip_pairs = [list(p) for p in (flip_pairs or [])]
        # flip the raw image ourselves unless a flip transform will
        self._has_flip_transform = any(
            isinstance(t, RandomFlipPose3D)
            for t in self.transforms.transforms)

    def __call__(self, results):
        aug_data = []
        flips = [False, True] if self.flip else [False]
        for scale in self.img_scale:
            for f in flips:
                _results = dict(results)
                _results['scale'] = scale
                _results['flip'] = f
                _results['flip_pairs'] = self.flip_pairs
                if f and not self._has_flip_transform:
                    _results['img'] = np.ascontiguousarray(
                        np.flip(_results['img'], axis=1))
                data = self.transforms(_results)
                if data is not None:
                    aug_data.append(data)
        # merge list-of-dicts -> dict-of-lists (mmcv convention)
        merged = {k: [d[k] for d in aug_data] for k in aug_data[0]}
        return merged
