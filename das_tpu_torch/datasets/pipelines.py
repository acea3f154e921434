"""Host pipeline transforms (numpy, cv2), mmdet-pipeline protocol; the
port's copy of ``das_tpu/datasets/pipelines.py`` (ref:
configs/das/exp_panoptic.py:59-155 and
mmdet3d/datasets/pipelines/transforms_3d.py):

* ``LoadImageFromFile`` (through ``utils/image.imread``) /
  ``LoadAnnotationsPose3D``            (ref loading.py:672-736)
* ``Resize`` / ``ResizePose``          (mmdet Resize, keep_ratio; ref
  transforms_3d.py:20-61)
* ``RandomFlipPose3D``                 (ref transforms_3d.py:236-356)
* ``PhotoMetricDistortion``            (mmdet semantics)
* ``GlobalRotScaleTransPose``          (ref transforms_3d.py:864-1130)
* ``Normalize`` / ``Pad`` / ``DefaultFormatBundlePose3D`` / ``Collect3D``
  / ``MultiScaleFlipAug``

Every random draw comes from the sample's own generator,
``results['rng']`` (an ``np.random.RandomState`` that the dataset puts into
each training sample), in the JAX transforms' order draw for draw: a
transform seeded ``RandomState(s)`` gives what the JAX one gives after
``np.random.seed(s)``. A transform that needs no draw (one scale, ``flip``
already set) reads no generator.

``Resize`` and ``GlobalRotScaleTransPose`` take the port's C++ resize and
warp (``datasets/native.py``, built with g++ at first use) for a float32
HxWx3 image, the JAX transforms' default path and condition: every shipped
config loads its images with ``to_float32=True``. Any other image takes
``cv2``, as in the JAX package. A failed build of the library raises; no
transform takes ``cv2`` because it is missing. ``cv2`` is imported where it
runs (that resize and warp, ``PhotoMetricDistortion``'s HSV round trip,
``get_affine_transform``): on a host without it those raise, and evaluation
takes the device path (``apis/test.py``, ``device_preprocess``), which needs
only a decode.
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import numpy as np

from ..config.registry import PIPELINES, build_from_cfg
from ..utils.image import imread
from . import native


def _rng(results) -> np.random.RandomState:
    """The sample's generator, ``results['rng']``; every random draw of a
    transform comes from it."""
    rng = results.get('rng')
    if rng is None:
        raise KeyError("a random transform needs results['rng'], the "
                       "sample's np.random.RandomState (the dataset puts "
                       'one into every training sample)')
    return rng


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

    def _pick_scale(self, results):
        if len(self.img_scale) == 1:
            return self.img_scale[0]
        rng = _rng(results)
        if self.multiscale_mode == 'range':
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_edge = rng.randint(min(longs), max(longs) + 1)
            short_edge = rng.randint(min(shorts), max(shorts) + 1)
            return (long_edge, short_edge)
        idx = rng.randint(len(self.img_scale))
        return self.img_scale[idx]

    def __call__(self, results):
        if 'scale' not in results:
            results['scale'] = self._pick_scale(results)
        img = results['img']
        h, w = img.shape[:2]
        new_h, new_w = _rescale_size(h, w, results['scale'])
        if img.dtype == np.float32 and img.ndim == 3 and \
                img.shape[2] == 3 and native.available():
            resized = native.resize_bilinear(img, (new_h, new_w))
        else:
            import cv2
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
class ResizePose(Resize):
    """Resize + pose rescale (ref transforms_3d.py:20-61)."""

    def __init__(self, scale_depth=False, abs_dz=False, **kwargs):
        super().__init__(**kwargs)
        self.scale_depth = scale_depth
        self.abs_dz = abs_dz
        if self.abs_dz:
            assert scale_depth

    def __call__(self, results):
        super().__call__(results)
        scale_factor = results['scale_factor'][:2]
        num_joints = (results['gt_poses_3d'].shape[-1] - 3) // 4
        centers2d = results['centers2d'] * scale_factor
        depths = results['depths']
        joints = results['gt_poses_3d'][:, 3:3 + num_joints * 3] \
            .reshape(-1, num_joints, 3).copy()
        joints_vis = results['gt_poses_3d'][:, 3 + num_joints * 3:]
        joints[..., :2] = joints[..., :2] * scale_factor
        if self.scale_depth:
            depth_scale = np.sqrt(scale_factor.prod())
            depths = depths / depth_scale
            if not self.abs_dz:
                joints[..., 2] = joints[..., 2] / depth_scale
        results['centers2d'] = centers2d
        results['depths'] = depths
        results['gt_poses_3d'] = np.concatenate([
            centers2d, depths.reshape(-1, 1),
            joints.reshape(-1, num_joints * 3), joints_vis
        ], axis=-1).astype(np.float32)
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
            results['flip'] = bool(_rng(results).rand() < self.flip_ratio)
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
class PhotoMetricDistortion:
    """mmdet photometric distortion: random brightness/contrast/HSV."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results):
        import cv2

        rng = _rng(results)
        img = results['img'].astype(np.float32)
        if rng.randint(2):
            img += rng.uniform(-self.brightness_delta, self.brightness_delta)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        # saturation / hue in HSV; the second integer is drawn only when the
        # first is 0, as the JAX transform's ``or`` draws it
        if rng.randint(2) or rng.randint(2):
            hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                               cv2.COLOR_BGR2HSV).astype(np.float32)
            if rng.randint(2):
                hsv[..., 1] *= rng.uniform(self.saturation_lower,
                                           self.saturation_upper)
            if rng.randint(2):
                hsv[..., 0] += rng.uniform(-self.hue_delta, self.hue_delta)
                hsv[..., 0][hsv[..., 0] > 360] -= 360
                hsv[..., 0][hsv[..., 0] < 0] += 360
            hsv[..., 1] = np.clip(hsv[..., 1], 0, 255)
            img = cv2.cvtColor(hsv.astype(np.uint8),
                               cv2.COLOR_HSV2BGR).astype(np.float32)
        if mode == 0 and rng.randint(2):
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        results['img'] = img
        return results


def get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn,
            src_point[0] * sn + src_point[1] * cs]


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], np.float32), inv=0):
    """The affine matrix (ref transforms_3d.py:864-898)."""
    import cv2

    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale])
    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]
    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0, :] = center + scale * shift
    src[1, :] = center + src_dir + scale * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])
    if inv:
        return cv2.getAffineTransform(np.float32(dst), np.float32(src))
    return cv2.getAffineTransform(np.float32(src), np.float32(dst))


@PIPELINES.register_module()
class GlobalRotScaleTransPose:
    """Random rot/scale/translate as a 2D affine warp of image + poses
    (ref transforms_3d.py:902-1130), incl. joint-visibility filtering.
    Returns ``None`` (the dataset draws another sample) when fewer than 2
    roots stay in the image."""

    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05), translation_std=(0, 0),
                 num_joints=None, scale_depth=False, abs_dz=False,
                 img_norm_cfg=None, use_bbox_center=False,
                 abs_dz_ref_compat=False, **kwargs):
        if not isinstance(rot_range, (list, tuple, np.ndarray)):
            rot_range = [-rot_range, rot_range]
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = translation_std
        self.num_joints = num_joints
        self.scale_depth = scale_depth
        self.abs_dz = abs_dz
        # the JAX package's recorded deviation, kept as it is: the reference
        # (transforms_3d.py:1000-1003) writes ``joints_depth[0] *= scale`` on
        # a (batch, J+1, 1) array, which scales every joint depth of the
        # FIRST PERSON only, against its own abs_dz intent (root depth
        # absolute, joint dz relative). The ROOT depth of EVERY person is
        # scaled (``joints_depth[:, 0]``); abs_dz_ref_compat=True gives the
        # reference's literal behaviour.
        self.abs_dz_ref_compat = abs_dz_ref_compat
        if abs_dz:
            assert scale_depth
        if img_norm_cfg is not None:
            mean = list(img_norm_cfg['mean'])
            self.img_mean = mean[::-1] if img_norm_cfg.get('to_rgb') \
                else mean
        else:
            self.img_mean = [127.5, 127.5, 127.5]
        self.use_bbox_center = use_bbox_center

    def __call__(self, input_dict):
        rng = _rng(input_dict)
        rot = rng.uniform(*self.rot_range) / math.pi * 180
        scale = rng.uniform(*self.scale_ratio_range)
        trans_factor = rng.normal(
            scale=np.array(self.translation_std, np.float32), size=2)

        h, w = input_dict['img_shape'][:2]
        J = self.num_joints
        center = np.array([w / 2, h / 2], np.float64) * (1 + trans_factor)
        new_scale = np.array([w, h], np.float64) * scale
        trans = get_affine_transform(center, new_scale, rot, [w, h])

        for key in input_dict.get('img_fields', ['img']):
            img = input_dict[key]
            if img.dtype == np.float32 and img.ndim == 3 and \
                    img.shape[2] == 3 and native.available():
                input_dict[key] = native.affine_warp(
                    img, trans, (int(h), int(w)), self.img_mean)
            else:
                import cv2
                input_dict[key] = cv2.warpAffine(
                    img, trans, (int(w), int(h)), flags=cv2.INTER_LINEAR,
                    borderValue=self.img_mean)

        # warp centers + joints through the same affine
        joints = input_dict['gt_poses_3d'][:, :3 + J * 3].copy()
        batch = len(joints)
        joints_vis = input_dict['gt_poses_3d'][:, 3 + J * 3:] \
            .reshape(batch, J).copy()
        joints = joints.reshape(batch, J + 1, 3)
        joints_depth = joints[..., [2]].copy()
        if self.scale_depth:
            if not self.abs_dz:
                joints_depth = joints_depth * scale
            elif self.abs_dz_ref_compat:
                # reference-literal: first PERSON's depths (see __init__)
                joints_depth[0] = joints_depth[0] * scale
            else:
                # abs_dz: only the root (index 0 = center) depth scales
                joints_depth[:, 0] = joints_depth[:, 0] * scale

        hom = joints.copy()
        hom[..., 2] = 1
        warped = hom.reshape(-1, 3) @ trans.T
        warped = warped.reshape(batch, J + 1, 2)
        new_joints = np.concatenate([warped, joints_depth], axis=-1)

        # warp bboxes via their 4 corners
        gt_bboxes = input_dict['gt_bboxes']
        corners = gt_bboxes.reshape(batch, 2, 2)
        corners_rev = corners.copy()
        corners_rev[..., 1] = corners[..., 1][:, ::-1]
        corners4 = np.concatenate([corners, corners_rev], axis=1)
        corners4 = np.concatenate(
            [corners4, np.ones([batch, 4, 1])], axis=-1).reshape(-1, 3)
        corners4 = (corners4 @ trans.T)[:, :2].reshape(batch, 4, 2)
        new_bboxes = np.concatenate(
            [corners4.min(axis=1), corners4.max(axis=1)], axis=-1)
        new_bboxes[:, 0::2] = new_bboxes[:, 0::2].clip(0, w - 1)
        new_bboxes[:, 1::2] = new_bboxes[:, 1::2].clip(0, h - 1)

        # out-of-bound joints -> invisible; root out -> drop the person
        out_of_bound = (warped[..., 0] < 0) | (warped[..., 0] > w - 1) | \
                       (warped[..., 1] < 0) | (warped[..., 1] > h - 1)
        joints_vis[out_of_bound[:, 1:]] = 0
        if not self.use_bbox_center:
            valid = ~out_of_bound[:, 0]
            gt_poses_3d = np.concatenate([
                new_joints.reshape(batch, -1), joints_vis
            ], axis=-1).astype(np.float32)
            if valid.sum() < 2:
                return None
        else:
            new_centers = np.stack(
                [new_bboxes[:, 0::2].mean(-1), new_bboxes[:, 1::2].mean(-1),
                 new_joints[:, 0, -1]], axis=-1)
            gt_poses_3d = np.concatenate([
                new_centers, new_joints[:, 1:].reshape(batch, -1),
                joints_vis
            ], axis=-1).astype(np.float32)
            valid = (joints_vis.sum(-1) >= 3) & \
                ((gt_bboxes[:, 2:] - gt_bboxes[:, :2]).prod() > 64)

        input_dict['gt_poses_3d'] = gt_poses_3d[valid].copy()
        input_dict['gt_bboxes'] = new_bboxes[valid]
        input_dict['centers2d'] = gt_poses_3d[:, :2][valid].copy()
        input_dict['depths'] = gt_poses_3d[:, 2][valid].copy()
        input_dict['gt_labels'] = input_dict['gt_labels'][valid]
        input_dict['gt_labels_3d'] = input_dict['gt_labels_3d'][valid]
        input_dict['transform_mat'] = trans
        input_dict['pcd_rot'] = rot
        input_dict['pcd_scale_factor'] = scale
        input_dict['pcd_trans'] = trans_factor
        return input_dict


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
