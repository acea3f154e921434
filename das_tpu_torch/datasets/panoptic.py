"""CMU Panoptic monocular dataset + root-aligned MPJPE evaluator, the
port's copy of ``das_tpu/datasets/panoptic.py``.

Rebuild of the reference ``CMUPanopticDataset``
(ref: mmdet3d/datasets/cmupanoptic_mono_dataset.py:37-424):

* annotation parsing with depth normalisation ``z /= depth_factor; z /= f``
  and ``abs_dz`` (joint z stored as dz to the root) (ref :194-217),
* ``gt_poses_3d`` packing ``[c2d(3), uvd(3J), vis(J)]`` (ref :218-222),
* evaluate(): depth denormalisation, ``pixel2world`` back-projection,
  greedy pred<->gt matching by visible-joint distance, root-aligned MPJPE
  in mm (cm * 10), mean-pose fallback for empty predictions
  (ref :372-424).
"""

from __future__ import annotations

import copy
import os
from collections import OrderedDict, defaultdict
from typing import Dict, List

import numpy as np

from ..config.registry import DATASETS
from ..core.camera import pixel2world
from .base import BasePoseDataset


@DATASETS.register_module()
class CMUPanopticDataset(BasePoseDataset):
    CLASSES = ('person',)
    JOINTS_DEF = {
        'neck': 0, 'nose': 1, 'mid-hip': 2,
        'l-shoulder': 3, 'l-elbow': 4, 'l-wrist': 5,
        'l-hip': 6, 'l-knee': 7, 'l-ankle': 8,
        'r-shoulder': 9, 'r-elbow': 10, 'r-wrist': 11,
        'r-hip': 12, 'r-knee': 13, 'r-ankle': 14,
    }
    skeleton = [[0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [0, 9], [9, 10],
                [10, 11], [2, 6], [2, 12], [6, 7], [7, 8], [12, 13],
                [13, 14]]
    ROOT_IDX = 2

    def __init__(self, data_root=None, use_bbox_center=False,
                 norm_depth=True, abs_dz=True, depth_factor=1, **kwargs):
        super().__init__(data_root=data_root, **kwargs)
        self.num_joints = len(self.JOINTS_DEF)
        self.norm_depth = norm_depth
        self.depth_factor = depth_factor
        self.abs_dz = abs_dz
        if abs_dz:
            assert norm_depth
        self.use_bbox_center = use_bbox_center

    # ------------------------------------------------------- parsing
    def _parse_ann_info(self, img_info, ann_info):
        K = img_info['cam']['K']
        f = np.sqrt(K[0][0] * K[1][1])
        gt_bboxes, gt_labels, gt_poses_3d = [], [], []
        gt_bboxes_ignore, centers2d, depths = [], [], []
        for ann in ann_info:
            if ann.get('ignore', False):
                continue
            x1, y1, w, h = ann['bbox']
            inter_w = max(0, min(x1 + w, img_info['width']) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info['height']) - max(y1, 0))
            if inter_w * inter_h == 0:
                continue
            if ann.get('area', 1) <= 0 or w < 1 or h < 1:
                continue
            if ann['category_id'] not in self.cat_ids:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get('iscrowd', False):
                gt_bboxes_ignore.append(bbox)
                continue
            pose_3d = np.array(ann['joints3d_img'], np.float64)
            pose_vis = np.array(ann['joints2d_vis'], np.float64)
            if self.norm_depth:
                pose_3d[:, 2] /= self.depth_factor
                if self.abs_dz:
                    dz = pose_3d[:, 2] - pose_3d[[self.ROOT_IDX], 2]
                pose_3d[:, 2] /= f
            if pose_3d.max() - pose_3d.min() < 10:
                continue
            if not self.use_bbox_center:
                if pose_vis[self.ROOT_IDX][0] == 0:
                    gt_bboxes_ignore.append(bbox)
                    continue
                c2d = pose_3d[self.ROOT_IDX].copy()
            else:
                c2d = pose_3d[self.ROOT_IDX].copy()
                c2d[0] = x1 + 0.5 * w
                c2d[1] = y1 + 0.5 * h
            gt_bboxes.append(bbox)
            gt_labels.append(self.cat2label[ann['category_id']])
            if self.norm_depth and self.abs_dz:
                pose_3d[:, 2] = dz
            gt_poses_3d.append(np.concatenate([
                c2d.reshape(-1), pose_3d.reshape(-1),
                pose_vis[:, 0].reshape(-1)]))
            centers2d.append(c2d[:2])
            depths.append(c2d[2])

        J = self.num_joints
        if gt_bboxes:
            gt_bboxes = np.array(gt_bboxes, np.float32)
            gt_labels = np.array(gt_labels, np.int64)
            gt_poses_3d = np.array(gt_poses_3d, np.float32)
            centers2d = np.array(centers2d, np.float32)
            depths = np.array(depths, np.float32)
        else:
            gt_bboxes = np.zeros((0, 4), np.float32)
            gt_labels = np.array([], np.int64)
            gt_poses_3d = np.zeros((0, 3 + 4 * J), np.float32)
            centers2d = np.zeros((0, 2), np.float32)
            depths = np.zeros((0,), np.float32)
            if not self.test_mode:
                return None
        if not self.test_mode and \
                gt_poses_3d[:, 3 + 3 * J:].sum() < 6:
            return None

        ann = dict(
            bboxes=gt_bboxes,
            labels=gt_labels,
            gt_poses_3d=gt_poses_3d,
            gt_labels_3d=copy.deepcopy(gt_labels),
            centers2d=centers2d,
            depths=depths,
            bboxes_ignore=np.array(gt_bboxes_ignore, np.float32).reshape(
                -1, 4))
        if 'cam' in img_info:
            ann['cam'] = img_info['cam']
        return ann

    # ------------------------------------------------------ evaluation
    @staticmethod
    def vectorize_distance(preds, gts, vis):
        """Greedy matching by visible-joint distance (ref :361-366)."""
        mse = np.sqrt(((gts[:, None] - preds[None]) ** 2).sum(axis=-1))
        mse = mse * vis[:, None]
        return mse.mean(-1).argmin(1)

    @staticmethod
    def mse(preds, gts, vis):
        return np.sqrt(((preds[vis > 0] - gts[vis > 0]) ** 2).sum(axis=-1))

    def evaluate(self, outputs: List[Dict], metric='mpjpe',
                 res_folder=None, **kwargs):
        """Root-aligned MPJPE in mm (ref :267-424).

        ``outputs`` entries: poses (P,J,3) np, scores (P,), image_paths.
        ``res_folder``: when set, also write the reference's
        ``result_keypoints.json`` interchange file there (ref :274,:314-327
        always writes; here it is opt-in)."""
        metrics = metric if isinstance(metric, list) else [metric]
        assert all(m.lower() == 'mpjpe' for m in metrics)
        J = self.num_joints
        if res_folder is not None:
            self.format_results(outputs, res_folder=res_folder)

        results_by_image = defaultdict(list)
        for out in outputs:
            image_id = self._result_image_id(out['image_paths'][0])
            for kpt in np.asarray(out['poses']):
                results_by_image[image_id].append(kpt[:, :3])

        # mean pose over the dataset (fallback for empty preds, ref :379-383)
        all_pose = np.array([a['joints3d'] for a in
                             self.coco.anns.values()], np.float64) / 10
        all_vis = np.array([a['joints3d_vis'] for a in
                            self.coco.anns.values()], np.float64)
        all_pose = all_pose - all_pose[:, [self.ROOT_IDX], :]
        with np.errstate(invalid='ignore'):
            mean_pose = (all_pose * all_vis).sum(0) / all_vis.sum(0)
        mean_pose[np.isnan(mean_pose)] = 0

        total, count = 0.0, 0
        for idx, img_id in enumerate(self.img_ids):
            ann = self._parse_ann_info(
                self.coco.load_imgs([img_id])[0],
                self.coco.load_anns(self.coco.get_ann_ids([img_id])))
            cam = {k: np.array(v) for k, v in ann['cam'].items()}
            norm_depth = np.sqrt(cam['K'][0, 0] * cam['K'][1, 1])
            pred_img = np.array(results_by_image.get(img_id, []),
                                np.float64).reshape(-1, J, 3)
            if self.norm_depth:
                if self.abs_dz:
                    root_depth = pred_img[:, [self.ROOT_IDX], 2]
                    dz = pred_img[..., 2] - root_depth
                    pred_img[..., 2] = root_depth * norm_depth + dz
                    pred_img[..., 2] *= self.depth_factor
                else:
                    pred_img[..., 2] *= norm_depth * self.depth_factor
            pred = pixel2world(pred_img.reshape(-1, 3).T, cam['K'],
                               cam['R'], cam['t']).T.reshape(pred_img.shape)
            gt_img = ann['gt_poses_3d'][:, 3:3 + 3 * J] \
                .reshape(-1, J, 3).astype(np.float64)
            if self.norm_depth and self.abs_dz:
                gt_img[..., 2] += ann['gt_poses_3d'][:, [2]] * norm_depth
            gt = pixel2world(gt_img.reshape(-1, 3).T, cam['K'], cam['R'],
                             cam['t']).T.reshape(gt_img.shape)
            gt_vis = ann['gt_poses_3d'][:, 3 + 3 * J:]
            if len(gt) == 0:
                continue
            pred = pred - pred[:, [self.ROOT_IDX]]
            if len(pred) == 0:
                pred = np.concatenate([pred, mean_pose[None]])
            gt = gt - gt[:, [self.ROOT_IDX]]
            paired = self.vectorize_distance(pred, gt, gt_vis)
            jpe = self.mse(pred[paired], gt, gt_vis)
            if len(jpe) > 0:
                total += jpe.mean() * 10 * len(gt)   # cm -> mm
                count += len(gt)
        mpjpe = total / max(count, 1)
        return OrderedDict([('MPJPE:', f'{mpjpe:.2f}mm'),
                            ('mpjpe_mm', mpjpe)])
