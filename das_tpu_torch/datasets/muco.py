"""MuCo-3DHP training dataset, the port's copy of
``das_tpu/datasets/muco.py``.

Rebuild of the reference ``MuCo3DHPDataset``
(ref: mmdet3d/datasets/muco_3dhp.py:26-249): composited multi-person 3D
training frames with per-image pseudo cameras (focal/center in the image
info), the same depth normalisation / abs_dz packing as the Panoptic
dataset, and pelvis (index 14) as the root joint.
"""

from __future__ import annotations

import copy

import numpy as np

from ..config.registry import DATASETS
from .base import BasePoseDataset


@DATASETS.register_module()
class MuCo3DHPDataset(BasePoseDataset):
    CLASSES = ('person',)
    joints_name = (
        'Head_top', 'Thorax', 'R_Shoulder', 'R_Elbow', 'R_Wrist',
        'L_Shoulder', 'L_Elbow', 'L_Wrist', 'R_Hip', 'R_Knee', 'R_Ankle',
        'L_Hip', 'L_Knee', 'L_Ankle', 'Pelvis', 'Spine', 'Head', 'R_Hand',
        'L_Hand', 'R_Toe', 'L_Toe')
    ROOT_IDX = 14

    def __init__(self, data_root=None, use_bbox_center=False,
                 norm_depth=True, abs_dz=True, depth_factor=1, **kwargs):
        super().__init__(data_root=data_root, **kwargs)
        self.num_joints = len(self.joints_name)
        self.norm_depth = norm_depth
        self.depth_factor = depth_factor
        self.abs_dz = abs_dz
        if abs_dz:
            assert norm_depth
        self.use_bbox_center = use_bbox_center

    def _parse_ann_info(self, img_info, ann_info):
        f = img_info['f']
        c = img_info['c']
        cam = dict(
            K=np.array([[f[0], 0., c[0]], [0., f[1], c[1]]]),
            # MuCo pseudo extrinsics (ref muco_3dhp.py:141-146)
            R=np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0],
                        [0.0, 1.0, 0.0]]),
            t=np.array([[0.], [0.], [0.]]))

        J = self.num_joints
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
            if ('area' in ann and ann['area'] <= 0) or w < 1 or h < 1:
                continue
            if ann['category_id'] not in self.cat_ids:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get('iscrowd', False):
                gt_bboxes_ignore.append(bbox)
                continue
            pose_img = np.array(ann['keypoints_img'], np.float64)
            pose_cam = np.array(ann['keypoints_cam'], np.float64)
            pose_3d = np.concatenate([pose_img, pose_cam[:, 2:]], axis=1)
            pose_vis = np.array(ann['keypoints_vis'], np.float64).reshape(-1)
            if self.norm_depth:
                pose_3d[:, 2] /= self.depth_factor
                if self.abs_dz:
                    dz = pose_3d[:, 2] - pose_3d[[self.ROOT_IDX], 2]
                pose_3d[:, 2] /= np.sqrt(f[0] * f[1])
            if pose_3d.max() - pose_3d.min() < 10:
                continue
            if not self.use_bbox_center:
                if pose_vis[self.ROOT_IDX] == 0:
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
                c2d.reshape(-1), pose_3d.reshape(-1), pose_vis]))
            centers2d.append(c2d[:2])
            depths.append(c2d[2])

        if gt_bboxes:
            gt_bboxes = np.array(gt_bboxes, np.float32)
            gt_labels = np.array(gt_labels, np.int64)
            gt_poses_3d = np.array(gt_poses_3d, np.float32)
            centers2d = np.array(centers2d, np.float32)
            depths = np.array(depths, np.float32)
        else:
            if not self.test_mode:
                return None
            gt_bboxes = np.zeros((0, 4), np.float32)
            gt_labels = np.array([], np.int64)
            gt_poses_3d = np.zeros((0, 3 + 4 * J), np.float32)
            centers2d = np.zeros((0, 2), np.float32)
            depths = np.zeros((0,), np.float32)
        if not self.test_mode and gt_poses_3d[:, 3 + 3 * J:].sum() < 6:
            return None

        return dict(
            bboxes=gt_bboxes,
            labels=gt_labels,
            gt_poses_3d=gt_poses_3d,
            gt_labels_3d=copy.deepcopy(gt_labels),
            centers2d=centers2d,
            depths=depths,
            bboxes_ignore=np.array(gt_bboxes_ignore, np.float32).reshape(
                -1, 4),
            cam=cam)
