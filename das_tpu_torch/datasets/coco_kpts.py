"""COCO 2D-keypoints mixing dataset, the port's copy of
``das_tpu/datasets/coco_kpts.py``.

Rebuild of the reference ``COCOKeypointsDataset``
(ref: mmdet3d/datasets/coco_keypoints_dataset.py:14-290): parses COCO-17
keypoints as depth-0 "3D" poses (the ``is_2d`` masking path in the loss),
roots at the hip midpoint with validity checks (ref :183-199), and remaps
COCO-17 joints onto the panoptic-15 or muco-21 skeletons via the
``convert_ids`` tables (ref :229-269).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from ..config.registry import DATASETS
from .base import BasePoseDataset

# COCO-17 -> panoptic-15 (ref coco_keypoints_dataset.py:43,260)
CONVERT_IDS_PANOPTIC = np.array(
    [-1, 0, -1, 5, 7, 9, 11, 13, 15, 6, 8, 10, 12, 14, 16], np.int64)
# COCO-17 -> muco-21 (ref coco_keypoints_dataset.py:20,233)
CONVERT_IDS_MUCO = np.array(
    [-1, -1, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15,
     -1, -1, -1, -1, -1, -1, -1], np.int64)


@DATASETS.register_module()
class COCOKeypointsDataset(BasePoseDataset):
    CLASSES = ('person',)
    NUM_COCO_JOINTS = 17

    def __init__(self, data_root=None, use_bbox_center=False,
                 convert_ids: Optional[str] = None, use_nms=False, **kwargs):
        super().__init__(data_root=data_root, **kwargs)
        self.num_joints = self.NUM_COCO_JOINTS
        self.convert_ids = convert_ids
        self.use_bbox_center = use_bbox_center

    def _parse_ann_info(self, img_info, ann_info):
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
            if ann.get('area', 1) <= 0 or w < 1 or h < 1:
                continue
            if ann['category_id'] not in self.cat_ids:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get('iscrowd', False):
                gt_bboxes_ignore.append(bbox)
                continue
            kpts = np.array(ann['keypoints'], np.float64).reshape(J, 3)
            pose_vis = (kpts[..., 2] > 0).astype(np.float64)
            bbox_np = np.array(bbox, np.float64).reshape(2, 2)
            bbox_np[:, 0] = bbox_np[:, 0].clip(0, img_info['width'] - 1)
            bbox_np[:, 1] = bbox_np[:, 1].clip(0, img_info['height'] - 1)
            bbox_wh = bbox_np[1] - bbox_np[0]
            if (bbox_wh < 2).any() or bbox_wh.prod() < 64:
                continue
            pose_3d = kpts.copy()
            pose_3d[..., 2] = 0
            if not self.use_bbox_center:
                # root = hip midpoint, both hips must be inside the bbox
                # and visible (ref :183-199)
                root_joints = kpts[[11, 12], :2]
                inside = ((root_joints < bbox_np[1]) &
                          (root_joints > bbox_np[0])).all() and \
                    abs(root_joints[0, 1] - root_joints[1, 1]) < h / 4
                if not inside and (pose_vis[11] == 0 or pose_vis[12] == 0):
                    continue
                if pose_vis[11] == 0 or pose_vis[12] == 0:
                    continue
                c2d = 0.5 * (pose_3d[11] + pose_3d[12])
            else:
                c2d = np.zeros(3, np.float64)
                c2d[:2] = bbox_np.mean(0)
            gt_bboxes.append(bbox)
            gt_labels.append(self.cat2label[ann['category_id']])
            gt_poses_3d.append(np.concatenate(
                [c2d.reshape(-1), pose_3d.reshape(-1), pose_vis]))
            centers2d.append(c2d[:2])
            depths.append(c2d[2])

        if not gt_bboxes:
            return None
        gt_bboxes = np.array(gt_bboxes, np.float32)
        gt_labels = np.array(gt_labels, np.int64)
        gt_poses_3d = np.array(gt_poses_3d, np.float32)
        centers2d = np.array(centers2d, np.float32)
        depths = np.array(depths, np.float32)

        if self.convert_ids is not None:
            cids = {'muco': CONVERT_IDS_MUCO,
                    'panoptic': CONVERT_IDS_PANOPTIC}[self.convert_ids]
            c2d = gt_poses_3d[:, :3]
            uvd = gt_poses_3d[:, 3:3 + 3 * J].reshape(-1, J, 3)
            vis = gt_poses_3d[:, 3 + 3 * J:]
            n = uvd.shape[0]
            exp_uvd = np.zeros((n, len(cids), 3), np.float32)
            exp_vis = np.zeros((n, len(cids)), np.float32)
            exp_uvd[:, cids >= 0] = uvd[:, cids[cids >= 0]]
            exp_vis[:, cids >= 0] = vis[:, cids[cids >= 0]]
            gt_poses_3d = np.concatenate(
                [c2d, exp_uvd.reshape(n, -1), exp_vis],
                axis=1).astype(np.float32)
            if exp_vis.sum() < 6:
                return None

        return dict(
            bboxes=gt_bboxes,
            labels=gt_labels,
            gt_poses_3d=gt_poses_3d,
            gt_labels_3d=copy.deepcopy(gt_labels),
            centers2d=centers2d,
            depths=depths,
            bboxes_ignore=np.array(gt_bboxes_ignore, np.float32).reshape(
                -1, 4))
