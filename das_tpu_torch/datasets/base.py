"""Base COCO-style pose dataset machinery, the port's copy of
``das_tpu/datasets/base.py``.

Replaces the mmdet CocoDataset plumbing the reference datasets inherit
(filtering, cat mapping, train/test sample preparation) with a compact
framework-native base class. Subclasses implement ``_parse_ann_info``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .coco_index import CocoIndex
from .pipelines import Compose


def coco_keypoint_results_kernel(keypoints: List[List[Dict]],
                                 num_joints: int, cat_id: int = 1):
    """Flatten per-image person dicts into COCO-keypoint result entries
    (ref cmupanoptic_mono_dataset.py:329-359 /
    mupots_3dhp.py `_coco_keypoint_results_one_category_kernel`):
    each entry carries image_id, category_id, a flat 3J keypoint list,
    score, and an xywh bbox from the keypoint extent."""
    cat_results = []
    for img_kpts in keypoints:
        if len(img_kpts) == 0:
            continue
        key_points = np.array(
            [k['keypoints'] for k in img_kpts]).reshape(-1, num_joints * 3)
        for img_kpt, key_point in zip(img_kpts, key_points):
            kpt = key_point.reshape((num_joints, 3))
            left_top = np.amin(kpt, axis=0)
            right_bottom = np.amax(kpt, axis=0)
            w = right_bottom[0] - left_top[0]
            h = right_bottom[1] - left_top[1]
            cat_results.append({
                'image_id': img_kpt['image_id'],
                'category_id': cat_id,
                'keypoints': key_point.tolist(),
                'score': float(img_kpt['score']),
                'bbox': np.array(
                    [left_top[0], left_top[1], w, h]).tolist(),
            })
    return cat_results


def write_coco_keypoint_results(results: List[Dict], res_file: str):
    """Write the reference's interchange artifact (result_keypoints.json,
    ref cmupanoptic_mono_dataset.py:314-327): sort_keys + indent=4 so a
    das_tpu_torch run is file-level diffable against a reference run."""
    d = os.path.dirname(res_file)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(res_file, 'w') as f:
        json.dump(results, f, sort_keys=True, indent=4)
    return results


class BasePoseDataset:
    CLASSES: Sequence[str] = ('person',)

    def __init__(self,
                 ann_file: str,
                 pipeline: Optional[list] = None,
                 data_root: Optional[str] = None,
                 img_prefix: str = '',
                 classes: Optional[Sequence[str]] = None,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 load_interval: int = 1,
                 **kwargs):
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.data_root = data_root
        if data_root is not None and not os.path.isabs(ann_file):
            ann_file = os.path.join(data_root, ann_file)
        self.ann_file = ann_file
        # configs that give only data_root (MuPoTS/MuCo, matching the
        # reference) expect image file_names resolved against it — the
        # reference's evaluate() strips data_root from the loaded image
        # paths (ref mupots_3dhp.py:209-214), so the prefix must be it
        self.img_prefix = img_prefix or (data_root or '')
        self.test_mode = test_mode
        self.load_interval = load_interval

        self.coco = CocoIndex(ann_file)
        self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES) or \
            self.coco.get_cat_ids()
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        self.data_infos = self.coco.load_imgs(self.img_ids)
        if not test_mode and filter_empty_gt:
            keep = [i for i, img_id in enumerate(self.img_ids)
                    if len(self.coco.get_ann_ids([img_id])) > 0]
            self.img_ids = [self.img_ids[i] for i in keep]
            self.data_infos = [self.data_infos[i] for i in keep]
        if load_interval > 1:
            self.img_ids = self.img_ids[::load_interval]
            self.data_infos = self.data_infos[::load_interval]

        # keyed on the annotation-relative file_name (unique by COCO
        # construction); the basename map is a fallback for callers that
        # hand back bare filenames — ambiguous when different
        # subdirectories share basenames, so duplicates are tracked and
        # refuse silent misattribution in _result_image_id
        self.name2id = {}
        self._basename2id = {}
        self._dup_basenames = set()
        for info in self.data_infos:
            self.name2id[info['file_name']] = info['id']
            base = os.path.basename(info['file_name'])
            if base in self._basename2id:
                self._dup_basenames.add(base)
            self._basename2id[base] = info['id']

        self.pipeline = Compose(pipeline) if pipeline else None

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.data_infos)

    def get_ann_info(self, idx: int):
        img_id = self.img_ids[idx]
        ann_ids = self.coco.get_ann_ids(img_ids=[img_id])
        ann_info = self.coco.load_anns(ann_ids)
        return self._parse_ann_info(self.data_infos[idx], ann_info)

    def _parse_ann_info(self, img_info, ann_info):
        raise NotImplementedError

    def pre_pipeline(self, results: Dict):
        results['img_prefix'] = self.img_prefix
        results['bbox_fields'] = []
        results['img_fields'] = []
        results['pose3d_fields'] = []

    def prepare_train_img(self, idx: int, rng: np.random.RandomState):
        ann_info = self.get_ann_info(idx)
        if ann_info is None or len(ann_info['gt_poses_3d']) == 0:
            return None
        results = dict(img_info=self.data_infos[idx], ann_info=ann_info)
        self.pre_pipeline(results)
        results['rng'] = rng
        return self.pipeline(results)

    def prepare_test_img(self, idx: int):
        ann_info = self.get_ann_info(idx)
        n_ann = dict(
            gt_poses_3d=ann_info['gt_poses_3d'],
            gt_labels_3d=ann_info['gt_labels_3d'],
            centers2d=ann_info['centers2d'],
            depths=ann_info['depths'])
        if 'cam' in ann_info:
            n_ann['cam'] = ann_info['cam']
        results = dict(img_info=self.data_infos[idx], ann_info=n_ann)
        self.pre_pipeline(results)
        return self.pipeline(results)

    # ------------------------------------------------- result formatting
    def _result_image_id(self, image_path: str) -> int:
        """Map an output image path back to its COCO image id.

        Tries the img_prefix-relative path first (the unique key);
        falls back to the basename only when it is unambiguous."""
        prefix = self.img_prefix or ''
        if prefix and not prefix.endswith('/'):
            prefix += '/'
        rel = image_path[len(prefix):] \
            if prefix and image_path.startswith(prefix) else image_path
        if rel in self.name2id:
            return self.name2id[rel]
        base = os.path.basename(image_path)
        if base in self._dup_basenames:
            raise KeyError(
                f'{image_path!r}: basename {base!r} is shared by several '
                f'images and the prefix-relative lookup missed — cannot '
                f'attribute results unambiguously')
        return self._basename2id[base]

    def format_results(self, outputs: List[Dict], res_folder: str = None,
                       res_file: str = None):
        """Write the reference's COCO-keypoint result json
        (``result_keypoints.json``; ref cmupanoptic_mono_dataset.py:267-327,
        mupots_3dhp.py:195-258) and return (entries, path).

        Unlike the reference — which unconditionally writes to ``tmp/``
        inside ``evaluate`` — writing here is explicit: call this method
        (or pass ``res_folder=`` to ``evaluate`` / ``--format-only`` /
        ``--res-folder`` in ``das_tpu_torch.tools.test``)."""
        if res_file is None:
            res_file = os.path.join(res_folder or 'tmp',
                                    'result_keypoints.json')
        J = self.num_joints
        kpts = defaultdict(list)
        for out in outputs:
            image_id = self._result_image_id(out['image_paths'][0])
            poses = np.asarray(out['poses'], np.float64)[:, :J]
            scores = np.asarray(out['scores'], np.float64).reshape(-1)
            vis = (np.asarray(out['vis'], np.float64)[:, :J]
                   if 'vis' in out else np.ones((len(poses), J)))
            for p, kpt in enumerate(poses):
                area = float((np.max(kpt[:, 0]) - np.min(kpt[:, 0])) *
                             (np.max(kpt[:, 1]) - np.min(kpt[:, 1])))
                kpts[image_id].append(dict(
                    keypoints=kpt[:, 0:3], score=float(scores[p]),
                    vis=vis[p], image_id=image_id, area=area))
        entries = coco_keypoint_results_kernel(list(kpts.values()), J)
        write_coco_keypoint_results(entries, res_file)
        return entries, res_file

    def __getitem__(self, idx: int):
        return self.sample(idx)

    def sample(self, idx: int, rng: Optional[np.random.RandomState] = None):
        """Sample ``idx``. In train mode every random draw comes from
        ``rng`` (``RandomState(idx)`` when none is given): the transforms'
        draws, then, where the pipeline rejects the sample, the index of
        the one drawn in its place (mmdet's ``_rand_another``), in the JAX
        dataset's order."""
        if self.test_mode:
            return self.prepare_test_img(idx)
        if rng is None:
            rng = np.random.RandomState(idx)
        for _ in range(64):
            data = self.prepare_train_img(idx, rng)
            if data is not None:
                return data
            idx = rng.randint(len(self))
        raise RuntimeError('failed to draw a valid training sample')


class ConcatDataset:
    """list-of-dataset-configs mixing (ref datasets/builder.py:20-43)."""

    def __init__(self, datasets: List[Any]):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        return self.sample(idx)

    def sample(self, idx, rng=None):
        d = int(np.searchsorted(self.cum, idx, side='right'))
        base = 0 if d == 0 else int(self.cum[d - 1])
        return self.datasets[d].sample(idx - base, rng)


class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.sample(idx)

    def sample(self, idx, rng=None):
        return self.dataset.sample(idx % len(self.dataset), rng)
