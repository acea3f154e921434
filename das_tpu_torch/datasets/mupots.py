"""MuPoTS-3D test dataset + 3DPCK@150mm / PCK_abs evaluator, the port's
copy of ``das_tpu/datasets/mupots.py``.

Rebuild of the reference ``MuPots3DHP``
(ref: mmdet3d/datasets/mupots_3dhp.py:18-683), which implements the
standard MuPoTS multi-person evaluation protocol:

* per-image pseudo cameras from the json ``intrinsic`` (ref :74-86),
* predictions back-projected to camera space with the same depth
  denormalisation as training (ref :289-325),
* per-sequence (TS1..TS20) matlab annotations; greedy GT<->pred matching
  with per-person depth-ratio rescaling and bone-length normalisation along
  a safe traversal order (ref :531-566,480-489),
* PCK thresholds over mpii joint groups; headline numbers are
  ``PCK_MEAN`` (root-relative @150mm) and ``PCK_MEAN_ABS`` (ref :338-348).

Sequences are evaluated in a bounded process pool (the reference forks 20
processes). Its workers are spawned, never forked: the caller may have
initialised CUDA, and a forked child of such a process is unsafe. They run
numpy only.
"""

from __future__ import annotations

import copy
import multiprocessing
import os
from collections import OrderedDict, defaultdict
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

import numpy as np

from ..config.registry import DATASETS
from ..core.camera import pixel2world
from .base import BasePoseDataset

# mpii "relavant" joint selection (ref mupots_3dhp.py:406-427)
JOINT_IDX = [i - 1 for i in
             [8, 6, 15, 16, 17, 10, 11, 12, 24, 25, 26, 19, 20, 21, 5, 4, 7]]
PARENTS_O1 = [i - 1 for i in
              [2, 16, 2, 3, 4, 2, 6, 7, 15, 9, 10, 15, 12, 13, 15, 15, 2]]
SAFE_TRAVERSAL = [i - 1 for i in
                  [15, 16, 2, 1, 17, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                   14]]

JOINT_GROUPS = [
    ('Head', [0]), ('Neck', [1]), ('Shou', [2, 5]), ('Elbow', [3, 6]),
    ('Wrist', [4, 7]), ('Hip', [8, 11]), ('Knee', [9, 12]),
    ('Ankle', [10, 13]),
]
ALL_GROUP_JOINTS = [j for _, g in JOINT_GROUPS for j in g]


def load_annot(fname):
    """Parse TS*/annot.mat (ref mupots_3dhp.py:353-374)."""
    import scipy.io as sio
    data = sio.loadmat(fname)['annotations']
    num_frames, num_inst = data.shape
    results = []
    for j in range(num_inst):
        buff = []
        for i in range(num_frames):
            dt = data[i, j]
            buff.append(dict(
                annot2=dt['annot2'][0, 0],
                annot3=dt['annot3'][0, 0],
                annot3_univ=dt['univ_annot3'][0, 0],
                is_valid=dt['isValidFrame'][0, 0][0, 0]))
        results.append(buff)
    return results


def load_occ(fname):
    import scipy.io as sio
    data = sio.loadmat(fname)['occlusion_labels']
    num_frames, num_inst = data.shape
    return [[data[i][j] for j in range(num_inst)]
            for i in range(num_frames)]


def norm_by_bone_length(pred, gt, o1, trav):
    """Rescale each pred bone to the GT length (ref :480-489).
    Poses are (3, J).

    NOTE the reference pairs ``trav[i]`` with ``o1[i]`` by *loop position*
    (``o1`` is the full 17-entry parent table while ``trav`` is the
    16-entry ``safe_traversal_order[1:]``), NOT ``o1[trav[i]]``.  The
    resulting parent pairs are not the anatomical skeleton, but they are
    what defines the published 3DPCK metric, so we reproduce them exactly
    (ref mupots_3dhp.py:480-489, call sites :549,:643,:651).
    """
    out = pred.copy()
    for i in range(len(trav)):
        idx = trav[i]
        gt_len = np.linalg.norm(gt[:, idx] - gt[:, o1[i]])
        vec = pred[:, idx] - pred[:, o1[i]]
        plen = np.linalg.norm(vec)
        out[:, idx] = out[:, o1[i]] + vec * gt_len / plen
    return out


def procrustes(predicted, target):
    """Rigid + scale alignment of (3, J) predicted onto target
    (ref :492-528)."""
    predicted = predicted.T[None]
    target = target.T[None]
    mu_x = target.mean(axis=1, keepdims=True)
    mu_y = predicted.mean(axis=1, keepdims=True)
    x0 = target - mu_x
    y0 = predicted - mu_y
    norm_x = np.sqrt((x0 ** 2).sum(axis=(1, 2), keepdims=True))
    norm_y = np.sqrt((y0 ** 2).sum(axis=(1, 2), keepdims=True))
    x0 /= norm_x
    y0 /= norm_y
    h = x0.transpose(0, 2, 1) @ y0
    u, s, vt = np.linalg.svd(h)
    v = vt.transpose(0, 2, 1)
    r = v @ u.transpose(0, 2, 1)
    sign = np.sign(np.expand_dims(np.linalg.det(r), axis=1))
    v[:, :, -1] *= sign
    s[:, -1] *= sign.flatten()
    r = v @ u.transpose(0, 2, 1)
    tr = np.expand_dims(s.sum(axis=1, keepdims=True), axis=2)
    a = tr * norm_x / norm_y
    t = mu_x - a * (mu_y @ r)
    return (a * (predicted @ r) + t)[0].T


def match_poses(gt_poses, pred_poses, threshold=250):
    """Greedy GT->pred matching (ref :531-566). Poses are (3, J)."""
    matches, matches_abs = [], []
    p2 = np.float32(pred_poses)
    p2_root = p2[:, :, 14:15]
    p2 = p2 - p2_root
    for gt in gt_poses:
        p1 = np.float32(gt)
        p1_root = p1[:, 14:15]
        p1 = p1 - p1_root
        diffs, diffs_abs = [], []
        for j in range(len(p2)):
            p = p2[j].copy()
            depth_ratio = p1_root[[2]] / p2_root[j, [2]]
            p[:2] *= depth_ratio
            p = norm_by_bone_length(p, p1, PARENTS_O1, SAFE_TRAVERSAL[1:])
            diffs.append(np.sqrt(((p - p1) ** 2).sum(axis=0)).mean())
            diffs_abs.append(np.sqrt(
                ((p + p2_root[j] - p1 - p1_root) ** 2).sum(axis=0)).mean())
        diffs = np.float32(diffs)
        diffs_abs = np.float32(diffs_abs)
        matches.append(-1 if diffs.min() > threshold
                       else int(diffs.argmin()))
        matches_abs.append(-1 if diffs_abs.min() > threshold
                           else int(diffs_abs.argmin()))
    return matches, matches_abs


def eval_sequence(args):
    """Evaluate one TS sequence; returns per-joint error lists
    (ref eval_mupots_abs :569-682).

    Returns ``(ts, pje, pje_abs, pje_align, occ)`` where ``pje``/``pje_abs``
    are the root-relative / absolute per-joint errors the headline metric
    uses, ``pje_align`` are the procrustes-aligned errors (collected by the
    reference as ``pje_correct`` :661 but never surfaced), and ``occ`` the
    per-pose occlusion labels from ``TS*/occlusion.mat`` (ref :585,:617)
    or ``None`` when the file is absent.
    """
    ts, annot_base, name2pred, eval_mode = args
    annots = load_annot(os.path.join(annot_base, f'TS{ts + 1}/annot.mat'))
    occ_path = os.path.join(annot_base, f'TS{ts + 1}/occlusion.mat')
    occlusions = load_occ(occ_path) if os.path.exists(occ_path) else None
    num_frames = len(annots[0])
    num_person = len(annots)
    pje, pje_abs, pje_align, occ_out = [], [], [], []
    for i in range(num_frames):
        valid = [k for k in range(num_person)
                 if annots[k][i]['is_valid'] == 1]
        if not valid:
            continue
        gt_p3d = [annots[k][i]['annot3'] for k in valid]
        gt_occ = ([np.asarray(occlusions[i][k]).reshape(-1)
                   for k in valid] if occlusions is not None else None)
        filename = f'TS{ts + 1}/img_{i:06d}.jpg'
        pred = name2pred.get(filename, np.zeros((1, 17, 3)))
        pred = np.asarray(pred).transpose(0, 2, 1)       # (P, 3, 17)
        invalid = pred[:, 2, 14] == 0
        if invalid.sum() > 0:
            pred = pred[~invalid]
        if len(pred) == 0:
            pred = np.zeros((1, 3, 17))
        matches, _ = match_poses(gt_p3d, pred)
        for k, m in enumerate(matches):
            gt_abs = gt_p3d[k]
            gt_rel = gt_abs - gt_abs[:, 14:15]
            if m != -1:
                p_abs = pred[m]
                p_root = p_abs[:, 14:15]
                p_rel = p_abs - p_root
                depth_ratio = gt_abs[[2], [14]] / p_abs[[2], [14]]
                p_rel[:2] = p_rel[:2] * depth_ratio
                p_aligned = procrustes(p_rel, gt_rel)
                p_rel = norm_by_bone_length(p_rel, gt_rel, PARENTS_O1,
                                            SAFE_TRAVERSAL[1:])
                # absolute: same normalised pose re-rooted at pred root
                p_for_abs = pred[m] - pred[m][:, 14:15]
                p_for_abs[:2] = p_for_abs[:2] * depth_ratio
                p_for_abs = norm_by_bone_length(
                    p_for_abs, gt_rel, PARENTS_O1, SAFE_TRAVERSAL[1:])
                p_abs_final = p_for_abs + pred[m][:, 14:15]
                considered = True
            else:
                p_rel = p_abs_final = p_aligned = \
                    100000 * np.ones(gt_rel.shape)
                considered = eval_mode == 'all'
            if considered:
                pje.append(np.sqrt(((p_rel - gt_rel) ** 2).sum(axis=0)))
                pje_abs.append(np.sqrt(
                    ((p_abs_final - gt_abs) ** 2).sum(axis=0)))
                pje_align.append(np.sqrt(
                    ((p_aligned - gt_rel) ** 2).sum(axis=0)))
                if gt_occ is not None:
                    occ_out.append(gt_occ[k])
    return ts, pje, pje_abs, pje_align, (occ_out if occlusions is not None
                                         else None)


# thresholds of the reference PCK curve (ref mpii_compute_3d_pck :440-441)
PCK_THRESHOLDS = np.arange(0, 200, 5)
PCK_THRESH = 150


def mpii_compute_3d_pck(seq_err):
    """Per-sequence PCK curves / group PCK / AUC
    (direct semantics of ref mpii_compute_3d_pck :436-473).

    ``seq_err``: list (per sequence) of per-pose (17,) error arrays.
    Returns ``(pck_curve_array, pck_array, auc_array)``:

    * ``pck_curve_array[s][g][t]`` — PCK at threshold ``t`` for joint group
      ``g`` (the last "group" is the all-joints total) in sequence ``s``,
    * ``pck_array[s]`` — per-group PCK@150 + total as the last entry,
    * ``auc_array[s][g]`` — mean of the per-group curve (groups only).

    Empty sequences (no evaluated poses) yield zeros — the reference
    crashes on that input, so any non-degenerate run is unaffected.
    """
    pck_curve_array, pck_array, auc_array = [], [], []
    n_thresh = len(PCK_THRESHOLDS)
    for errs in seq_err:
        if len(errs) == 0:
            pck_curve_array.append(
                [[0.0] * n_thresh] * (len(JOINT_GROUPS) + 1))
            pck_array.append([0.0] * (len(JOINT_GROUPS) + 1))
            auc_array.append([0.0] * len(JOINT_GROUPS))
            continue
        err = np.asarray(errs, np.float32)
        pck_curve, pck_seq, auc_seq = [], [], []
        for _, joints in JOINT_GROUPS:
            sel = err[:, joints]
            buff = [float(np.float32(sel < t).sum() / len(joints) / len(err))
                    for t in PCK_THRESHOLDS]
            pck_curve.append(buff)
            auc_seq.append(float(np.mean(buff)))
            pck_seq.append(float(
                np.float32(sel < PCK_THRESH).sum() / len(joints) / len(err)))
        sel = err[:, ALL_GROUP_JOINTS]
        pck_curve.append(
            [float(np.float32(sel < t).sum() / len(err)
                   / len(ALL_GROUP_JOINTS)) for t in PCK_THRESHOLDS])
        pck_seq.append(float(np.float32(sel < PCK_THRESH).sum() / len(err)
                             / len(ALL_GROUP_JOINTS)))
        pck_curve_array.append(pck_curve)
        pck_array.append(pck_seq)
        auc_array.append(auc_seq)
    return pck_curve_array, pck_array, auc_array


def compute_pck(seq_errors, pck_thresh=150.0):
    """Per-sequence total 3DPCK (last entry of each ``pck_array`` row,
    ref :345-346 ``pck_mean = sum(i[-1] for i in pck_array)/len(pck_array)``).
    Averages over ALL sequences, including empty ones (as 0.0)."""
    assert pck_thresh == PCK_THRESH
    _, pck_array, _ = mpii_compute_3d_pck(seq_errors)
    return [row[-1] for row in pck_array]


@DATASETS.register_module()
class MuPots3DHP(BasePoseDataset):
    CLASSES = ('person',)
    joint_num = 21
    original_joint_num = 17
    ROOT_IDX = 14

    def __init__(self, data_root=None, use_bbox_center=False,
                 norm_depth=False, abs_dz=False, depth_factor=1,
                 num_workers: int = 8, eval_seq=None, **kwargs):
        kwargs.setdefault('test_mode', True)
        super().__init__(data_root=data_root, **kwargs)
        self.num_joints = self.original_joint_num
        self.use_bbox_center = use_bbox_center
        self.norm_depth = norm_depth
        self.depth_factor = depth_factor
        # abs_dz targets are defined relative to the normalized root
        # depth; without norm_depth the flag silently changes nothing
        # in _parse_ann_info/evaluate — fail loudly instead
        # (ref mupots_3dhp.py abs_dz path assumes norm_depth)
        assert not abs_dz or norm_depth, \
            'abs_dz=True requires norm_depth=True'
        self.abs_dz = abs_dz
        self.num_workers = num_workers
        # Single-sequence restriction (0-based: eval_seq=0 -> TS1). The
        # reference gestures at this via ``self.eval_seq`` in _filter_imgs
        # (ref mupots_3dhp.py:182-193) but never defines the attribute —
        # the surface is dead there; here it works.
        self.eval_seq = eval_seq
        if eval_seq is not None:
            tag = f'TS{int(eval_seq) + 1}/'
            keep = [i for i, info in enumerate(self.data_infos)
                    if tag in info['file_name']]
            self.img_ids = [self.img_ids[i] for i in keep]
            self.data_infos = [self.data_infos[i] for i in keep]
        # name2id keyed by relative path (TS#/img_xxx.jpg)
        self.name2id = {info['file_name']: info['id']
                        for info in self.data_infos}

    def prepare_train_img(self, idx):
        raise NotImplementedError('MuPoTS is test-only')

    def _parse_ann_info(self, img_info, ann_info):
        intrinsic = img_info['intrinsic']
        f, c = intrinsic[:2], intrinsic[2:]
        cam = dict(
            K=np.array([[f[0], 0., c[0]], [0., f[1], c[1]]]),
            R=np.eye(3), t=np.zeros((3, 1)))
        J = self.joint_num
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
            pose_vis = np.array(ann['keypoints_vis'], np.float64)
            if pose_vis.ndim == 2:
                pose_vis0 = pose_vis[:, 0]
            else:
                pose_vis0 = pose_vis
            if self.norm_depth:
                pose_3d[:, 2] /= self.depth_factor
                if self.abs_dz:
                    dz = pose_3d[:, 2] - pose_3d[[self.ROOT_IDX], 2]
                pose_3d[:, 2] /= np.sqrt(f[0] * f[1])
            if pose_3d.max() - pose_3d.min() < 10:
                continue
            if not self.use_bbox_center:
                if pose_vis0[self.ROOT_IDX] == 0:
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
                pose_vis0.reshape(-1)]))
            centers2d.append(c2d[:2])
            depths.append(c2d[2])

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

    # ------------------------------------------------------- evaluation
    def _result_image_id(self, image_path):
        # name2id is keyed by data_root-relative path (TS#/img_xxx.jpg),
        # mirroring ref mupots_3dhp.py:209-215
        data_root = self.data_root if self.data_root.endswith('/') \
            else self.data_root + '/'
        return self.name2id[image_path.replace(data_root, '')]

    def evaluate(self, outputs: List[Dict], metric='pck', eval_mode='all',
                 res_folder=None, **kwargs):
        metrics = metric if isinstance(metric, list) else [metric]
        assert all(m.lower() == 'pck' for m in metrics)
        J = self.num_joints
        if res_folder is not None:
            self.format_results(outputs, res_folder=res_folder)
        data_root = self.data_root if self.data_root.endswith('/') \
            else self.data_root + '/'

        # back-project predictions to camera space per image
        preds_by_image = defaultdict(list)
        for out in outputs:
            rel = out['image_paths'][0].replace(data_root, '')
            for kpt in np.asarray(out['poses'])[:, :J]:
                preds_by_image[rel].append(kpt[:, :3])

        name2pred = {}
        for info in self.data_infos:
            rel = info['file_name']
            img_id = info['id']
            ann = self._parse_ann_info(
                info, self.coco.load_anns(self.coco.get_ann_ids([img_id])))
            cam = ann['cam']
            norm_depth = np.sqrt(cam['K'][0, 0] * cam['K'][1, 1])
            preds = preds_by_image.get(rel, [])
            if len(preds) == 0:
                name2pred[rel] = np.zeros([1, J, 3])
                continue
            pred_img = np.asarray(preds, np.float64)[:, :J]
            if self.norm_depth:
                if self.abs_dz:
                    root_depth = pred_img[:, [self.ROOT_IDX], 2]
                    dz = pred_img[..., 2] - root_depth
                    pred_img[..., 2] = root_depth * norm_depth + dz
                    pred_img[..., 2] *= self.depth_factor
                else:
                    pred_img[..., 2] *= norm_depth * self.depth_factor
            name2pred[rel] = pixel2world(
                pred_img.reshape(-1, 3).T, cam['K'], cam['R'],
                cam['t']).T.reshape(pred_img.shape)

        eval_seqs = list(range(20)) if self.eval_seq is None \
            else [int(self.eval_seq)]
        tasks = [(ts, self.data_root, name2pred, eval_mode)
                 for ts in eval_seqs]
        if self.num_workers > 1:
            with ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context('spawn')) as ex:
                results = list(ex.map(eval_sequence, tasks))
        else:
            results = [eval_sequence(t) for t in tasks]
        results.sort(key=lambda r: r[0])

        seq_err = [r[1] for r in results]
        seq_err_abs = [r[2] for r in results]
        _, pck_array, auc_array = mpii_compute_3d_pck(seq_err)
        _, pck_array_abs, _ = mpii_compute_3d_pck(seq_err_abs)
        # headline means over ALL 20 sequences (ref :345-346)
        pck_mean = float(np.mean([row[-1] for row in pck_array]))
        pck_mean_abs = float(np.mean([row[-1] for row in pck_array_abs]))

        out = OrderedDict([
            ('PCK_MEAN:', f'{pck_mean * 100:.2f}'),
            ('PCK_MEAN_ABS:', f'{pck_mean_abs * 100:.2f}'),
            ('pck_mean', pck_mean), ('pck_mean_abs', pck_mean_abs)])

        # extended surface: per-sequence table, per-group breakdown, AUC
        # (collected by the reference's mpii_compute_3d_pck :436-473 but
        # only the two means are printed; we surface all of it).
        group_hdr = '  '.join(f'{name:>8s}' for name, _ in JOINT_GROUPS)
        print(f'{"Seq":>5s}  {group_hdr}  {"All":>8s}  {"All_abs":>8s}'
              f'  {"AUC":>6s}')
        for s, row, row_abs, auc_row in zip(eval_seqs, pck_array,
                                            pck_array_abs, auc_array):
            groups = '  '.join(f'{100 * v:8.2f}' for v in row[:-1])
            print(f'TS{s + 1:<3d}  {groups}  {100 * row[-1]:8.2f}'
                  f'  {100 * row_abs[-1]:8.2f}'
                  f'  {100 * float(np.mean(auc_row)):6.2f}')
        print(f'{"mean":>5s}  {"":{len(group_hdr)}s}  {100 * pck_mean:8.2f}'
              f'  {100 * pck_mean_abs:8.2f}')
        for s, row in zip(eval_seqs, pck_array):
            out[f'pck_TS{s + 1}'] = float(row[-1])
        group_names = [name for name, _ in JOINT_GROUPS]
        per_group = np.asarray(pck_array, np.float64)[:, :-1].mean(axis=0)
        for name, val in zip(group_names, per_group):
            out[f'pck_{name}'] = float(val)
        out['auc_mean'] = float(np.mean(
            [np.mean(row) for row in auc_array]))

        # occlusion split: PCK@150 over occluded vs visible joints, using
        # TS*/occlusion.mat labels (loaded by ref :585, never surfaced).
        occ_avail = all(r[4] is not None for r in results)
        if occ_avail:
            n_occ = n_occ_ok = n_vis = n_vis_ok = 0
            for r in results:
                for err, occ in zip(r[1], r[4]):
                    occ = np.asarray(occ).reshape(-1).astype(bool)
                    j = min(len(occ), len(err))
                    sel = [g for g in ALL_GROUP_JOINTS if g < j]
                    o, e = occ[sel], np.asarray(err)[sel]
                    n_occ += int(o.sum())
                    n_occ_ok += int((e[o] < PCK_THRESH).sum())
                    n_vis += int((~o).sum())
                    n_vis_ok += int((e[~o] < PCK_THRESH).sum())
            if n_occ:
                out['pck_occluded'] = n_occ_ok / n_occ
            if n_vis:
                out['pck_visible'] = n_vis_ok / n_vis
        return out
