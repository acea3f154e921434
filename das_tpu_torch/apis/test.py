"""Evaluation loop, port of ``das_tpu/apis/test.py`` (ref: tools/test.py +
mmdet3d/apis/test.py:11-40).

Batches test samples by padded resolution, runs backbone -> FPN -> head ->
fused decode on the model's device, and converts the fixed-shape results
to the reference's per-image output dicts for ``dataset.evaluate``. Two
sweeps: ``_sweep`` takes the dataset's host pipeline (``cv2`` resize,
normalise, pad); ``_device_pre_sweep`` only decodes the images on the host
and resizes, normalises, pads (and mirrors, for the flip test) on the
device.

One process on the model's device. A sweep sharded over several processes
(the JAX package's multi-host path) is not ported.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.decode import decode_batch
from .inference import make_predict_fn, results_to_host


def _sample_views(sample: Dict) -> List[Dict]:
    """Split a MultiScaleFlipAug sample (dict of per-view lists) into one
    dict per augmented view (direct first, flipped second).

    View-ness is keyed off ``img`` being a list — other values may be
    plain lists (e.g. a 4-float scale_factor) without implying views."""
    if not isinstance(sample.get('img'), list):
        return [sample]
    n_views = len(sample['img'])
    views = []
    for i in range(n_views):
        views.append({
            k: (v[i] if isinstance(v, list) and len(v) == n_views else v)
            for k, v in sample.items()})
    return views


def _unflip_result(res: Dict, ori_w: int, flip_pairs) -> Dict:
    """Mirror a decoded result back to direct-view coordinates:
    x -> (W - 1 - x) in original-image pixels, swap left/right joints."""
    poses = np.array(res['poses'], np.float32, copy=True)
    centers = np.array(res['centers'], np.float32, copy=True)
    poses[..., 0] = ori_w - 1 - poses[..., 0]
    centers[..., 0] = ori_w - 1 - centers[..., 0]
    for a, b in (flip_pairs or []):
        poses[:, [a, b]] = poses[:, [b, a]]
    out = dict(res)
    out['poses'], out['centers'] = poses, centers
    return out


def merge_flip_results(direct: Dict, flipped: Dict,
                       match_frac: float = 0.5) -> Dict:
    """Average a direct-view result with an (already unflipped) flipped
    view. People are greedily matched by root xy distance; a pair matches
    when the distance is below ``match_frac`` x the direct person's pose
    extent. Unmatched direct people are kept as-is (the direct view is
    authoritative for detection; flip only refines coordinates)."""
    dp = np.asarray(direct['poses'], np.float32)
    fp = np.asarray(flipped['poses'], np.float32)
    if len(dp) == 0 or len(fp) == 0:
        return direct
    out_poses = dp.copy()
    out_centers = np.asarray(direct['centers'], np.float32).copy()
    fc = np.asarray(flipped['centers'], np.float32)
    used = np.zeros(len(fp), bool)
    for i in range(len(dp)):
        extent = max(np.ptp(dp[i, :, 0]), np.ptp(dp[i, :, 1]), 1.0)
        d = np.linalg.norm(fc[:, :2] - out_centers[i, None, :2], axis=-1)
        d = np.where(used, np.inf, d)
        j = int(np.argmin(d))
        if d[j] < match_frac * extent:
            used[j] = True
            out_poses[i] = 0.5 * (dp[i] + fp[j])
            out_centers[i] = 0.5 * (out_centers[i] + fc[j])
    out = dict(direct)
    out['poses'], out['centers'] = out_poses, out_centers
    return out


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _sweep(model, get_sample, n: int, cfg, batch_size: int,
           progress: bool) -> List[Dict]:
    """Sweep over samples ``get_sample(0..n-1)`` of the host pipeline.

    Each dataset item may carry 1 view (direct) or 2 (direct + flipped,
    ``MultiScaleFlipAug(flip=True)``); all views are batched by padded
    shape and flip-averaged after decode."""
    head_cfg = cfg.model.bbox_head
    predict = make_predict_fn(model, dict(cfg.model.test_cfg),
                              int(head_cfg.num_joints),
                              tuple(head_cfg.strides),
                              device=_model_device(model))

    buckets = defaultdict(list)
    views = []                  # flat list of view dicts
    view_of = []                # per dataset idx: list of flat positions
    for idx in range(n):
        vs = _sample_views(get_sample(idx))
        view_of.append([])
        for v in vs:
            view_of[idx].append(len(views))
            buckets[v['img'].shape].append(len(views))
            views.append(v)

    decoded_all: List[Any] = [None] * len(views)
    done = 0
    for shape, idxs in buckets.items():
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            # pad the last batch to full size: every batch of a shape has
            # the shape of the first
            batch_idx = chunk + [chunk[-1]] * (batch_size - len(chunk))
            imgs = torch.from_numpy(np.stack(
                [views[i]['img'] for i in batch_idx]))
            sfs = torch.from_numpy(np.stack([np.asarray(
                views[i]['img_metas']['scale_factor'][:2], np.float32)
                for i in batch_idx]))
            decoded = predict(imgs, sfs)
            paths = [views[i]['img_metas']['filename']
                     for i in batch_idx]
            outs = results_to_host(decoded, paths)
            for j, i in enumerate(chunk):
                decoded_all[i] = outs[j]
            done += len(chunk)
            if progress:
                print(f'\r[das_tpu_torch] test {done}/{len(views)}',
                      end='', flush=True)
    if progress:
        print()

    results: List[Any] = [None] * n
    for idx in range(n):
        pos = view_of[idx]
        direct = decoded_all[pos[0]]
        if len(pos) == 1:
            results[idx] = direct
            continue
        meta = views[pos[1]]['img_metas']
        ori_w = int(meta['ori_shape'][1])
        flipped = _unflip_result(decoded_all[pos[1]], ori_w,
                                 meta.get('flip_pairs'))
        results[idx] = merge_flip_results(direct, flipped)
    return results


def _device_pre_sweep(model, dataset, cfg, batch_size: int,
                      progress: bool) -> List[Dict]:
    """Device-preprocessing sweep: the host only decodes the images
    (``utils/image.imread``); the uint8 batch goes to the model's device as
    uint8, where keep-ratio resize, BGR->RGB, normalize, pad (and the
    flip-test mirror) run before the model.

    Equivalent to the host pipeline path up to bilinear-resize rounding:
    the host path resizes the uint8 image with ``cv2.resize`` in fixed
    point, this one in f32 (``ops/preprocess.resize_bilinear``)."""
    from ..datasets.pipelines import _rescale_size
    from ..ops.preprocess import make_preprocess_fn
    from ..utils.image import imread

    head_cfg = cfg.model.bbox_head
    strides = tuple(head_cfg.strides)
    J = int(head_cfg.num_joints)
    test_cfg = dict(cfg.model.test_cfg)
    dev = _model_device(model)

    pipe = cfg.data['test']['pipeline']
    msfa = next(t for t in pipe if t.get('type') == 'MultiScaleFlipAug')
    scale = tuple(msfa['img_scale'])
    do_flip = bool(msfa.get('flip', False))
    flip_pairs = [list(p) for p in (msfa.get('flip_pairs') or [])]
    norm_t = next((t for t in msfa['transforms']
                   if t.get('type') == 'Normalize'), None)
    norm = (dict(mean=tuple(norm_t['mean']), std=tuple(norm_t['std']),
                 to_rgb=norm_t.get('to_rgb', False))
            if norm_t else dict(mean=(0., 0., 0.), std=(1., 1., 1.),
                                to_rgb=False))

    prefix = getattr(dataset, 'img_prefix', '') or ''
    infos = dataset.data_infos
    n = len(infos)
    buckets = defaultdict(list)
    for i in range(n):
        info = infos[i]
        buckets[(int(info['height']), int(info['width']))].append(i)

    @torch.inference_mode()
    def run(pre, raw, sf, flip):
        x = raw.flip(2) if flip else raw
        cls, pose, ctr, _ = model(pre(x))
        return decode_batch(cls, pose, ctr, strides, sf, J, test_cfg)

    results: Dict[int, Any] = {}
    done = 0
    for (h, w), idxs in buckets.items():
        new_h, new_w = _rescale_size(h, w, scale)
        pad_h, pad_w = -(-new_h // 32) * 32, -(-new_w // 32) * 32
        pre = make_preprocess_fn((h, w), (new_h, new_w), (pad_h, pad_w),
                                 **norm)
        sf_row = np.asarray([new_w / w, new_h / h], np.float32)

        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            batch_idx = chunk + [chunk[-1]] * (batch_size - len(chunk))
            paths = [os.path.join(prefix, infos[i]['file_name'])
                     if prefix else infos[i]['file_name']
                     for i in batch_idx]
            raw = torch.from_numpy(np.stack([imread(p) for p in paths])) \
                .to(dev)
            sf = torch.from_numpy(np.tile(sf_row, (len(batch_idx), 1))) \
                .to(dev)
            outs = results_to_host(run(pre, raw, sf, False), paths)
            if do_flip:
                outs_f = results_to_host(run(pre, raw, sf, True), paths)
                outs = [merge_flip_results(
                    d, _unflip_result(f_, w, flip_pairs))
                    for d, f_ in zip(outs, outs_f)]
            for j, i in enumerate(chunk):
                results[i] = outs[j]
            done += len(chunk)
            if progress:
                print(f'\r[das_tpu_torch] test {done}/{n}', end='',
                      flush=True)
    if progress:
        print()
    return [results[i] for i in range(n)]


def run_test(model, dataset, cfg, batch_size: int = 4,
             progress: bool = True,
             device_preprocess: bool = None) -> List[Dict]:
    """Test sweep on the model's device; returns reference-style output
    dicts in dataset order.

    ``device_preprocess`` (default: ``cfg.data.test.device_preprocess``)
    moves resize/normalize/pad/flip onto the device — the host only
    decodes the images. Raises under ``torch.distributed`` with more than
    one process: each would evaluate the whole dataset."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            'run_test evaluates in one process; a sweep sharded over '
            f'{torch.distributed.get_world_size()} processes is not ported '
            '(ROADMAP.md, Queue 1, item 8)')
    if device_preprocess is None:
        device_preprocess = bool(
            cfg.data['test'].get('device_preprocess', False))
    if device_preprocess:
        return _device_pre_sweep(model, dataset, cfg, batch_size, progress)
    return _sweep(model, lambda i: dataset[i], len(dataset), cfg,
                  batch_size, progress)
