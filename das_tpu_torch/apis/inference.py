"""Serving APIs, port of ``das_tpu/apis/inference.py``.

``init_model`` builds the model from a config on the card (or on the device
the caller names) and optionally loads a ``.pth``; ``make_predict_fn``
returns the end-to-end call: backbone -> FPN -> head -> fused decode, on
the model's device, ending in fixed-shape tensors; ``inference_detector``
runs one image file or array through it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.decode import decode_batch
from ..models import DAS, build_model
from ..models.layers import DeformConv2d
from ..ops.deform_conv import deform_offset_overflow
from ..utils.device import resolve_device


def init_model(config, checkpoint: Optional[str] = None,
               dtype: torch.dtype = torch.float32, device=None,
               seed: int = 0, validate_dcn: bool = True,
               strict: bool = True):
    """Build the model (eval, on ``device``: the card unless the caller
    names another) and optionally load a ``.pth`` checkpoint.

    The checkpoint loads with ``strict`` (``load_checkpoint_report``); the
    count of model keys it lacks, which keep their init values, is printed
    as the JAX package prints it. When the config selects a shift/hybrid DCN
    mode, ``validate_dcn`` is set and weights were loaded, the learned
    conv_offset fields are bounds-checked once (``validate_dcn_offsets``);
    if they exceed the configured radius or budget, every DCN layer
    switches to the exact ``'patch'`` gather and a warning is printed, so a
    loaded checkpoint never silently serves approximate DCNv2. Returns
    ``(model, config)``.
    """
    if isinstance(config, str):
        config = Config.fromfile(config)
    dev = resolve_device(device)
    model = build_model(dict(config.model), dtype=dtype, device=dev,
                        seed=seed)
    if checkpoint is not None:
        from ..checkpoint.convert import load_checkpoint_report
        report = load_checkpoint_report(model, checkpoint, strict=strict)
        if report['missing']:
            print(f'[das_tpu_torch] checkpoint missing '
                  f'{len(report["missing"])} keys (kept init values)')
        head = dict(config.model['bbox_head'])
        mode = head.get('dcn_gather_mode', 'patch')
        if validate_dcn and mode in ('shift', 'shift_pallas', 'hybrid',
                                     'hybrid_pallas'):
            radius = int(head.get('dcn_shift_radius', 2))
            budget = int(head.get('dcn_shift_budget', 2048))
            shift_ok, hybrid_ok, worst = validate_dcn_offsets(
                model, radius, budget)
            ok = shift_ok if mode.startswith('shift') else hybrid_ok
            if not ok:
                print(f"[das_tpu_torch] WARNING: checkpoint offsets exceed "
                      f"the '{mode}' mode's exactness bound "
                      f"(radius={radius}, budget={budget}; worst layer: "
                      f"max|off|={worst[0]:.2f}, flagged/img={worst[1]}) "
                      f"— falling back to exact 'patch' gathers")
                mc = dict(config.model)
                mc['bbox_head'] = dict(head, dcn_gather_mode='patch')
                config.model = mc
                for m in model.modules():
                    if isinstance(m, DeformConv2d):
                        m.gather_mode = 'patch'
    return model, config


@torch.no_grad()
def dcn_offset_table(model: DAS, img: torch.Tensor, radius: int
                     ) -> List[Tuple[str, float, int]]:
    """Forward ``img`` (N, H, W, 3) and bound every DCN call's offsets: one
    row ``(name, max |offset|, flagged pixels)`` per call of each DCN layer
    (one a pyramid level), where ``flagged`` is the largest count over the
    images of pixels with a tap beyond ``radius``. Rows are ordered by the
    layer's module name and then by call, ``<module>/[<call>]``, the order
    in which the JAX package lists the ``dcn_offset`` intermediates."""
    offsets = {}
    hooks = [m.conv_offset.register_forward_hook(
        lambda mod, inp, out, name=name: offsets.setdefault(name, []).append(
            out[:, :out.shape[1] * 2 // 3].permute(0, 2, 3, 1).float()))
        for name, m in model.named_modules() if isinstance(m, DeformConv2d)]
    try:
        model(img.to(next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for name in sorted(offsets):
        for i, off in enumerate(offsets[name]):
            rows.append((f'{name}/[{i}]', float(off.abs().max()), int(
                deform_offset_overflow(off, radius, budget=0).max())))
    return rows


def validate_dcn_offsets(model: DAS, radius: int, budget: int,
                         hw: Tuple[int, int] = (256, 320),
                         batch: int = 2, seed: int = 0):
    """Bound every DCN layer's learned offsets on random-normal inputs.

    Returns (shift_ok, hybrid_ok, (worst max|off|, worst flagged/img)).
    Random inputs exercise the trained conv_offset weights but are a
    heuristic certificate; the runtime repair in the hybrid modes stays the
    exactness backstop for any image within budget.
    """
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(batch, *hw, 3).astype(np.float32))
    rows = dcn_offset_table(model, img, radius)
    worst_off = max((r[1] for r in rows), default=0.0)
    worst_flagged = max((r[2] for r in rows), default=0)
    return (worst_off <= radius, worst_flagged <= budget,
            (worst_off, worst_flagged))


def make_predict_fn(model: DAS, test_cfg: Dict, num_joints: int, strides,
                    device=None):
    """End-to-end predict: images (N,H,W,3) + scale_factors (N,2) ->
    decoded dict of fixed-shape tensors on the model's device.

    ``device`` is where the model runs: the card unless the caller names
    another; a model that lies elsewhere is an error.
    """
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if dev.type != model_dev.type or dev.index not in (None,
                                                       model_dev.index):
        raise ValueError(f'the model is on {model_dev}, not on {dev}')
    test_cfg = dict(test_cfg)
    strides = tuple(strides)

    @torch.inference_mode()
    def predict(img, scale_factors):
        img = torch.as_tensor(img, dtype=torch.float32).to(model_dev)
        sf = torch.as_tensor(scale_factors, dtype=torch.float32) \
            .to(model_dev)
        cls_scores, pose_preds, centernesses, _ = model(img)
        return decode_batch(cls_scores, pose_preds, centernesses, strides,
                            sf, num_joints, test_cfg)

    return predict


def inference_detector(model: DAS, cfg, image, predict_fn=None) -> Dict:
    """Single-image inference (ref: apis/inference.py:195
    ``inference_mono_3d_detector``): one image path (decoded by
    ``utils/image.imread``) or uint8 BGR (H, W, 3) array in, the decoded
    people dict out.

    The image is resized, normalised and padded on the model's device
    (``ops/preprocess.make_preprocess_fn``: the keep-ratio bilinear resize
    in f32 to fit (1333, 640), BGR->RGB, ImageNet mean/std, padding to a
    multiple of 32) — the device-preprocess semantics of ``run_test``,
    where the JAX function resizes the uint8 image with ``cv2.resize`` on
    the host; the two agree up to bilinear-resize rounding.
    """
    from ..datasets.pipelines import _rescale_size
    from ..ops.preprocess import make_preprocess_fn
    from ..utils.image import imread

    if isinstance(image, str):
        img = imread(image)
        path = image
    else:
        img = np.asarray(image)
        path = '<array>'
    h, w = img.shape[:2]
    nh, nw = _rescale_size(h, w, (1333, 640))
    ph, pw = (nh + 31) // 32 * 32, (nw + 31) // 32 * 32
    dev = next(model.parameters()).device
    pre = make_preprocess_fn((h, w), (nh, nw), (ph, pw))
    head = cfg.model.bbox_head
    if predict_fn is None:
        predict_fn = make_predict_fn(model, dict(cfg.model.test_cfg),
                                     int(head.num_joints),
                                     tuple(head.strides), device=dev)
    with torch.inference_mode():
        x = pre(torch.from_numpy(np.ascontiguousarray(img))[None].to(dev))
        sf = torch.tensor([[nw / w, nh / h]], dtype=torch.float32,
                          device=dev)
        decoded = predict_fn(x, sf)
    return results_to_host(decoded, [path])[0]


def results_to_host(decoded, image_paths: List[str]) -> List[Dict]:
    """Fixed-shape device output -> the reference's per-image result dicts
    (ref das_head.py:680-687)."""
    scores = decoded['scores'].cpu().numpy()
    poses = decoded['poses'].cpu().numpy()
    centers = decoded['centers'].cpu().numpy()
    vis = decoded['vis'].cpu().numpy()
    valid = decoded['valid'].cpu().numpy()
    out = []
    for i, path in enumerate(image_paths):
        m = valid[i]
        out.append(dict(
            poses=poses[i][m],
            vis=vis[i][m],
            centers=centers[i][m],
            image_paths=[path],
            scores=scores[i][m].tolist()))
    return out
