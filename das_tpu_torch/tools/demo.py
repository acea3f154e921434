"""Single-image inference demo, the port's ``tools/demo.py`` (ref: demo/
scripts + apis/inference.py:195).

Usage:
    python -m das_tpu_torch.tools.demo configs/das/exp_panoptic.py \
        [CKPT.pth] image.jpg [--out vis.jpg] [--score-thr 0.3] \
        [--device cuda] [--dtype bfloat16]

Prints decoded people as JSON; optionally draws the 2D skeleton. Step for
step the JAX tool's: the model in bf16 (``--dtype float32`` to check it
against another device), the keep-ratio ``cv2.resize`` of the uint8 frame
to the (1333, 640) scale, BGR->RGB, ImageNet mean/std, zero padding to a
multiple of 32, ``make_predict_fn`` and ``results_to_host``, the score
filter, and the same cv2 drawing calls. The model runs on ``--device`` (the
card by default; ``cpu`` to run there).
"""

import argparse
import json

import numpy as np

SKELETON = [[0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [0, 9], [9, 10],
            [10, 11], [2, 6], [2, 12], [6, 7], [7, 8], [12, 13], [13, 14]]
SCALE = (1333, 640)
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess(img: np.ndarray):
    """The test pipeline on a uint8 BGR frame: keep-ratio resize to SCALE,
    normalize, pad. Returns (padded (PH, PW, 3) float32, scale factors
    (1, 2) float32 [w, h])."""
    import cv2
    h, w = img.shape[:2]
    ratio = min(max(SCALE) / max(h, w), min(SCALE) / min(h, w))
    nh, nw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    resized = cv2.resize(img, (nw, nh)).astype(np.float32)
    norm = (resized[..., ::-1] - MEAN) / STD
    ph = (nh + 31) // 32 * 32
    pw = (nw + 31) // 32 * 32
    padded = np.zeros((ph, pw, 3), np.float32)
    padded[:nh, :nw] = norm
    return padded, np.array([[nw / w, nh / h]], np.float32)


def people_above(out, score_thr: float):
    """``results_to_host``'s dict of one image -> the people whose score
    is at least ``score_thr``, as the JSON lists them."""
    people = []
    for score, pose in zip(out['scores'], out['poses']):
        if score < score_thr:
            continue
        people.append(dict(score=float(score),
                           joints_uvd=np.asarray(pose).tolist()))
    return people


def draw(img: np.ndarray, people) -> np.ndarray:
    """SKELETON and the joints of ``people`` onto ``img`` (in place, as
    the JAX tool draws them); returns ``img``."""
    import cv2
    for person in people:
        pts = np.asarray(person['joints_uvd'])[:, :2].astype(int)
        for a, b in SKELETON:
            if a < len(pts) and b < len(pts):
                cv2.line(img, tuple(pts[a]), tuple(pts[b]),
                         (0, 255, 0), 2)
        for p in pts:
            cv2.circle(img, tuple(p), 3, (0, 0, 255), -1)
    return img


def run(config, checkpoint, image, out=None, score_thr=0.3, device='cuda',
        dtype='bfloat16'):
    """The demo; returns the dict it prints as JSON."""
    import cv2
    import torch

    from ..apis.inference import init_model, make_predict_fn, results_to_host

    model, cfg = init_model(config, checkpoint,
                            dtype=getattr(torch, dtype), device=device)
    head = cfg.model.bbox_head
    predict = make_predict_fn(model, dict(cfg.model.test_cfg),
                              int(head.num_joints), tuple(head.strides),
                              device=device)
    img = cv2.imread(image)
    if img is None:
        raise FileNotFoundError(f'cannot read {image}')
    padded, sf = preprocess(img)
    decoded = predict(torch.from_numpy(padded)[None], torch.from_numpy(sf))
    result = results_to_host(decoded, [image])[0]
    people = people_above(result, score_thr)
    if out:
        cv2.imwrite(out, draw(img, people))
    return dict(image=image, num_people=len(people), people=people)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Single-image DAS inference with the PyTorch port')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('image')
    parser.add_argument('--out', default=None)
    parser.add_argument('--score-thr', type=float, default=0.3)
    parser.add_argument('--device', default='cuda',
                        help="where the model runs: 'cuda' (default) or "
                             "'cpu'")
    parser.add_argument('--dtype', default='bfloat16',
                        choices=('bfloat16', 'float32'))
    args = parser.parse_args(argv)
    res = run(args.config, args.checkpoint, args.image, args.out,
              args.score_thr, args.device, args.dtype)
    print(json.dumps(res, indent=2))
    if args.out:
        print(f'saved {args.out}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
