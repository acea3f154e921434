"""Render predicted poses from a ``das_tpu_torch.tools.test --out`` pickle,
the port's ``tools/misc/visualize_results.py`` (ref
tools/misc/visualize_results.py, rebuilt for DAS outputs).

Usage:
    python -m das_tpu_torch.tools.visualize_results RESULTS.pkl \
        [--out-dir work_dirs/vis] [--num 20] [--score-thr 0.0]
"""

import argparse
import os
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('results', help='pickle from das_tpu_torch.tools.test '
                                    '--out')
    ap.add_argument('--out-dir', default='work_dirs/vis')
    ap.add_argument('--num', type=int, default=20)
    ap.add_argument('--score-thr', type=float, default=0.0)
    args = ap.parse_args(argv)

    import cv2
    import numpy as np

    from ..core.visualize import draw_pose_2d

    with open(args.results, 'rb') as f:
        outputs = pickle.load(f)

    os.makedirs(args.out_dir, exist_ok=True)
    for out in outputs[:args.num]:
        path = out['image_paths'][0]
        img = cv2.imread(path)
        if img is None:
            print(f'skip (no image): {path}')
            continue
        poses = np.asarray(out['poses'])
        scores = np.asarray(out['scores'])
        keep = scores >= args.score_thr
        vis_img = draw_pose_2d(img, poses[keep],
                               vis=np.asarray(out['vis'])[keep],
                               scores=scores[keep])
        dst = os.path.join(args.out_dir, os.path.basename(path))
        cv2.imwrite(dst, vis_img)
        print(f'wrote {dst} ({int(keep.sum())} people)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
