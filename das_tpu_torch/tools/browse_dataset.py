"""Render GT poses of a dataset split to images, the port's
``tools/misc/browse_dataset.py`` (ref tools/misc/browse_dataset.py, rebuilt
for the DAS pose datasets).

Usage:
    python -m das_tpu_torch.tools.browse_dataset CONFIG [--split train] \
        [--out-dir work_dirs/browse] [--num 20]
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('--split', default='train')
    ap.add_argument('--out-dir', default='work_dirs/browse')
    ap.add_argument('--num', type=int, default=20)
    args = ap.parse_args(argv)

    import cv2
    import numpy as np

    from ..config import Config
    from ..core.visualize import draw_pose_2d
    from ..datasets import build_dataset

    cfg = Config.fromfile(args.config)
    data_cfg = cfg.data[args.split]
    if isinstance(data_cfg, (list, tuple)):
        data_cfg = data_cfg[0]
    # raw annotations only: no aug pipeline
    data_cfg = dict(data_cfg)
    data_cfg['pipeline'] = []
    dataset = build_dataset(data_cfg)

    os.makedirs(args.out_dir, exist_ok=True)
    J = dataset.num_joints if hasattr(dataset, 'num_joints') else 15
    for i in range(min(args.num, len(dataset))):
        info = dataset.data_infos[i]
        ann = dataset.get_ann_info(i)
        prefix = getattr(dataset, 'img_prefix', '') or ''
        path = os.path.join(prefix, info['file_name'])
        img = cv2.imread(path)
        if img is None:
            print(f'skip (no image): {path}')
            continue
        poses = np.asarray(ann['gt_poses_3d'])
        if poses.size == 0:
            continue
        uvd = poses[:, 3:3 + 3 * J].reshape(-1, J, 3)
        vis = poses[:, 3 + 3 * J:3 + 4 * J]
        out = draw_pose_2d(img, uvd, vis=vis)
        dst = os.path.join(args.out_dir,
                           os.path.basename(info['file_name']))
        cv2.imwrite(dst, out)
        print(f'wrote {dst} ({len(uvd)} people)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
