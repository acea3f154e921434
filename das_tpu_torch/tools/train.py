"""Training CLI, the port's ``tools/train.py`` (ref: tools/train.py:94-220).

Usage:
    python -m das_tpu_torch.tools.train configs/das/exp_panoptic_tpu.py \
        [--work-dir DIR] [--resume-from latest|STEP|FILE] \
        [--load-from CKPT.pth] [--seed N] [--max-steps N] [--autoscale-lr] \
        [--cfg-options k=v ...] [--device cuda|cpu]

Trains on one card (``--device``: the card by default, ``cpu`` to run
there) in bf16 compute on f32 master weights, through ``train_model``.
``--autoscale-lr`` scales the learning rate linearly by the world size / 8
(ref tools/train.py:75-78), with a world of one card. Training on several
cards is not ported.
"""

import argparse
import os

from .test import parse_cfg_options


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Train a DAS model with the PyTorch port')
    parser.add_argument('config')
    parser.add_argument('--work-dir', default=None)
    parser.add_argument('--resume-from', default=None)
    parser.add_argument('--load-from', default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--max-steps', type=int, default=None)
    parser.add_argument('--autoscale-lr', action='store_true',
                        help='linear lr scaling by the world size / 8 '
                             '(ref tools/train.py:75-78); one card here')
    parser.add_argument('--cfg-options', nargs='+', default=None)
    parser.add_argument('--device', default=None,
                        help="where to train: the card (default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..apis import train_model
    from ..config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    if args.autoscale_lr:
        world_size = 1
        cfg['optimizer']['lr'] = cfg.optimizer['lr'] * world_size / 8

    work_dir = args.work_dir or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    state = train_model(cfg, work_dir=work_dir,
                        resume_from=args.resume_from,
                        load_from=args.load_from, seed=args.seed,
                        max_steps=args.max_steps, device=args.device)
    print(f'[das_tpu_torch] trained to step {state.step}; checkpoints in '
          f'{os.path.join(work_dir, "ckpts")}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
