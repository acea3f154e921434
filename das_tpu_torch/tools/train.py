"""Training CLI, the port's ``tools/train.py`` (ref: tools/train.py:94-220).

Usage:
    python -m das_tpu_torch.tools.train configs/das/exp_panoptic_tpu.py \
        [--work-dir DIR] [--resume-from latest|STEP|FILE] \
        [--load-from CKPT.pth] [--seed N] [--max-steps N] [--autoscale-lr] \
        [--cfg-options k=v ...] [--device cuda|cpu]

    python -m torch.distributed.run --standalone --nproc-per-node W \
        -m das_tpu_torch.tools.train CONFIG --launcher pytorch \
        [--dist-backend nccl|gloo] [--device DEVICE] ...

Trains in bf16 compute on f32 master weights through ``train_model``: on
one card (``--device``: the card by default, ``cpu`` to run there), or,
with ``--launcher pytorch`` under ``torchrun`` (the counterpart of the JAX
CLI's ``--multihost``), data-parallel over W processes, one card each
(``cuda:LOCAL_RANK``; ``--device`` pins every rank to one device, which
only gloo can share). ``--autoscale-lr`` scales the learning rate linearly
by the world size / 8 (ref tools/train.py:75-78).
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
                             '(ref tools/train.py:75-78)')
    parser.add_argument('--cfg-options', nargs='+', default=None)
    parser.add_argument('--device', default=None,
                        help="where to train: the card (default; "
                             "cuda:LOCAL_RANK under a launcher) or 'cpu'")
    parser.add_argument('--launcher', choices=['none', 'pytorch'],
                        default='none',
                        help="'pytorch': one rank of a torchrun job")
    parser.add_argument('--dist-backend', choices=['nccl', 'gloo'],
                        default=None,
                        help='the process group backend (default: nccl on '
                             'a card, gloo on the CPU)')
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ..apis import train_model
    from ..config import Config
    from ..parallel import init_distributed, rank, world_size

    device = init_distributed(args.launcher, args.dist_backend, args.device)
    group = dist.group.WORLD if args.launcher != 'none' else None
    try:
        cfg = Config.fromfile(args.config)
        if args.cfg_options:
            cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
        if args.autoscale_lr:
            cfg['optimizer']['lr'] = cfg.optimizer['lr'] * \
                world_size(group) / 8

        work_dir = args.work_dir or os.path.join(
            'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
        state = train_model(cfg, work_dir=work_dir,
                            resume_from=args.resume_from,
                            load_from=args.load_from, seed=args.seed,
                            max_steps=args.max_steps, device=device,
                            group=group)
        if rank(group) == 0:
            print(f'[das_tpu_torch] trained to step {state.step} on '
                  f'{world_size(group)} rank(s); checkpoints in '
                  f'{os.path.join(work_dir, "ckpts")}')
    finally:
        if group is not None:
            dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
