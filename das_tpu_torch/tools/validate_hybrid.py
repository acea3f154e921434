"""Validate a checkpoint for the 'shift'/'hybrid' DCN lowerings, the port's
``tools/validate_hybrid.py``.

The gather-free lowerings are exact only while learned tap offsets stay
inside the +-radius box ('shift') or while at most ``--budget`` pixels per
image have any out-of-radius tap ('hybrid': those pixels are repaired
exactly; see das_tpu_torch/ops/deform_conv.py). This forwards sample images,
collects every DCN call's offset field (``apis/inference.dcn_offset_table``,
through forward hooks on the ``conv_offset`` convs), and reports per layer
and pyramid level

  max |offset|            -> smallest radius that keeps 'shift' exact
  flagged pixels / image  -> smallest budget that keeps 'hybrid' exact

Exit code 0 iff the ``--mode`` condition holds: 'hybrid' (default) needs
every layer's flagged-pixel count <= --budget; 'shift' needs every layer's
max |offset| <= --radius; 'both' needs both.

Usage:
    python -m das_tpu_torch.tools.validate_hybrid --ckpt work/latest.pth \
        [--config CONFIG] [--radius 2] [--budget 2048] \
        [--images img1.jpg ...] [--device cuda]

``--ckpt`` is a ``.pth`` (the reference layout) or a checkpoint directory
of ``checkpoint/manager.py`` (its latest step); random init (seed 0) if
omitted. Random-normal inputs (``RandomState(0)``) are used when no images
are given. The model runs in f32 with TF32 off, on ``--device`` (the card
by default; ``cpu`` to run there).
"""

import argparse
import os


def load_weights(model, ckpt: str):
    """``ckpt`` (a ``.pth`` or a checkpoint directory) into ``model``,
    strict; returns the line to print."""
    if ckpt.endswith('.pth'):
        from ..checkpoint.convert import load_checkpoint_report
        report = load_checkpoint_report(model, ckpt, strict=True)
        return (f'loaded {ckpt}: missing={len(report["missing"])} '
                f'unexpected={len(report["unexpected"])}')
    if not os.path.isdir(ckpt):
        raise FileNotFoundError(f'{ckpt} is neither a .pth nor a checkpoint '
                                f'directory')
    from ..checkpoint.manager import CheckpointManager
    from ..parallel.train_step import TrainState
    state = CheckpointManager(ckpt).restore(TrainState(0, model, None))
    return f'restored {ckpt} at step {state.step}'


def inputs(images, height: int, width: int):
    """(N, H, W, 3) float32: the images (BGR->RGB, resized, (x - 127.5) /
    58), or RandomState(0).randn(2, H, W, 3)."""
    import numpy as np
    if images:
        import cv2
        imgs = []
        for path in images:
            im = cv2.imread(path)[..., ::-1].astype(np.float32)
            im = cv2.resize(im, (width, height))
            imgs.append((im - 127.5) / 58.0)
        return np.stack(imgs).astype(np.float32)
    rng = np.random.RandomState(0)
    return rng.randn(2, height, width, 3).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--config', default='configs/das/exp_panoptic.py')
    p.add_argument('--ckpt', default=None,
                   help='.pth (reference layout) or checkpoint directory; '
                        'random init if omitted')
    p.add_argument('--images', nargs='*', default=None)
    p.add_argument('--height', type=int, default=512)
    p.add_argument('--width', type=int, default=960)
    p.add_argument('--radius', type=int, default=2)
    p.add_argument('--budget', type=int, default=2048)
    p.add_argument('--mode', choices=('shift', 'hybrid', 'both'),
                   default='hybrid',
                   help='which lowering the exit code certifies')
    p.add_argument('--device', default='cuda',
                   help="where the model runs: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from ..apis.inference import dcn_offset_table
    from ..config import Config
    from ..models import build_model

    cfg = Config.fromfile(args.config)
    model = build_model(dict(cfg.model), device=args.device, seed=0)
    if args.ckpt:
        print(load_weights(model, args.ckpt))
    img = torch.from_numpy(inputs(args.images, args.height, args.width))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rows = dcn_offset_table(model, img, args.radius)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32

    shift_ok = hybrid_ok = True
    print(f'{"layer":70s} {"max|off|":>9s} {"flagged/img":>12s}')
    for name, mx, flagged in rows:
        shift_ok &= mx <= args.radius
        hybrid_ok &= flagged <= args.budget
        print(f'{name[:70]:70s} {mx:9.3f} {flagged:12d}'
              f'{"" if flagged <= args.budget else "  <-- EXCEEDS"}')
    print(f'\nshift(r={args.radius}) exact: '
          f'{"yes" if shift_ok else "NO"};  '
          f'hybrid(r={args.radius}, budget={args.budget}) exact: '
          f'{"yes" if hybrid_ok else "NO"}')
    ok = dict(shift=shift_ok, hybrid=hybrid_ok,
              both=shift_ok and hybrid_ok)[args.mode]
    return 0 if ok else 1


if __name__ == '__main__':
    raise SystemExit(main())
