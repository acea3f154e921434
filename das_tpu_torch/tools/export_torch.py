"""Export a checkpoint directory of the port's training (``checkpoint/
manager.py``) to a reference-layout torch ``.pth``, the port's
``tools/export_torch.py``.

Embeds the reference's checkpoint meta (version, time, config text,
CLASSES: ref tools/train.py:200-210) so the file round-trips through
mmcv-style loaders, the JAX package's ``load_torch_checkpoint`` and the
port's ``init_model``.

Usage:
    python -m das_tpu_torch.tools.export_torch CONFIG WORK_DIR/ckpts OUT.pth \
        [--step N] [--device cuda]
"""

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('ckpt_dir')
    ap.add_argument('out')
    ap.add_argument('--step', default=None,
                    help='the step to export (default: the latest)')
    ap.add_argument('--device', default='cuda',
                    help="where the model is restored: 'cuda' (default) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    import das_tpu_torch
    from ..apis.inference import init_model
    from ..checkpoint.convert import save_torch_checkpoint
    from ..checkpoint.manager import CheckpointManager
    from ..parallel.train_step import TrainState

    model, cfg = init_model(args.config, device=args.device)
    # the saved state is the model's tensors, momentum, count and step;
    # only the model's are exported
    state = CheckpointManager(args.ckpt_dir).restore(
        TrainState(0, model, None), args.step)
    meta = dict(das_tpu_torch_version=das_tpu_torch.__version__,
                time=time.asctime(),
                config=cfg.dump(),
                CLASSES=('person',))
    save_torch_checkpoint(state.model, args.out, meta=meta)
    print(f'wrote {args.out} (step {state.step})')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
