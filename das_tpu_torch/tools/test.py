"""Evaluation CLI, the port's ``tools/test.py`` (ref: tools/test.py).

Usage:
    python -m das_tpu_torch.tools.test configs/das/exp_panoptic.py \
        [CKPT.pth] [--eval mpjpe] [--batch-size 4] [--device-preprocess] \
        [--fuse-conv-bn] [--cfg-options k=v ...] [--device cuda]

Builds the model in bf16 on ``--device`` (the card by default; ``cpu`` to
run there), loads the reference ``.pth`` when one is given (random weights
from seed 0 otherwise), sweeps ``cfg.data.test`` through ``run_test`` and
prints the dataset's metrics. ``--device-preprocess`` decodes on the host
and resizes, normalises and pads on the device (needs no ``cv2`` for PNG
images). ``--fuse-conv-bn`` folds every BatchNorm into its conv after the
checkpoint is loaded: the model is built in f32, fused, then cast to bf16,
so the folded weights are rounded once.
"""

import argparse
import ast


def parse_cfg_options(pairs):
    """``['a.b=1', 'c=x']`` -> ``{'a.b': 1, 'c': 'x'}`` (values through
    ``ast.literal_eval``, else kept as strings)."""
    out = {}
    for pair in pairs or []:
        k, v = pair.split('=', 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate a DAS model with the PyTorch port')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--eval', nargs='+', default=['mpjpe'])
    parser.add_argument('--batch-size', type=int, default=4)
    parser.add_argument('--out', default=None,
                        help='pickle the raw outputs here')
    parser.add_argument('--format-only', action='store_true',
                        help='write result_keypoints.json and skip '
                             'evaluation (ref tools/test.py:33,214-218)')
    parser.add_argument('--res-folder', default='tmp',
                        help='folder for result_keypoints.json (the '
                             "reference's evaluate res_folder, default "
                             "'tmp')")
    parser.add_argument('--cfg-options', nargs='+', default=None)
    parser.add_argument('--fuse-conv-bn', action='store_true',
                        help='fold BN into convs before inference '
                             '(ref tools/test.py:175-176)')
    parser.add_argument('--device', default='cuda',
                        help="where the model runs: 'cuda' (default) or "
                             "'cpu'")
    parser.add_argument('--device-preprocess', action='store_true',
                        help='resize, normalise and pad on the device; the '
                             'host only decodes the images')
    args = parser.parse_args(argv)

    import torch

    from ..apis import init_model, run_test
    from ..config import Config
    from ..datasets import build_dataset
    from ..models.fuse import fuse_conv_bn
    from ..models.layers import cast_compute

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))

    dtype = torch.float32 if args.fuse_conv_bn else torch.bfloat16
    model, cfg = init_model(cfg, checkpoint=args.checkpoint, dtype=dtype,
                            device=args.device)
    if args.fuse_conv_bn:
        model, n = fuse_conv_bn(model)
        cast_compute(model, torch.bfloat16)
        print(f'[das_tpu_torch] fused {n} conv+bn pairs')
    dataset = build_dataset(cfg.data['test'])
    outputs = run_test(model, dataset, cfg, batch_size=args.batch_size,
                       device_preprocess=args.device_preprocess or None)
    if args.out:
        import pickle
        with open(args.out, 'wb') as f:
            pickle.dump(outputs, f)
    if args.format_only:
        _, res_file = dataset.format_results(outputs,
                                             res_folder=args.res_folder)
        print(f'[das_tpu_torch] wrote {res_file}')
        return 0
    results = dataset.evaluate(outputs, metric=args.eval,
                               res_folder=args.res_folder)
    for k, v in results.items():
        print(k, v)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
