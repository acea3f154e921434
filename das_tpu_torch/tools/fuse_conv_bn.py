"""Fold conv+bn of a checkpoint and save the folded weights, the port's
``tools/misc/fuse_conv_bn.py`` (ref tools/misc/fuse_conv_bn.py).

Usage:
    python -m das_tpu_torch.tools.fuse_conv_bn CONFIG CKPT.pth OUT.pth \
        [--device cuda]

Loads the ``.pth`` into the config's model (f32, on ``--device``: the card
by default, ``cpu`` to run there), folds every BatchNorm as the JAX tool
does (``models/fuse.fold_conv_bn_keep_layout``: the keys stay, each
BatchNorm left as identity statistics) and writes the reference-layout
``.pth`` with ``meta=dict(fused_conv_bn=True)``: the keys and arrays the JAX
tool writes, which load strictly with ``init_model``.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('checkpoint', help='torch .pth checkpoint')
    ap.add_argument('out', help='output fused .pth path')
    ap.add_argument('--device', default='cuda',
                    help="where the model is folded: 'cuda' (default) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    from ..apis.inference import init_model
    from ..checkpoint.convert import save_torch_checkpoint
    from ..models.fuse import fold_conv_bn_keep_layout

    model, _ = init_model(args.config, args.checkpoint, device=args.device)
    model, n = fold_conv_bn_keep_layout(model)
    print(f'fused {n} conv+bn pairs')
    save_torch_checkpoint(model, args.out, meta=dict(fused_conv_bn=True))
    print(f'wrote {args.out}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
