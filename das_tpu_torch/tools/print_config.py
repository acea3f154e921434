"""Print the fully-resolved config, the port's ``tools/misc/print_config.py``
(ref tools/misc/print_config.py).

Usage:
    python -m das_tpu_torch.tools.print_config CONFIG [--cfg-options k=v ...]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description='Print the whole config')
    ap.add_argument('config')
    ap.add_argument('--cfg-options', nargs='+', default=None)
    args = ap.parse_args(argv)

    from ..config import Config
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        from .test import parse_cfg_options
        cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    print(f'Config:\n{cfg.dump()}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
