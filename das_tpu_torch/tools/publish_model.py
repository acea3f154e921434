"""Strip training state and stamp a content hash into the filename, the
port's ``tools/model_converters/publish_model.py`` (ref
tools/model_converters/publish_model.py).

Usage:
    python -m das_tpu_torch.tools.publish_model IN.pth OUT.pth

Takes a ``.pth`` or a step file of the port's checkpoint directory
(``checkpoint/manager.py``) and drops the training state: the
``optimizer`` of a reference checkpoint, and the ``momentum``, ``count``
and ``step`` that the manager writes beside the model (whose tensors become
the ``state_dict``). The file is written as ``OUT-<sha256[:8]>.pth``.
"""

import argparse
import hashlib
import os

TRAINING_STATE = ('optimizer', 'momentum', 'count', 'step')


def publish(in_file: str, out_file: str) -> str:
    """Write the published copy of ``in_file``; returns its path."""
    import torch
    ckpt = torch.load(in_file, map_location='cpu', weights_only=False)
    if 'model' in ckpt and 'state_dict' not in ckpt:
        ckpt['state_dict'] = ckpt.pop('model')
    for key in TRAINING_STATE:
        ckpt.pop(key, None)
    out = out_file[:-4] if out_file.endswith('.pth') else out_file
    torch.save(ckpt, out + '.pth')
    with open(out + '.pth', 'rb') as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    final = f'{out}-{sha[:8]}.pth'
    os.replace(out + '.pth', final)
    return final


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('in_file')
    ap.add_argument('out_file')
    args = ap.parse_args(argv)
    print(f'wrote {publish(args.in_file, args.out_file)}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
