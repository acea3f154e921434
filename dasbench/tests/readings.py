"""Readings of the harness that hold for every run of a cell, whatever the
card: the seeded weights' rule a leaf and their bytes on the CPU, the
model's FLOPs at every cell's shapes, and the tiny reference's outputs
and training step. ``test_bench_readings`` holds the harness to the
readings kept in ``readings.json``, which

    python -m dasbench.tests.readings > dasbench/tests/readings.json

writes from the code at hand (on the CPU, two threads).
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

import torch

from dasbench import check, weights
from dasbench.drivers import train as train_driver
from dasbench.reference import model as ref_model
from dasbench.reference import precision
from dasbench.reference import preprocess as ref_pre
from dasbench.roofline.model_flops import flops
from dasbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ('exp_panoptic', 'exp_mupots')
SEEDS = (0, 4600063352)
TINY_LAYERS = (1, 2)
THREADS = 2


def config(name: str) -> Dict:
    return json.loads((ROOT / f'dasbench/configs/{name}.json').read_text())


def state_table(name: str) -> List:
    """[key, shape, 'std' or 'constant', value] a leaf, in the state's
    order."""
    cfg = config(name)
    return [[k, list(s), 'std' if std is not None else 'constant',
             std if std is not None else const]
            for k, s, std, const in weights.leaves(
                cfg['model'], cfg['assumed']['weights'])]


def _digest(h, *tensors):
    for t in tensors:
        t = t.detach().to('cpu').contiguous()
        h.update(f'{t.dtype} {tuple(t.shape)};'.encode())
        h.update(t.numpy().tobytes())


def state_sha256(name: str, seed: int) -> str:
    """The sha256 of the seed's state drawn on the CPU: each key, dtype,
    shape and bytes in the state's order."""
    cfg = config(name)
    h = hashlib.sha256()
    for k, v in weights.make_state(cfg['model'], cfg['assumed']['weights'],
                                   seed, 'cpu').items():
        h.update(k.encode())
        _digest(h, v)
    return h.hexdigest()


def cell_shapes() -> Dict[str, Dict]:
    """Each cell's batch, shapes and kind, as its driver gives them to the
    FLOP count."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    files = {c['name']: c['file'] for c in bench['configs']}
    out = {}
    for cell in bench['workloads']:
        cfg = json.loads((ROOT / files[cell['config']]).read_text())
        mix = json.loads((ROOT / 'dasbench/traffic' /
                          f"{cell['traffic']}.json").read_text())
        p, train = mix['params'], mix['driver'] == 'train'
        hw = cfg['train_hw'] if train else list(ref_pre.bucket(
            *p['frame_hw'], cfg['test_scale'])[1])
        out[cell['name']] = dict(config=cell['config'],
                                 batch=int(p['batch']), hw=hw, train=train)
    return out


def cell_flops(shape: Dict) -> int:
    return flops(config(shape['config'])['model'], shape['batch'],
                 shape['hw'], shape['train'])


def tiny_eval_sha256(layers: int) -> str:
    """The tiny reference's eval outputs (every field of every level, in
    the program's units) for seed 11 on a seeded batch."""
    cfg = tiny.dasbench_config(layers)
    img = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    h = hashlib.sha256()
    with precision.use(precision.EXACT), torch.no_grad():
        model = check.reference_model(cfg, 11, 'cpu').eval()
        for level in ref_model.eval_outputs(model(img), cfg['model']):
            for k in sorted(level):
                h.update(k.encode())
                _digest(h, level[k])
    return h.hexdigest()


def tiny_step_sha256(layers: int) -> str:
    """One reference training step of the tiny model from seed 12's
    weights: its loss terms, gradient norm, momentum, running statistics
    and parameters after the step."""
    cfg = tiny.dasbench_config(layers)
    m = cfg['model']
    batch = train_driver.synthetic_batch(
        2, *cfg['train_hw'], tiny.J, m['root_idx'], 3,
        torch.Generator().manual_seed(4), 'cpu')
    ref = check.reference_steps(cfg, 12, [batch], 'cpu')
    h = hashlib.sha256()
    h.update(json.dumps([ref['losses'], ref['grad_norm']]).encode())
    for part in ('m1', 'bn1', 'p3'):
        for k, v in ref[part].items():
            h.update(f'{part} {k}'.encode())
            _digest(h, v)
    return h.hexdigest()


def readings() -> Dict:
    torch.set_num_threads(THREADS)
    shapes = cell_shapes()
    return dict(
        tables={n: state_table(n) for n in CONFIGS},
        state_sha256={n: {str(s): state_sha256(n, s) for s in SEEDS}
                      for n in CONFIGS},
        flops={c: dict(s, flops=cell_flops(s)) for c, s in shapes.items()},
        tiny={str(n): dict(eval=tiny_eval_sha256(n),
                           step=tiny_step_sha256(n)) for n in TINY_LAYERS})


def dumps(r: Dict) -> str:
    """``r`` as JSON, a list of numbers and strings on one line."""
    flat = r'\[[^\[\]{}]*\]'
    text = json.dumps(r, indent=1)
    for pattern in (flat, rf'\[(?:[^\[\]{{}}]|{flat})*\]'):
        text = re.sub(pattern, lambda m: ' '.join(m[0].split()), text)
    return text + '\n'


if __name__ == '__main__':
    sys.stdout.write(dumps(readings()))
