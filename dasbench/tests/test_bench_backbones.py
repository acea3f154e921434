"""A backbone type arrives as files alone: in a copy of the benchmark
with nothing else changed, a toy backbone's module and a configuration
that names it build the reference, draw its weights, count its FLOPs and
take a reference training step; and a configuration whose type is
missing, or has no module, is refused by name."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dasbench.reference import model as ref_model
from dasbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]

TOY = '''"""A toy backbone: a stride-4 stem (a conv and a BN in a Sequential)
and a stride-2 conv applied three times, a map at each of strides 4 to
32; frozen_stages >= 0 freezes the stem."""

import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..model import BatchNorm, Conv

REPO_KEYS = ('width', 'frozen_stages')


class Toy(nn.Module):

    def __init__(self, width, frozen_stages):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.stem = nn.Sequential(Conv(3, width, 3, 4, 1, bias=False),
                                  BatchNorm(width))
        self.down = Conv(width, width, 3, 2, 1)

    def frozen(self):
        return [self.stem] if self.frozen_stages >= 0 else []

    def train(self, mode=True):
        super().train(mode)
        for m in self.frozen():
            m.eval()
        return self

    def _down(self, x):
        return F.relu(self.down(x))

    def forward(self, x, remat=False):
        x = F.relu(self.stem(x))
        out = [x]
        for _ in range(3):
            x = checkpoint(self._down, x, use_reentrant=False) if remat \\
                else self._down(x)
            out.append(x)
        return out


def build(b):
    return Toy(b['width'], b['frozen_stages'])


def out_channels(b):
    return [b['width']] * 4


def frozen_prefixes(b):
    return ('backbone.stem.',) if b['frozen_stages'] >= 0 else ()
'''

DRIVE = '''
import json
import torch
from dasbench import check, weights
from dasbench.drivers.train import synthetic_batch
from dasbench.reference import model as ref_model
from dasbench.reference import train as ref_train
from dasbench.roofline.model_flops import flops

torch.set_num_threads(2)
cfg = json.load(open('dasbench/configs/toy.json'))
m = cfg['model']
model = ref_model.build(m)
assert type(model.backbone).__module__ == 'dasbench.reference.backbones.Toy'
state = weights.make_state(m, cfg['assumed']['weights'], 3, 'cpu')
model.load_state_dict(state, strict=True)
norms = [n for n, mod in model.named_modules()
         if isinstance(mod, (ref_model.BatchNorm, ref_model.GroupNorm))]
assert 'backbone.stem.1' in norms
for n in norms:
    assert bool((state[n + '.weight'] == 1).all()), n
    assert bool((state[n + '.bias'] == 0).all()), n
f = flops(m, 1, cfg['train_hw'], train=False)
assert flops(m, 2, cfg['train_hw'], train=False) == 2 * f > 0
assert ref_train.frozen_prefixes(m) == ('backbone.stem.',)
batch = synthetic_batch(2, *cfg['train_hw'], m['num_joints'], m['root_idx'],
                        3, torch.Generator().manual_seed(4), 'cpu')
ref = check.reference_steps(cfg, 3, [batch], 'cpu')
assert all(v == v for v in ref['losses'][0].values())
for k, v in ref['p3'].items():
    if k.startswith('backbone.stem.'):
        assert torch.equal(v, state[k]), k
assert not torch.equal(ref['p3']['backbone.down.weight'],
                       state['backbone.down.weight'])
# the frozen stem's BN stays in eval: no batch statistics from it
assert not any(k.startswith('backbone.stem.') for k in ref['bn1'])
print('toy backbone ok')
'''


def toy_config(**backbone) -> dict:
    cfg = tiny.dasbench_config()
    cfg['name'] = 'toy'
    cfg['model']['backbone'] = backbone
    return cfg


def test_a_backbone_arrives_as_a_file(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(REPO / 'dasbench', root / 'dasbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (root / 'dasbench/reference/backbones/Toy.py').write_text(TOY)
    (root / 'dasbench/configs/toy.json').write_text(json.dumps(toy_config(
        type='Toy', width=16, frozen_stages=0)))
    p = subprocess.run([sys.executable, '-c', DRIVE], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert p.stdout.strip().endswith('toy backbone ok')


@pytest.mark.parametrize('backbone,named', [
    (dict(unit_channels=16), "'type'"),
    (dict(type='NoSuchBackbone'), 'NoSuchBackbone.py')])
def test_a_backbone_without_a_module_is_named(backbone, named):
    with pytest.raises((KeyError, ModuleNotFoundError), match=named):
        ref_model.build(toy_config(**backbone)['model'], 'meta')
