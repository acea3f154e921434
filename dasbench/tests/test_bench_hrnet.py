"""The HRNetV2-W48 configuration (``exp_panoptic_hrnet48``): its JSON is
the repo config (the head's and recipe's keys, the backbone's by
``REPO_KEYS``, the FPN's inputs), the program's and the reference's
module trees at W48 are equal key for key and shape for shape, the
backbone has HRNetV2-W48's 305 convolutions, 305 BatchNorms and 65.3 M
parameters, its frozen rule is the program's, and its FLOPs are those of
the configuration's cells."""

import json
from pathlib import Path

import pytest
import torch

from das_tpu_torch.models import build_model
from das_tpu_torch.models.layers import BatchNorm
from dasbench.reference import backbones
from dasbench.reference import model as ref_model
from dasbench.reference import train as ref_train
from dasbench.roofline.backbone_flops import flops
from dasbench.tests.test_bench_reference import configs
from dasbench.tests.test_bench_reference import \
    test_backbone_is_the_repo_backbone as backbone_is_the_repo_backbone
from dasbench.tests.test_bench_reference import \
    test_configuration_is_the_repo_config as configuration_is_the_repo_config

REPO = Path(__file__).resolve().parents[2]
NAME = 'exp_panoptic_hrnet48'


def test_json_is_the_repo_config():
    """Head, recipe, buckets and the whole module tree, program against
    reference, key for key and shape for shape on meta."""
    configuration_is_the_repo_config(NAME)


def test_backbone_keys_and_fpn_inputs_are_the_repo_configs():
    backbone_is_the_repo_backbone(NAME)
    cfg, pcfg = configs(NAME)
    b = cfg['model']['backbone']
    assert b['type'] == 'HRNet'
    assert backbones.find(b).out_channels(b) == [48, 96, 192, 384] == \
        list(pcfg.model.neck.in_channels)
    assert cfg['reduced'] == [] and pcfg.model.get('pretrained') is None


@pytest.mark.parametrize('side', ['program', 'reference'])
def test_hrnet_w48_counts(side):
    cfg, pcfg = configs(NAME)
    if side == 'program':
        net = build_model(dict(pcfg.model), device='meta').backbone
        conv, norm = torch.nn.Conv2d, BatchNorm
    else:
        net = ref_model.build(cfg['model'], 'meta').backbone
        conv, norm = ref_model.Conv, ref_model.BatchNorm
    mods = list(net.modules())
    assert sum(isinstance(m, conv) for m in mods) == 305
    assert sum(isinstance(m, norm) for m in mods) == 305
    assert round(sum(p.numel() for p in net.parameters()) / 1e6, 1) == 65.3


def test_frozen_rule_is_the_programs():
    cfg, pcfg = configs(NAME)
    prog = build_model(dict(pcfg.model), device='meta').backbone
    assert prog.frozen_prefixes() == ref_train.frozen_prefixes(
        cfg['model']) == ('backbone.conv1.', 'backbone.bn1.',
                          'backbone.conv2.', 'backbone.bn2.',
                          'backbone.layer1.')


def test_backbone_flops_at_the_cells_buckets():
    """The backbone's forward FLOPs for a B=4 request at the 640x1152
    serving bucket and at the 640x1344 train bucket (1.906 and 2.224
    TFLOP)."""
    cfg, _ = configs(NAME)
    b = cfg['model']['backbone']
    serve, train = flops(b, 4, (640, 1152)), flops(b, 4, (640, 1344))
    assert round(serve / 1e12, 3) == 1.906 and round(train / 1e12, 3) == \
        2.224
    assert flops(b, 8, (640, 1152)) == 2 * serve
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    cells = [w for w in bench['workloads'] if w['config'] == NAME]
    assert {w['name'] for w in cells} == {'panoptic_hrnet48-serve-b4',
                                          'panoptic_hrnet48-train-b4'}
