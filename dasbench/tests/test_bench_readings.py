"""The harness reads, exactly, what ``readings.json`` keeps: the seeded
weights' rule a leaf and their bytes, the model's FLOPs at every cell's
shapes, and the tiny reference's eval outputs and training step
(``dasbench/tests/readings.py`` says how each is taken)."""

import json
from pathlib import Path

import pytest
import torch

from dasbench.tests import readings

KEPT = json.loads((Path(__file__).parent / 'readings.json').read_text())


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(readings.THREADS)


@pytest.mark.parametrize('name', readings.CONFIGS)
def test_weight_rule_a_leaf(name):
    assert readings.state_table(name) == KEPT['tables'][name]


@pytest.mark.parametrize('seed', readings.SEEDS)
@pytest.mark.parametrize('name', readings.CONFIGS)
def test_weight_bytes(name, seed):
    assert readings.state_sha256(name, seed) == \
        KEPT['state_sha256'][name][str(seed)]


@pytest.mark.parametrize('cell', sorted(KEPT['flops']))
def test_flops_at_the_cells_shapes(cell):
    shape = {k: v for k, v in KEPT['flops'][cell].items() if k != 'flops'}
    assert readings.cell_shapes()[cell] == shape
    assert readings.cell_flops(shape) == KEPT['flops'][cell]['flops']


@pytest.mark.parametrize('layers', readings.TINY_LAYERS)
def test_tiny_reference_eval_outputs(layers):
    assert readings.tiny_eval_sha256(layers) == KEPT['tiny'][str(layers)][
        'eval']


@pytest.mark.parametrize('layers', readings.TINY_LAYERS)
def test_tiny_reference_train_step(layers):
    assert readings.tiny_step_sha256(layers) == KEPT['tiny'][str(layers)][
        'step']
