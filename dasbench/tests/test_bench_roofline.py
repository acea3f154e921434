"""The roofline arithmetic reproduces the bounds the port's smoke run
printed, stands alone, and counts the work of the cells' shapes."""

import json
from pathlib import Path

import pytest
import torch

from dasbench.roofline import k3_oks_nms, k4_sampler, k4_sampler_backward
from dasbench.roofline.model_flops import flops

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / f'dasbench/configs/{name}.json').read_text())


def test_sampler_backward_bound_at_train_level0():
    # exp_panoptic's level 0 in training: 4x160x336x256 bf16, 9 x 53760
    ms, by = k4_sampler_backward.backward_bound_ms(4, 160 * 336,
                                                   9 * 53760, 256, 2)
    assert by == 'bytes'
    assert round(ms, 4) == 0.3708


def test_fused_sampler_bound_at_serve_level0():
    ms, by = k4_sampler.sampler_bound_ms(4, 160 * 288, 18432, 256, 2)
    assert by == 'bytes'
    assert round(ms, 4) == 0.0396


@pytest.mark.parametrize('name,samples', [('exp_panoptic', 24),
                                          ('exp_mupots', 36)])
def test_sample_counts_match_the_configured_launches(name, samples):
    cfg = config(name)
    calls = k4_sampler.calls(cfg['model'], 4, (640, 1152),
                             cfg['model']['test_cfg']['nms_pre'])
    assert len(calls) == samples == cfg['launches']['serve']['sampler']
    assert len(calls) == cfg['launches']['train']['sampler_backward']


@pytest.mark.parametrize('name', ['exp_panoptic', 'exp_mupots'])
def test_sampler_backward_is_bytes_bound_at_the_cells_shapes(name):
    """The operations are counted at their most (every corner in bounds
    and of non-zero weight); at these shapes they stay under the bytes'
    time, so the bound does not depend on the offsets."""
    cfg = config(name)
    for c in k4_sampler.calls(cfg['model'], 4, cfg['train_hw'], 512):
        assert k4_sampler_backward.backward_bound_ms(*c, 2)[1] == 'bytes'


def test_nms_bound_counts_pairs_and_terms():
    xy = torch.zeros(1, 3, 2, 2)
    xy[0, 1] += 100.0                       # far from the others
    area = torch.ones(1, 3)
    terms = k3_oks_nms.joint_terms(xy, area, 0.9, 2 * (2 * 0.08) ** 2)
    # pairs (1,0), (2,1) end after their first joint; (2,0) needs both
    assert terms == 4
    ms = k3_oks_nms.nms_bound_ms(1, 3, 2, terms)
    assert ms == pytest.approx(
        max((9 * 4 + 5 * 3) / 67e12, 3 * (2 * 2 * 4 + 6) / 3.35e12) * 1e3)


def test_model_flops_count_the_convolutions():
    cfg = config('exp_panoptic')['model']
    f_eval = flops(cfg, 1, (64, 64), train=False)
    f_train = flops(cfg, 1, (64, 64), train=True)
    # the forward's convolutions and DCN products, and about twice that
    # again in the backward
    assert 2.5 * f_eval < f_train < 3.2 * f_eval
    assert flops(cfg, 2, (64, 64), train=False) == 2 * f_eval
