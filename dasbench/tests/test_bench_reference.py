"""The plain reference computes the program's model: at tiny sizes on the
CPU, in float32, the reference's serving outputs and training step
against das_tpu_torch's plain CPU path; each benchmark configuration is
the repo configuration it names, as the program builds it, its backbone
by the keys its type compares; and the backbone's frozen rule is the
program's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from das_tpu_torch.apis.inference import init_model, make_predict_fn
from das_tpu_torch.config import Config
from das_tpu_torch.datasets.loader import train_pad_hw_from_cfg
from das_tpu_torch.models import build_model
from das_tpu_torch.parallel import TrainState, mspn_frozen_prefixes
from dasbench import check, weights
from dasbench.drivers import train as train_driver
from dasbench.reference import model as ref_model
from dasbench.reference import backbones, precision
from dasbench.reference import train as ref_train
from dasbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope='module', params=[1, 2], ids=['ru1', 'ru2'])
def tiny_root(request, tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path_factory.mktemp('ref'), request.param)
    cfg = json.loads((root / 'dasbench/configs/tiny.json').read_text())
    return root, cfg, Config.fromfile(str(root / 'tiny_repo_config.py'))


def test_serving_outputs_match_the_program(tiny_root):
    root, cfg, pcfg = tiny_root
    m = cfg['model']
    model, _ = init_model(pcfg, device='cpu')
    state = weights.make_state(m, cfg['assumed']['weights'], 11, 'cpu')
    model.load_state_dict(state, strict=True)
    img = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    picked = []
    hook = model.bbox_head.recursive_update_branch.register_forward_pre_hook(
        lambda mod, args: picked.append(args[2]))
    with torch.no_grad():
        cls, pose, ctr, _ = model(img)
        hook.remove()
        predict = make_predict_fn(model, dict(pcfg.model.test_cfg), tiny.J,
                                  m['strides'], device='cpu')
        decoded = predict(img, torch.ones(2, 2))
        with precision.use(precision.EXACT):
            ref = ref_model.build(m)
            ref.load_state_dict(state, strict=True)
            levels = ref_model.eval_outputs(ref.eval()(img), m)
    sel = check.selection_masks(picked, (cls, pose, ctr))
    assert any(s is not None for s in sel)  # a sparse level
    assert check.select_gap(sel, levels, m) == 0.0
    assert check.head_gap((cls, pose, ctr), levels, m, sel) < 2e-5
    assert check.head_gap((cls, pose, ctr), levels, m) < 2e-5
    people = check.ref_decode.decode(
        [dict(cls=a, ctr=b, pose=p) for a, p, b in zip(cls, pose, ctr)],
        m['strides'], torch.ones(2, 2), tiny.J, m['test_cfg'])
    for i, ref_p in enumerate(people):
        got = decoded['poses'][i][decoded['valid'][i]].numpy()
        assert check.match_people(got, ref_p['poses'].numpy()) == (
            0, pytest.approx(0.0, abs=1e-3))


def test_one_train_step_matches_the_program(tiny_root):
    root, cfg, pcfg = tiny_root
    m = cfg['model']
    model, tx_init, step, max_pos = train_driver.make_trainer(
        pcfg, torch.float32, 'cpu', 2, cfg['train_hw'])
    assert max_pos == cfg['optimizer']['max_pos_per_image'] * 2
    model.load_state_dict(weights.make_state(
        m, cfg['assumed']['weights'], 12, 'cpu'), strict=True)
    state = TrainState(0, model, tx_init(dict(model.named_parameters())))
    batch = train_driver.synthetic_batch(
        2, *cfg['train_hw'], tiny.J, m['root_idx'], 3,
        torch.Generator().manual_seed(4), 'cpu')
    state, metrics = step(state, batch)
    prog = dict(losses=[{k: float(v) for k, v in metrics.items()
                         if k.startswith('loss_')}],
                bn1={k: v.clone() for k, v in model.named_buffers()
                     if 'running' in k},
                grad_norm=float(metrics['grad_norm']),
                m1={k: v.clone() for k, v in
                    state.opt_state['momentum'].items()},
                p3={k: v.detach().clone()
                    for k, v in model.named_parameters()})
    ref = check.reference_steps(cfg, 12, [batch], 'cpu')
    nums = check.train_numbers(prog, ref, check.initial_params(cfg, 12,
                                                               'cpu'))
    # the losses agree to float32 rounding; a random tiny model amplifies
    # rounding into single leaves of its gradient by a few percent
    assert nums['loss_gap'] < 1e-4
    assert nums['bn_gap'] < tiny.LIMITS['train']['bn_gap']
    assert nums['change_gap_median'] < \
        tiny.LIMITS['train']['change_gap_median']
    assert nums['grad_gap'] < 0.05 and nums['change_gap'] < 0.05


def configs(name):
    cfg = json.loads((REPO / f'dasbench/configs/{name}.json').read_text())
    return cfg, Config.fromfile(str(REPO / cfg['repo_config']))


def plain(v):
    return [plain(x) for x in v] if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize('name', ['exp_panoptic', 'exp_mupots'])
def test_backbone_is_the_repo_backbone(name):
    """The keys the backbone's type compares, and its maps' channels as
    the repo's FPN takes them."""
    cfg, pcfg = configs(name)
    b, pb = cfg['model']['backbone'], pcfg.model.backbone
    kind = backbones.find(b)
    assert b['type'] == pb['type']
    assert kind.REPO_KEYS
    for k in kind.REPO_KEYS:
        assert plain(b[k]) == plain(pb[k]), k
    assert kind.out_channels(b) == plain(pcfg.model.neck.in_channels)


@pytest.mark.parametrize('name', ['exp_panoptic', 'exp_mupots'])
def test_configuration_is_the_repo_config(name):
    """The head's and the recipe's keys, and the whole module tree."""
    cfg, pcfg = configs(name)
    m, h = cfg['model'], pcfg.model.bbox_head
    for k in ('num_joints', 'root_idx', 'depth_factor', 'z_norm',
              'center_sample_radius', 'stacked_convs', 'feat_channels'):
        assert m[k] == h[k], k
    assert [list(r) for r in h['regress_ranges']] == m['regress_ranges']
    assert list(h['strides']) == m['strides']
    ru = h['recursive_update']
    for k in ('num_heads', 'num_layers', 'dim', 'prev_loss'):
        assert m['ru'][k] == ru[k]
    for k, v in m['test_cfg'].items():
        assert pcfg.model.test_cfg[k] == v
    assert pcfg.model.train_cfg['code_weight'] == m['code_weight']
    assert dict(pcfg.img_norm_cfg) == m['img_norm']
    opt = pcfg.optimizer
    assert (opt['lr'], opt['momentum'], opt['weight_decay']) == tuple(
        cfg['optimizer'][k] for k in ('lr', 'momentum', 'weight_decay'))
    assert pcfg.optimizer_config['grad_clip']['max_norm'] == \
        cfg['optimizer']['grad_clip']
    pipeline = pcfg.get('train_pipeline') or pcfg.get('train_pipeline_muco')
    assert list(train_pad_hw_from_cfg(pipeline)) == cfg['train_hw']
    test_scale = [t['img_scale'] for t in pcfg.data.test.pipeline
                  if 'img_scale' in t][0]
    assert list(test_scale) == cfg['test_scale']
    # the reference's module tree is the program's, key for key
    prog = build_model(dict(pcfg.model), device='meta').state_dict()
    ref = ref_model.build(m, 'meta').state_dict()
    assert {k: tuple(v.shape) for k, v in prog.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_weights_are_made_from_the_seed():
    cfg = json.loads((REPO / 'dasbench/configs/exp_panoptic.json')
                     .read_text())
    small = tiny.dasbench_config()
    a = weights.make_state(small['model'], cfg['assumed']['weights'], 5,
                           'cpu')
    b = weights.make_state(small['model'], cfg['assumed']['weights'], 5,
                           'cpu')
    c = weights.make_state(small['model'], cfg['assumed']['weights'], 6,
                           'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    off = [k for k in a if k.endswith('conv_offset.weight')]
    assert off and all(not torch.equal(a[k], c[k]) for k in off)
    assert all(float(a[k].abs().max()) > 0 for k in off)
    assert np.isclose(float(a['bbox_head.conv_cls.bias'][0]), -2.0)


@pytest.mark.parametrize('stages', range(-1, 5))
def test_frozen_rule_is_the_programs(stages):
    """The reference's frozen prefixes are the program's own MSPN2 rule,
    and the train driver hands the program's optimizer the tuple the
    reference takes from the repo configuration's backbone."""
    cfg, pcfg = configs('exp_panoptic')
    b = dict(cfg['model']['backbone'], frozen_stages=stages)
    pcfg.model.backbone.frozen_stages = stages
    assert ref_train.frozen_prefixes(dict(backbone=b)) == \
        ref_train.frozen_prefixes(pcfg.model) == mspn_frozen_prefixes(stages)
