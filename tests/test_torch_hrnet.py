"""HRNet in the port (``das_tpu_torch/models/hrnet.py``) against the plain
reference (``dasbench/reference/backbones/HRNet.py``) on the CPU in
float32, at a tiny size (branch widths 4/8/16/32, one block a branch,
one module a stage, so that every kind of fusion path occurs): its four
maps, the whole tiny DAS on it served and stepped once against the
reference with the bounds of ``dasbench/tests/test_bench_reference.py``'s
tiny tests, remat on against off bit for bit, the frozen rule, and
``train_model`` from on-disk frames. The JAX package has no HRNet."""

import copy
import json
import os
import re

import pytest
import torch

from das_tpu_torch.apis.inference import init_model
from das_tpu_torch.apis.train import load_pretrained_backbone, train_model
from das_tpu_torch.config import Config
from das_tpu_torch.models import HRNet, build_trainable_model
from das_tpu_torch.models.layers import BatchNorm
from dasbench import weights
from dasbench.drivers import train as train_driver
from dasbench.reference import model as ref_model
from dasbench.reference import precision
from dasbench.reference import train as ref_train
from dasbench.tests import tiny
from dasbench.tests.test_bench_reference import \
    test_one_train_step_matches_the_program as step_matches
from dasbench.tests.test_bench_reference import \
    test_serving_outputs_match_the_program as serving_matches
from test_torch_train_api import train_cfg
from test_torch_train_data import write_panoptic

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def stage(n, block='BASIC'):
    return dict(num_modules=1, num_branches=n, block=block,
                num_blocks=[1] * n, num_channels=[4, 8, 16, 32][:n])


EXTRA = dict(stage1=stage(1, 'BOTTLENECK'), stage2=stage(2),
             stage3=stage(3), stage4=stage(4))
WIDTHS = [4, 8, 16, 32]


def repo_config(tmp_path, remat=True, frozen=1, layers=1) -> Config:
    """``dasbench.tests.tiny``'s repo config with the tiny HRNet in place
    of its MSPN2 and the FPN taking its four widths."""
    text = tiny.TINY_PY.format(remat=remat, layers=layers, max_pos=32)
    text, n = re.subn(
        r"backbone=dict\(type='MSPN2'.*?remat=(?:True|False)\),",
        f"backbone=dict(type='HRNet', extra={EXTRA!r}, norm_cfg=dict("
        f"type='BN'), frozen_stages={frozen}, remat={remat}),", text,
        flags=re.S)
    assert n == 1
    text = text.replace('in_channels=[16, 16, 16, 16]', f'in_channels='
                        f'{WIDTHS}')
    path = tmp_path / f'tiny_hrnet_{remat}_{frozen}_{layers}.py'
    path.write_text(text)
    return Config.fromfile(str(path))


def bench_config(layers=1, frozen=1) -> dict:
    cfg = tiny.dasbench_config(layers)
    cfg['model']['backbone'] = dict(type='HRNet', extra=copy.deepcopy(EXTRA),
                                    frozen_stages=frozen)
    return cfg


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('hrnet_frames'))
    return root, write_panoptic(root, n=6, edge=())


def seeded(cfg, seed):
    m = cfg['model']
    return weights.make_state(m, cfg['assumed']['weights'], seed, 'cpu')


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_four_maps_match_the_reference(tmp_path, training):
    """The backbone's four maps (strides 4 to 32, the FPN's widths) equal
    the reference's to float32 rounding, with running statistics (eval)
    and with the batch's (train)."""
    cfg, pcfg = bench_config(frozen=-1), repo_config(tmp_path, frozen=-1)
    state = seeded(cfg, 21)
    model = build_trainable_model(pcfg.model, device='cpu')
    model.load_state_dict(state, strict=True)
    ref = ref_model.build(cfg['model'])
    ref.load_state_dict(state, strict=True)
    model.train(training)
    ref.train(training)
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), precision.use(precision.EXACT):
        got, want = model.backbone(x), ref.backbone(x)
    assert [tuple(t.shape) for t in got] == [
        (2, c, 64 // s, 96 // s) for c, s in zip(WIDTHS, (4, 8, 16, 32))]
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-5


@pytest.mark.parametrize('layers', [1, 2], ids=['ru1', 'ru2'])
def test_serving_and_one_train_step_match_the_reference(tmp_path, layers):
    """The whole tiny DAS on HRNet through ``init_model`` and
    ``make_predict_fn`` (dense outputs, the RU's selection, the decode),
    and one step of ``make_trainer``'s ``build_trainable_model``,
    ``make_optimizer`` and ``make_train_step``, against the reference, by
    ``test_bench_reference``'s tiny tests and bounds."""
    cfg = bench_config(layers)
    pcfg = repo_config(tmp_path, layers=layers)
    serving_matches((None, cfg, pcfg))
    step_matches((None, cfg, pcfg))


def step_state(pcfg, cfg, seed=12):
    """The model, loss terms and momentum after one program step."""
    model, tx_init, step, _ = train_driver.make_trainer(
        pcfg, torch.float32, 'cpu', 2, cfg['train_hw'])
    model.load_state_dict(seeded(cfg, seed), strict=True)
    from das_tpu_torch.parallel import TrainState
    state = TrainState(0, model, tx_init(dict(model.named_parameters())))
    batch = train_driver.synthetic_batch(
        2, *cfg['train_hw'], tiny.J, cfg['model']['root_idx'], 3,
        torch.Generator().manual_seed(4), 'cpu')
    state, metrics = step(state, batch)
    return model, metrics, state.opt_state['momentum']


def test_remat_on_and_off_agree_bit_for_bit(tmp_path):
    """The backbone's remat regions change no bit of a train step: loss
    terms, gradient norm, momentum (the clipped gradient), parameters
    and running statistics after it."""
    cfg = bench_config()
    on = step_state(repo_config(tmp_path, remat=True), cfg)
    off = step_state(repo_config(tmp_path, remat=False), cfg)
    assert on[0].backbone.remat and not off[0].backbone.remat
    for k, v in off[1].items():
        assert torch.equal(on[1][k], v), k
    for k, v in off[2].items():
        assert torch.equal(on[2][k], v), k
    a, b = on[0].state_dict(), off[0].state_dict()
    for k, v in b.items():
        assert torch.equal(a[k], v), k


@pytest.mark.parametrize('frozen', range(-1, 5))
def test_frozen_rule_is_the_references(tmp_path, frozen):
    """For ``frozen_stages`` -1 to 4 the backbone's prefixes are the
    reference's, name exactly the parameters of the modules it keeps in
    eval, and those modules' running statistics do not move in a train
    forward while every other BatchNorm's do."""
    cfg = bench_config(frozen=frozen)
    pcfg = repo_config(tmp_path, frozen=frozen)
    model = build_trainable_model(pcfg.model, device='cpu')
    prefixes = model.backbone.frozen_prefixes()
    assert prefixes == ref_train.frozen_prefixes(cfg['model'])
    held = {f'backbone.{n}' for n, m in model.backbone.named_modules()
            if any(m is f for f in model.backbone.frozen_modules())}
    named = {k for k, _ in model.named_parameters() if k.startswith(prefixes)}
    assert named == {k for k, _ in model.named_parameters()
                     if any(k.startswith(h + '.') for h in held)}
    assert bool(named) == (frozen >= 0)
    ref = ref_model.build(cfg['model'], 'meta').train()
    ref_eval = {n for n, m in ref.named_modules()
                if isinstance(m, ref_model.BatchNorm) and not m.training}
    model.load_state_dict(seeded(cfg, 5), strict=True)
    before = {k: v.clone() for k, v in model.named_buffers()}
    model.backbone(torch.randn(2, 3, 64, 96))
    for n, m in model.backbone.named_modules():
        if not isinstance(m, BatchNorm):
            continue
        name = f'backbone.{n}'
        moved = not torch.equal(m.running_mean,
                                before[f'{name}.running_mean'])
        assert moved == m.training == (name not in ref_eval), name
        assert m.training == (not (name + '.').startswith(prefixes)), name


def test_train_model_takes_two_steps_on_frames(frames, tmp_path):
    """``train_model`` on the tiny HRNet DAS from on-disk frames: two
    steps, finite losses, the frozen stem and stage 1 held still, the
    rest moved; a pretrained backbone path is refused by name."""
    root, ann = frames
    pcfg = repo_config(tmp_path)
    d = train_cfg(root, ann)
    d['model'] = copy.deepcopy(dict(pcfg.model))
    cfg = Config(d)
    work = str(tmp_path / 'work')
    start = build_trainable_model(cfg.model, device='cpu').state_dict()
    state = train_model(cfg, work_dir=work, max_steps=2, log_interval=1,
                        dtype=torch.float32, device='cpu')
    assert state.step == 2
    lines = [json.loads(x) for f in os.listdir(work)
             if f.endswith('.metrics.jsonl')
             for x in open(os.path.join(work, f)).read().splitlines()]
    assert [m['step'] for m in lines] == [1, 2]
    assert all(torch.isfinite(torch.tensor(m['loss'])) for m in lines)
    end = state.model.state_dict()
    frozen = state.model.backbone.frozen_prefixes('')
    for k, v in state.model.backbone.named_parameters():
        same = torch.equal(v, start[f'backbone.{k}'])
        assert same == k.startswith(frozen), k
    with pytest.raises(NotImplementedError, match='load_mspn_pretrained'):
        load_pretrained_backbone(state.model, str(tmp_path / 'w.pth'))
    assert set(end) == set(start)


def test_hrnet_w48_module_counts(tmp_path):
    """The shipped configuration's backbone: 305 convolutions, 305
    BatchNorms, 65.3 M parameters, four maps for the FPN's
    [48, 96, 192, 384]; ``norm_eval`` keeps every BatchNorm in eval
    under ``train()``, as mmdet's."""
    cfg = Config.fromfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'configs', 'das', 'exp_panoptic_hrnet48.py'))
    net = HRNet(**{k: v for k, v in cfg.model.backbone.items()
                   if k != 'type'})
    mods = list(net.modules())
    assert sum(isinstance(m, torch.nn.Conv2d) for m in mods) == 305
    assert sum(isinstance(m, BatchNorm) for m in mods) == 305
    assert round(sum(p.numel() for p in net.parameters()) / 1e6, 1) == 65.3
    assert net.out_channels == list(cfg.model.neck.in_channels)
    net.norm_eval = True
    assert not any(m.training for m in net.train().modules()
                   if isinstance(m, BatchNorm))
    model, _ = init_model(cfg, device='meta')
    assert isinstance(model.backbone, HRNet)
