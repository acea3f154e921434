"""Swin in the port (``das_tpu_torch/models/swin.py``) against the plain
reference (``dasbench/reference/backbones/SwinTransformer.py``) on the CPU
in float32, at a tiny size (embed 32, heads of 32 channels, window 4, two
blocks a stage, so that every stage has a shifted block): its four maps at
image sizes whose stage maps are not whole windows (the padding and the
shift mask both act), the whole tiny DAS on it served and stepped once
against the reference with the bounds of
``dasbench/tests/test_bench_reference.py``'s tiny tests, DropPath's
per-sample draw, the frozen rule, ``train_model`` from on-disk frames, the
window attention's bias index and mask against mmdet's constructions, and
Swin-L's blocks and parameters. The JAX package has no Swin."""

import copy
import json
import os
import re

import pytest
import torch

from das_tpu_torch.apis.inference import init_model
from das_tpu_torch.apis.train import load_pretrained_backbone, train_model
from das_tpu_torch.config import Config
from das_tpu_torch.models import SwinTransformer, build_trainable_model
from das_tpu_torch.models.layers import LayerNorm, Linear
from das_tpu_torch.models.swin import SwinBlock, drop_path
from das_tpu_torch.ops import window_attn
from dasbench import weights
from dasbench.reference import model as ref_model
from dasbench.reference import precision
from dasbench.reference import train as ref_train
from dasbench.reference.backbones import SwinTransformer as ref_swin
from dasbench.tests import tiny
from dasbench.tests.test_bench_reference import \
    test_one_train_step_matches_the_program as step_matches
from dasbench.tests.test_bench_reference import \
    test_serving_outputs_match_the_program as serving_matches
from test_torch_train_api import train_cfg
from test_torch_train_data import write_panoptic

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = [32, 64, 128, 256]


def backbone(frozen=1, rate=0.0) -> dict:
    return dict(type='SwinTransformer', embed_dims=32, depths=[2, 2, 2, 2],
                num_heads=[1, 2, 4, 8], window_size=4, mlp_ratio=4,
                qkv_bias=True, patch_size=4, patch_norm=True,
                pretrain_img_size=224, drop_path_rate=rate,
                out_indices=[0, 1, 2, 3], frozen_stages=frozen)


def repo_config(tmp_path, frozen=1, layers=1, rate=0.0) -> Config:
    """``dasbench.tests.tiny``'s repo config with the tiny Swin in place of
    its MSPN2 and the FPN taking its four widths."""
    text = tiny.TINY_PY.format(remat=True, layers=layers, max_pos=32)
    text, n = re.subn(
        r"backbone=dict\(type='MSPN2'.*?remat=(?:True|False)\),",
        f'backbone={backbone(frozen, rate)!r},', text, flags=re.S)
    assert n == 1
    text = text.replace('in_channels=[16, 16, 16, 16]',
                        f'in_channels={WIDTHS}')
    path = tmp_path / f'tiny_swin_{frozen}_{layers}_{rate}.py'
    path.write_text(text)
    return Config.fromfile(str(path))


def bench_config(layers=1, frozen=1) -> dict:
    cfg = tiny.dasbench_config(layers)
    cfg['model']['backbone'] = backbone(frozen)
    return cfg


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('swin_frames'))
    return root, write_panoptic(root, n=6, edge=())


def seeded(cfg, seed):
    m = cfg['model']
    return weights.make_state(m, cfg['assumed']['weights'], seed, 'cpu')


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('hw', [(72, 104), (64, 96)])
def test_four_maps_match_the_reference(tmp_path, training, hw):
    """The backbone's four maps equal the reference's to float32 rounding,
    in eval and in training (DropPath at rate 0). At 72 x 104 the stage
    maps are 18 x 26, 9 x 13, 5 x 7 and 3 x 4: every stage is padded to
    whole windows of 4 and two merges to even sides; at 64 x 96 the last
    two stages are."""
    cfg, pcfg = bench_config(frozen=-1), repo_config(tmp_path, frozen=-1)
    state = seeded(cfg, 21)
    model = build_trainable_model(pcfg.model, device='cpu')
    model.load_state_dict(state, strict=True)
    ref = ref_model.build(cfg['model'])
    ref.load_state_dict(state, strict=True)
    model.train(training)
    ref.train(training)
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), precision.use(precision.EXACT):
        got, want = model.backbone(x), ref.backbone(x)
    H, W = hw
    sides = [((H + 3) // 4, (W + 3) // 4)]
    for _ in range(3):
        sides.append(((sides[-1][0] + 1) // 2, (sides[-1][1] + 1) // 2))
    assert [tuple(t.shape) for t in got] == [
        (2, c, h, w) for c, (h, w) in zip(WIDTHS, sides)]
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-5


@pytest.mark.parametrize('layers', [1, 2], ids=['ru1', 'ru2'])
def test_serving_and_one_train_step_match_the_reference(tmp_path, layers):
    """The whole tiny DAS on Swin through ``init_model`` and
    ``make_predict_fn`` (dense outputs, the RU's selection, the decode),
    and one step of ``make_trainer``'s ``build_trainable_model``,
    ``make_optimizer`` and ``make_train_step`` (DropPath at rate 0),
    against the reference, by ``test_bench_reference``'s tiny tests and
    bounds."""
    cfg = bench_config(layers)
    pcfg = repo_config(tmp_path, layers=layers)
    serving_matches((None, cfg, pcfg))
    step_matches((None, cfg, pcfg))


def test_drop_path_draws_a_sample_at_a_time():
    """DropPath keeps or zeroes each sample's whole branch, scales what it
    keeps by 1 / (1 - p), keeps about 1 - p of the samples, and is the
    identity in eval and at p = 0; the blocks' rates rise linearly from 0
    to ``drop_path_rate``, each block's attention and FFN sharing one."""
    torch.manual_seed(7)
    x = torch.randn(4000, 3, 5, 8) + 2.0
    y = drop_path(x, 0.3, True)
    kept = (y != 0).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all())
    assert torch.allclose(y[kept], x[kept] / 0.7, rtol=1e-6)
    assert abs(float(kept.float().mean()) - 0.7) < 0.03
    assert drop_path(x, 0.3, False) is x and drop_path(x, 0.0, True) is x
    net = SwinTransformer(**{k: v for k, v in backbone(rate=0.3).items()
                             if k != 'type'})
    blocks = [m for m in net.modules() if isinstance(m, SwinBlock)]
    rates = [(b.attn.drop_path_rate, b.ffn.drop_path_rate) for b in blocks]
    want = torch.linspace(0, 0.3, 8).tolist()
    assert [a for a, _ in rates] == want == [f for _, f in rates]


@pytest.mark.parametrize('frozen', range(-1, 5))
def test_frozen_rule_is_the_references(tmp_path, frozen):
    """For ``frozen_stages`` -1 to 4 the backbone's prefixes are the
    reference's and mmdet's (the patch embedding; ``norm{i}`` and stage i
    for i < K), name exactly the parameters of the modules it keeps in
    eval under ``train()``, and only those."""
    cfg = bench_config(frozen=frozen)
    pcfg = repo_config(tmp_path, frozen=frozen)
    model = build_trainable_model(pcfg.model, device='cpu')
    prefixes = model.backbone.frozen_prefixes()
    assert prefixes == ref_train.frozen_prefixes(cfg['model'])
    want = () if frozen < 0 else ('backbone.patch_embed.',) + tuple(
        p for i in range(min(frozen, 4))
        for p in (f'backbone.norm{i}.', f'backbone.stages.{i}.'))
    assert prefixes == want
    held = {f'backbone.{n}' for n, m in model.backbone.named_modules()
            if any(m is f for f in model.backbone.frozen_modules())}
    named = {k for k, _ in model.named_parameters() if k.startswith(prefixes)}
    assert named == {k for k, _ in model.named_parameters()
                     if any(k.startswith(h + '.') for h in held)}
    assert bool(named) == (frozen >= 0)
    model.train()
    for n, m in model.backbone.named_modules():
        name = f'backbone.{n}.'
        assert m.training == (not name.startswith(prefixes)), name


def test_train_model_takes_two_steps_on_frames(frames, tmp_path):
    """``train_model`` on the tiny Swin DAS from on-disk frames, DropPath
    on: two steps, finite losses, the frozen patch embedding, stage 0 and
    norm0 held still, the rest moved; a pretrained backbone path is
    refused by name."""
    root, ann = frames
    pcfg = repo_config(tmp_path, rate=0.2)
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
    frozen = state.model.backbone.frozen_prefixes('')
    assert frozen == ('patch_embed.', 'norm0.', 'stages.0.')
    for k, v in state.model.backbone.named_parameters():
        same = torch.equal(v, start[f'backbone.{k}'])
        assert same == k.startswith(frozen), k
    with pytest.raises(NotImplementedError, match='load_mspn_pretrained'):
        load_pretrained_backbone(state.model, str(tmp_path / 'w.pth'))


@pytest.mark.parametrize('window', [4, 12])
def test_bias_index_and_mask_are_mmdets(window):
    """The bias table's index is mmdet's ``double_step_seq`` construction
    and the kernel's closed form ``(yi - yj + w - 1) (2w - 1) + (xi - xj +
    w - 1)``; the shift mask is mmdet's ``img_mask`` construction, at grids
    whose last windows are cut by the shift."""
    idx = window_attn.relative_position_index(window)
    ref = ref_swin.WindowMSA(32, 1, window, True).relative_position_index
    assert torch.equal(idx, ref)
    t = torch.arange(window * window)
    y, x = t // window, t % window
    closed = (y[:, None] - y[None, :] + window - 1) * (2 * window - 1) \
        + x[:, None] - x[None, :] + window - 1
    assert torch.equal(idx, closed)
    shift = window // 2
    for grid in [(1, 1), (2, 3), (4, 2)]:
        got = window_attn.shift_mask(grid, window, shift, 'cpu')
        hp, wp = grid[0] * window, grid[1] * window
        img = torch.zeros(1, hp, wp, 1)
        cnt = 0
        cuts = (slice(0, -window), slice(-window, -shift),
                slice(-shift, None))
        for h in cuts:
            for w in cuts:
                img[:, h, w, :] = cnt
                cnt += 1
        mw = ref_swin.window_partition(img, window).view(-1, window ** 2)
        want = mw.unsqueeze(1) - mw.unsqueeze(2)
        want = want.masked_fill(want != 0, -100.0)
        assert torch.equal(got, want)


def test_window_attention_plain_route_and_refusals():
    """On the CPU ``window_attention`` is its plain version; where
    autograd records it refuses, and ``WindowMSA.fused`` keeps such calls
    and CPU tensors off the kernel."""
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn(6, 16, 3 * 64, generator=gen)
    table = torch.randn(49, 2, generator=gen)
    idx = window_attn.relative_position_index(4)
    a = window_attn.window_attention(qkv, table, idx, 2, (2, 3), 2)
    b = window_attn.window_attention_plain(qkv, table, idx, 2, (2, 3), 2)
    assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match='no backward'):
        window_attn.window_attention(qkv.requires_grad_(), table, idx, 2,
                                     (2, 3), 2)
    msa = SwinTransformer(window_size=12, embed_dims=64, depths=[2],
                          num_heads=[2], out_indices=[0]).stages[0] \
        .blocks[0].attn.w_msa
    assert not msa.fused(torch.zeros(1, 144, 192, dtype=torch.bfloat16))


def test_swin_l_blocks_and_parameters():
    """The shipped configuration's backbone: 24 blocks (2, 2, 18, 2) at
    192 to 1536 channels, 6 to 48 heads of 32 channels, windows of 12,
    195.2 M parameters (the 197 M of the classifier less its head), 56
    LayerNorms (two a block, the patch embedding's,
    three mergings', four outputs'), 99 linear maps, the program's state
    keys and shapes the reference's, four maps for the FPN's
    [192, 384, 768, 1536]; all on meta."""
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', 'das',
                                       'exp_panoptic_swinl.py'))
    b = dict(cfg.model.backbone)
    with torch.device('meta'):
        net = SwinTransformer(**{k: v for k, v in b.items() if k != 'type'})
        ref = ref_swin.build(dict(b, out_indices=list(b['out_indices'])))
    blocks = [m for m in net.modules() if isinstance(m, SwinBlock)]
    assert len(blocks) == 24
    assert [len(s.blocks) for s in net.stages] == [2, 2, 18, 2]
    assert all(blk.attn.w_msa.heads * 32 == blk.norm1.weight.numel()
               and blk.attn.w_msa.window == 12 for blk in blocks)
    assert sum(isinstance(m, LayerNorm) for m in net.modules()) == \
        2 * 24 + 3 + 1 + 4
    assert sum(isinstance(m, Linear) for m in net.modules()) == 4 * 24 + 3
    n = sum(p.numel() for p in net.parameters())
    assert round(n / 1e6, 1) == 195.2
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert net.out_channels == list(cfg.model.neck.in_channels)
    model, _ = init_model(cfg, device='meta')
    assert isinstance(model.backbone, SwinTransformer)
