"""The Swin-L configuration (``exp_panoptic_swinl``): its JSON is the
repo config (the head's and recipe's keys, the backbone's by
``REPO_KEYS``, the FPN's inputs), the program's and the reference's
module trees at Swin-L's published widths are equal key for key and
shape for shape, the seeded state finds every LayerNorm as a norm and
holds no bias index, its FLOPs are those of the cell's bucket, and the
window attention's roofline counts the cell's (window, head) pairs."""

import json
import math
from pathlib import Path

import torch

from dasbench import weights
from dasbench.reference import backbones
from dasbench.reference import model as ref_model
from dasbench.reference import train as ref_train
from dasbench.roofline import PEAK_BYTES
from dasbench.roofline import window_attention as roof
from dasbench.roofline.backbone_flops import flops
from dasbench.tests.test_bench_reference import configs
from dasbench.tests.test_bench_reference import \
    test_backbone_is_the_repo_backbone as backbone_is_the_repo_backbone
from dasbench.tests.test_bench_reference import \
    test_configuration_is_the_repo_config as configuration_is_the_repo_config

REPO = Path(__file__).resolve().parents[2]
NAME = 'exp_panoptic_swinl'
CELL = 'panoptic_swinl-serve-b4'


def test_json_is_the_repo_config():
    """Head, recipe, buckets and the whole module tree at Swin-L's
    widths, program against reference, key for key and shape for shape
    on meta."""
    configuration_is_the_repo_config(NAME)


def test_backbone_keys_and_fpn_inputs_are_the_repo_configs():
    backbone_is_the_repo_backbone(NAME)
    cfg, pcfg = configs(NAME)
    b = cfg['model']['backbone']
    assert b['type'] == 'SwinTransformer'
    assert (b['embed_dims'], b['depths'], b['num_heads'], b['window_size'],
            b['mlp_ratio'], b['patch_size']) == (192, [2, 2, 18, 2],
                                                 [6, 12, 24, 48], 12, 4, 4)
    assert backbones.find(b).out_channels(b) == [192, 384, 768, 1536] == \
        list(pcfg.model.neck.in_channels)
    assert cfg['reduced'] == [] and pcfg.model.get('pretrained') is None
    assert ref_train.frozen_prefixes(cfg['model']) == (
        'backbone.patch_embed.', 'backbone.norm0.', 'backbone.stages.0.')


def test_seeded_state_has_unit_layernorms_and_no_index():
    """Every LayerNorm of the reference (two a block, the patch
    embedding's, the mergings', the outputs': 56) is found as a norm:
    weight 1, bias 0; the linear maps and bias tables are drawn
    LeCun-normal; the bias index is no leaf of the state."""
    cfg, _ = configs(NAME)
    table = weights.leaves(cfg['model'], cfg['assumed']['weights'])
    keys = {k for k, *_ in table}
    assert not any('relative_position_index' in k for k in keys)
    model = ref_model.build(cfg['model'], 'meta')
    norms = [n for n, m in model.backbone.named_modules()
             if isinstance(m, ref_model.GroupNorm)]
    assert len(norms) == 56
    rows = {k: (s, std, const) for k, s, std, const in table}
    for n in norms:
        assert rows[f'backbone.{n}.weight'][2] == 1.0, n
        assert rows[f'backbone.{n}.bias'][2] == 0.0, n
    qkv = rows['backbone.stages.2.blocks.5.attn.w_msa.qkv.weight']
    assert qkv[0] == (2304, 768) and math.isclose(qkv[1], 768 ** -0.5)
    tb = rows['backbone.stages.3.blocks.1.attn.w_msa.'
              'relative_position_bias_table']
    assert tb[0] == (529, 48) and math.isclose(tb[1], 48 ** -0.5)
    state = weights.make_state(
        dict(cfg['model'], backbone=dict(
            cfg['model']['backbone'], embed_dims=32, depths=[2, 2, 2, 2],
            num_heads=[1, 2, 4, 8], window_size=4)),
        cfg['assumed']['weights'], 3, 'cpu')
    assert bool((state['backbone.stages.1.blocks.1.norm2.weight'] == 1)
                .all())
    assert float(state['backbone.stages.1.blocks.1.attn.w_msa.'
                       'relative_position_bias_table'].std()) > 0.3


def test_backbone_flops_at_the_cells_bucket():
    """Swin-L's forward FLOPs for a B=4 request at the 640x1152 serving
    bucket (4.407 TFLOP: the patch embedding, 24 blocks' four linear maps
    and two attention products a window and head, three mergings)."""
    cfg, _ = configs(NAME)
    b = cfg['model']['backbone']
    serve = flops(b, 4, (640, 1152))
    assert round(serve / 1e12, 3) == 4.407
    assert flops(b, 8, (640, 1152)) == 2 * serve
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    cells = [w for w in bench['workloads'] if w['config'] == NAME]
    assert [w['name'] for w in cells] == [CELL]


def test_window_attention_roofline_at_the_cells_pairs():
    """67,968 (window, head) pairs a B=4 640x1152 request (336, 84, 24
    and 6 windows an image at the four stages, 6 to 48 heads, 2, 2, 18
    and 2 blocks); 4 * 144^2 * 32 operations and 4 * 144 * 32 bf16
    elements a pair, a 529 x heads f32 table a layer; the bound is the
    bytes' at 3.35 TB/s, about 0.75 ms."""
    cfg, _ = configs(NAME)
    b = cfg['model']['backbone']
    layers = roof.layers(b, 4, (640, 1152))
    assert len(layers) == 24
    assert sorted({(n // h, h) for n, _, _, h in layers}) == [
        (4 * 6, 48), (4 * 24, 24), (4 * 84, 12), (4 * 336, 6)]
    n = roof.pairs(b, 4, (640, 1152))
    assert n == 16128 + 8064 + 41472 + 2304 == 67968
    ops, nbytes = roof.request_work(b, 4, (640, 1152))
    tables = 529 * 4 * sum(h for *_, h in layers)
    assert ops == 4 * 144 ** 2 * 32 * n
    assert nbytes == 4 * 144 * 32 * 2 * n + tables
    assert math.isclose(roof.request_bound_ms(b, 4, (640, 1152)),
                        nbytes / PEAK_BYTES * 1e3)
    assert 0.74 < roof.request_bound_ms(b, 4, (640, 1152)) < 0.76
    assert roof.pairs(b, 1, (640, 1152)) * 4 == n
