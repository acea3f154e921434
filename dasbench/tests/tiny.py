"""A tiny copy of the benchmark for the CPU tests: a narrow DAS (the
shipped structure at a few channels), its repo-style config, its dasbench
configuration, and a checkout root holding them with BENCHMARK.json."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
J = 15
LIMITS = {"serve": {"pre_gap": 1e-4, "head_gap": 1e-3, "select_gap": 0.05,
                    "decode_gap_px": 1e-3},
          "train": {"bn_gap": 1e-3, "change_gap_median": 0.05,
                    "sampler_bwd_gap": 1e-4}}

TINY_PY = f"""
model = dict(
    type='DAS',
    backbone=dict(type='MSPN2', unit_channels=16, num_stages=2, num_units=4,
                  num_blocks=[1, 1, 1, 1], res_top_channels=8,
                  norm_cfg=dict(type='BN'), frozen_stages=1, remat={{remat}}),
    neck=dict(type='FPN', in_channels=[16, 16, 16, 16], out_channels=32,
              norm_cfg=dict(type='BN'), num_outs=4),
    bbox_head=dict(
        type='DASHead', num_classes=1, in_channels=32, stacked_convs=2,
        feat_channels=32, strides=[8, 16, 32, 64], center_sample_radius=1.5,
        num_joints={J}, cls_branch=(32,), reg_branch=((32,), (32,), (32,),
        (32,)), centerness_branch=(32,), centerness_on_reg=True,
        conv_bias=True, dcn_on_last_conv=True, remat={{remat}},
        recursive_update=dict(prev_loss=True, num_heads=4, in_channels=32,
                              feat_channels=32, num_layers={{layers}},
                              dim=3),
        regress_ranges=((-1, 24), (24, 48), (48, 96), (96, 1e8)),
        depth_factor=20, z_norm=50, root_idx=2),
    train_cfg=dict(code_weight=[1.0, 1.0, 1.0] + [2.0] * {J} * 6,
                   sparse_refine=True, max_pos={{max_pos}}),
    test_cfg=dict(nms_pre=40, nms_post=20, nms_thr=0.9, score_thr=0.07,
                  sparse_refine=True))
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
optimizer = dict(type='SGD', lr=0.002, momentum=0.9, weight_decay=0.0001)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy='step', warmup='linear', warmup_iters=250,
                 warmup_ratio=1.0 / 3, step=[16, 20])
"""


def dasbench_config(layers: int = 1, batch: int = 2) -> dict:
    cfg = json.loads((REPO / 'dasbench/configs/exp_panoptic.json')
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg['name'] = 'tiny'
    cfg['repo_config'] = 'tiny_repo_config.py'
    m = cfg['model']
    m['backbone'].update(unit_channels=16, num_blocks=[1, 1, 1, 1],
                         res_top_channels=8)
    m.update(feat_channels=32, cls_branch=[32], reg_branch=[[32]] * 4,
             centerness_branch=[32],
             regress_ranges=[[-1, 24], [24, 48], [48, 96], [96, 1e8]])
    m['ru']['num_layers'] = layers
    m['test_cfg'].update(nms_pre=40, nms_post=20)
    cfg['test_scale'] = [96, 64]
    cfg['train_hw'] = [64, 96]
    cfg['optimizer']['max_pos_per_image'] = 16
    cfg['launches'] = {k: {n: 0 for n in v}
                       for k, v in cfg['launches'].items()}
    # float32 on the CPU: the program's plain path and the reference
    # compute the same function, so the limits are those of rounding
    cfg['compute_dtype'] = 'float32'
    cfg['limits'] = LIMITS
    return cfg


def make_root(tmp: Path, layers: int = 1, remat: bool = True) -> Path:
    """A checkout root: dasbench copied, the tiny configs, and a
    BENCHMARK.json with one serve and one train cell on them."""
    root = tmp / 'checkout'
    shutil.copytree(REPO / 'dasbench', root / 'dasbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (root / 'tiny_repo_config.py').write_text(TINY_PY.format(
        remat=remat, layers=layers, max_pos=16 * 2))
    (root / 'dasbench/configs/tiny.json').write_text(
        json.dumps(dasbench_config(layers)))
    (root / 'dasbench/traffic/tiny_serve.json').write_text(json.dumps(dict(
        driver='serve', why='tiny', params=dict(
            batch=2, frame_hw=[120, 160], pool=4, warmup=1, sample=2, rate=8,
            profile_requests=1))))
    (root / 'dasbench/traffic/tiny_train.json').write_text(json.dumps(dict(
        driver='train', why='tiny', params=dict(
            batch=2, pool=4, people=3, first_steps=3, profile_steps=1))))
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    bench['configs'] = [dict(name='tiny', source='tiny', reduced=[],
                             file='dasbench/configs/tiny.json', why='tiny')]
    bench['workloads'] = [
        dict(name='tiny-serve', config='tiny', traffic='tiny_serve',
             chips=1, why='tiny'),
        dict(name='tiny-train', config='tiny', traffic='tiny_train',
             chips=1, why='tiny')]
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            m['workloads'] = ['tiny-serve' if 'serve' in w else 'tiny-train'
                              for w in m['workloads']][:1]
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root
