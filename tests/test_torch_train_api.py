"""The port's training entry point against the JAX package's, on the CPU in
fp32 (TF32 off): the TensorBoard writer and the metric logger, the
checkpoint manager, the ``.pth`` bridge both ways (``save_torch_checkpoint``
read by JAX's ``load_torch_checkpoint``, ``load_mspn_pretrained``), a whole
``train_model`` run of tests/test_e2e.py's TINY15 from a ``.pth`` that the
JAX bridge wrote, held step for step against JAX's ``make_train_step`` on
the same loader batches (one JAX compile), a resume that continues bit for
bit, and ``python -m das_tpu_torch.tools.train`` as a subprocess.

The data is tests/test_torch_train_data.py's synthetic Panoptic-format
JPEGs through the shipped random train pipeline at 96x128.
"""

import copy
import glob
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.checkpoint import torch_bridge as jbridge  # noqa: E402
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu.parallel import train_step as jts  # noqa: E402
from das_tpu.utils import logging as jlogging  # noqa: E402
from das_tpu.utils import tb_events as jtb  # noqa: E402
from das_tpu_torch.apis import prefetch_to_device, train_model  # noqa
from das_tpu_torch.apis.train import device_normalize  # noqa: E402
from das_tpu_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                      load_checkpoint_report,
                                      load_mspn_pretrained,
                                      save_torch_checkpoint,
                                      state_dict_from_flax)
from das_tpu_torch.config import Config  # noqa: E402
from das_tpu_torch.datasets import build_dataset  # noqa: E402
from das_tpu_torch.datasets.loader import TrainLoader  # noqa: E402
from das_tpu_torch.models import build_trainable_model  # noqa: E402
from das_tpu_torch.parallel import (TrainState, make_lr_fn,  # noqa: E402
                                    make_optimizer, make_train_step,
                                    mspn_frozen_prefixes)
from das_tpu_torch.utils import logging as plogging  # noqa: E402
from das_tpu_torch.utils import tb_events as ptb  # noqa: E402
from test_e2e import TINY15  # noqa: E402
from test_torch_model import _seeded_tree, _tree_shapes  # noqa: E402
from test_torch_train_data import (IMG_NORM, SHIPPED,  # noqa: E402
                                   train_pipeline, write_panoptic)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = 15
B = 2


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The tiny steps run thousands of small ops: on a loaded host (the
    test workers share the cores) each op's thread barrier waits for
    descheduled threads, so they run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jtiny():
    """TINY15's JAX model and its variable tree's shapes."""
    jmodel = jbuild_model(TINY15)
    return jmodel, _tree_shapes(jmodel)


# ------------------------------------------------------------- logging

def test_event_writer_bytes_equal_jax(tmp_path, monkeypatch):
    """The same scalars at the same wall time: the port's event file is the
    JAX writer's byte for byte (file name included); crc32c's check
    value."""
    monkeypatch.setattr(time, 'time', lambda: 1760000000.25)
    files = []
    for mod, sub in ((ptb, 'port'), (jtb, 'jax')):
        w = mod.EventWriter(str(tmp_path / sub))
        w.add_scalars(3, {'train/loss': 3.5, 'train/lr': 2e-3})
        w.add_scalars(4, {'train/loss': -1.25, 'train/grad_norm': 1e5})
        w.add_scalars(70000, {'train/loss': 0.0})
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], 'rb') as a, open(files[1], 'rb') as b:
        assert a.read() == b.read()
    assert ptb.crc32c(b'123456789') == 0xE3069283


class Counted:
    """A metric that counts its conversions to float (a host sync, for a
    tensor on the card)."""

    def __init__(self, v):
        self.v, self.n = v, 0

    def __float__(self):
        self.n += 1
        return self.v


def test_metric_logger_converts_only_on_its_interval(tmp_path, monkeypatch):
    """MetricLogger.log turns the metrics into floats on its interval only,
    and writes the JAX logger's jsonl lines but for ``img_per_s``: the
    port's is the images since the previous logged line over the host
    time since that line (whose floats waited for the card), where the
    JAX logger divides one step's images by the time it is given; the
    logger is 'das_tpu_torch'."""
    ms = [dict(loss=Counted(2.5 + s), grad_norm=Counted(10.0 * s))
          for s in range(1, 6)]
    # the host clock when the logger is made, then at the lines of steps
    # 2 and 4
    clock = iter([10.0, 11.0, 14.5])
    monkeypatch.setattr(plogging, 'time', types.SimpleNamespace(
        strftime=time.strftime, perf_counter=lambda: next(clock)))
    lines = []
    for mod, sub in ((plogging, 'port'), (jlogging, 'jax')):
        log = mod.MetricLogger(str(tmp_path / sub), interval=2,
                               tensorboard=False)
        for s, m in enumerate(ms, start=1):
            if mod is jlogging:
                log.log(s, {k: v.v for k, v in m.items()}, 4, 0.5)
            else:
                log.log(s, m, 4)
        log.jsonl.flush()
        lines.append([json.loads(x) for x in
                      open(log.jsonl.name).read().splitlines()])
    rates = [[r.pop('img_per_s') for r in rows] for rows in lines]
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert rates == [[4 * 2 / 1.0, 4 * 2 / 3.5], [4 / 0.5, 4 / 0.5]]
    assert [m['loss'].n for m in ms] == [0, 1, 0, 1, 0]
    assert plogging.get_root_logger().name == 'das_tpu_torch'


# ---------------------------------------------------------- checkpoints

def _state(seed):
    """A tiny trainable model and its optimizer state, the momentum seeded
    non-zero."""
    model = build_trainable_model(TINY15, device='cpu', seed=seed)
    tx_init, _ = make_optimizer(model, make_lr_fn(1e-3))
    opt = tx_init(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(seed)
    for v in opt['momentum'].values():
        v.copy_(torch.randn(v.shape, generator=g))
    opt['count'] = 10 + seed
    return TrainState(20 + seed, model, opt)


def _assert_state_equal(a, b):
    assert a.step == b.step and a.opt_state['count'] == b.opt_state['count']
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    ma, mb = a.opt_state['momentum'], b.opt_state['momentum']
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_checkpoint_manager_round_trip_and_eviction(tmp_path):
    """save/restore bit for bit (model state, momentum by name, count,
    step) by 'latest', None, an int, a digit string and a path; at most
    max_keep files, the oldest evicted; no temporary file left; an empty
    directory raises."""
    mgr = CheckpointManager(str(tmp_path / 'ckpts'), max_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(9), 'latest')
    states = {s: _state(s) for s in (1, 2, 3, 4)}
    for s, st in states.items():
        mgr.save(st, s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(mgr.directory)) == ['step_00000003.pt',
                                                 'step_00000004.pt']
    for key, want in (('latest', 4), (None, 4), (3, 3), ('3', 3),
                      (mgr.path(4), 4)):
        got = mgr.restore(_state(7), key)
        _assert_state_equal(got, states[want])


def test_save_torch_checkpoint_read_by_jax(tmp_path, jtiny):
    """A .pth of the port's model (save_torch_checkpoint) loads into the JAX
    tree with load_torch_checkpoint(strict=True), key for key, every array
    equal; the per-level Scale parameters keep their () shape."""
    model = build_trainable_model(TINY15, device='cpu', seed=3)
    path = str(tmp_path / 'port.pth')
    save_torch_checkpoint(model, path, meta=dict(epoch=1))
    ckpt = torch.load(path, weights_only=False)
    assert ckpt['meta'] == dict(epoch=1)
    scales = [k for k, v in ckpt['state_dict'].items() if v.dim() == 0]
    assert scales and all(k.endswith('scale') for k in scales)
    template = _seeded_tree(jtiny[1], seed=0)
    loaded, report = jbridge.load_torch_checkpoint(template, path,
                                                   strict=True)
    assert report == dict(unexpected=[], missing=[])
    back = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, loaded['params']),
        jax.tree_util.tree_map(np.asarray, loaded['batch_stats']))
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


def test_load_mspn_pretrained_matches_jax(tmp_path, jtiny):
    """An MSPN pretrained .pth (the backbone keys of a JAX tree, plus a
    keypoint head's): the port loads the same backbone as JAX's
    load_mspn_pretrained, ignores the rest, and leaves as many tensors at
    init as JAX leaves leaves."""
    src = _seeded_tree(jtiny[1], seed=4)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)).reshape(np.shape(v))
          for k, v in jbridge.export_torch_state_dict(src).items()
          if k.startswith('backbone.')}
    sd['keypoint_head.final_layer.weight'] = torch.zeros(17, 256, 1, 1)
    path = str(tmp_path / 'mspn.pth')
    torch.save(dict(state_dict=sd), path)
    template = _seeded_tree(jtiny[1], seed=5)
    jvars, jreport = jbridge.load_mspn_pretrained(template, path)
    model = build_trainable_model(TINY15, device='cpu', seed=6)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_mspn_pretrained(model, path)
    assert len(report['missing']) == len(jreport['missing']) > 0
    assert all(not k.startswith('backbone.') for k in report['missing'])
    want = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jvars['params']),
        jax.tree_util.tree_map(np.asarray, jvars['batch_stats']))
    for k, v in model.state_dict().items():
        if k.startswith('backbone.'):
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, init[k]), k


def test_load_checkpoint_allow_missing_prefixes(tmp_path):
    """strict with allow_missing_prefixes: keys under the prefixes may be
    missing (left out of the report, kept at init); other missing keys
    still raise."""
    src = build_trainable_model(TINY15, device='cpu', seed=1)
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith('bbox_head.cls_convs.')}
    path = str(tmp_path / 'part.pth')
    torch.save(dict(state_dict=sd), path)
    model = build_trainable_model(TINY15, device='cpu', seed=2)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_checkpoint_report(
        model, path, strict=True,
        allow_missing_prefixes=('bbox_head.cls_convs.',))
    assert report == dict(missing=[], unexpected=[])
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k] if k in sd else init[k]), k
    with pytest.raises(RuntimeError, match='Missing key'):
        load_checkpoint_report(model, path, strict=True,
                               allow_missing_prefixes=('neck.',))


# ------------------------------------------------------------ train_model

def train_cfg(root, ann, **over):
    """TINY15 on the synthetic frames through the shipped random train
    pipeline at 96x128 (the bucket 128x160), B=2."""
    ds = dict(type='CMUPanopticDataset', ann_file=ann, img_prefix=root,
              norm_depth=True, abs_dz=True, depth_factor=1)
    test_pipe = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotationsPose3D', with_pose_3d=True,
             with_label_3d=False),
        dict(type='MultiScaleFlipAug', img_scale=(160, 120), flip=False,
             transforms=[dict(type='Resize', keep_ratio=True),
                         dict(type='Normalize', **IMG_NORM),
                         dict(type='Pad', size_divisor=32),
                         dict(type='Collect3D',
                              keys=['img', 'gt_poses_3d', 'depths'])])]
    d = dict(
        model=copy.deepcopy(TINY15),
        data=dict(samples_per_gpu=B, workers_per_gpu=2,
                  train=dict(ds, pipeline=train_pipeline(
                      SHIPPED.train_pipeline)),
                  val=dict(ds, pipeline=test_pipe, test_mode=True),
                  test=dict(ds, pipeline=test_pipe, test_mode=True)),
        optimizer=dict(lr=1e-3, momentum=0.9, weight_decay=1e-4,
                       paramwise_cfg=dict(bias_lr_mult=2.,
                                          bias_decay_mult=0.)),
        optimizer_config=dict(grad_clip=dict(max_norm=35)),
        lr_config=dict(warmup_iters=3, warmup_ratio=1 / 3, step=[100]),
        runner=dict(max_epochs=1), log_config=dict(interval=1),
        checkpoint_config=dict(max_keep_ckpts=2))
    for k, v in over.items():
        d[k] = v
    return d


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('train_frames'))
    return root, write_panoptic(root, n=6, edge=())


def _metrics(work_dir):
    lines = []
    for f in sorted(glob.glob(os.path.join(work_dir, '*.metrics.jsonl'))):
        lines += [json.loads(x) for x in open(f).read().splitlines()]
    return lines


def _log_text(work_dir):
    return ''.join(open(f).read() for f in
                   glob.glob(os.path.join(work_dir, '*.log')))


def test_train_model_matches_jax_step_for_step(frames, tmp_path, jtiny):
    """TINY15 loads a .pth that JAX's save_torch_checkpoint wrote (nothing
    missing); train_model(device='cpu', fp32) takes 2 steps on the on-disk
    frames. Each step's losses (rtol 1e-4) and grad_norm (rtol 1e-3) equal
    JAX's make_train_step's from the same weights on the same loader
    batches (test_train_step_matches_jax's tolerances). The run writes its
    checkpoint, meta.json and event file."""
    root, ann = frames
    cfg = Config(train_cfg(root, ann))
    jmodel, shapes = jtiny
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  _seeded_tree(shapes, seed=0))
    pth = str(tmp_path / 'jax.pth')
    jbridge.save_torch_checkpoint(tree, pth)
    probe = build_trainable_model(TINY15, device='cpu')
    assert load_checkpoint_report(probe, pth, strict=False) == dict(
        missing=[], unexpected=[])

    work = str(tmp_path / 'work')
    state = train_model(cfg, work_dir=work, load_from=pth, max_steps=2,
                        log_interval=1, dtype=torch.float32, device='cpu')
    assert state.step == 2 and state.opt_state['count'] == 2
    got = _metrics(work)
    assert [m['step'] for m in got] == [1, 2]

    # the same batches: a loader of the same dataset, size and seed
    ds = build_dataset(cfg.data['train'])
    it = iter(TrainLoader(ds, B, (128, 160), J, num_workers=2, seed=0))
    batches = [next(it) for _ in range(2)]
    it.close()
    params = jax.tree_util.tree_map(jnp.asarray, tree['params'])
    lr_fn = jts.make_lr_fn(1e-3, warmup_iters=3, warmup_ratio=1 / 3,
                           step_epochs=(100,), steps_per_epoch=3)
    tx_init, tx_update = jts.make_optimizer(
        params, lr_fn, frozen_prefixes=jts.mspn_frozen_prefixes(1))
    jstate = jts.TrainState(jnp.zeros((), jnp.int32), params,
                            jax.tree_util.tree_map(jnp.asarray,
                                                   tree['batch_stats']),
                            tx_init(params))
    head = TINY15['bbox_head']
    step = jts.make_train_step(
        jmodel, tx_update, [(128 // (4 * 2 ** i), 160 // (4 * 2 ** i))
                            for i in range(4)],
        head['strides'], head['regress_ranges'], J, max_pos=128 * B,
        donate=False)
    for i, b in enumerate(batches):
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jm = {k: float(v) for k, v in jm.items()}
        assert set(jm) <= set(got[i])
        assert jm['grad_norm'] > 35.0 and jm['loss'] > 0
        for k, v in jm.items():
            rtol = 1e-3 if k == 'grad_norm' else 1e-4
            np.testing.assert_allclose(got[i][k], v, rtol=rtol, atol=1e-7,
                                       err_msg=f'step {i + 1} {k}')
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == [
        'meta.json', 'step_00000002.pt']
    meta = json.load(open(os.path.join(work, 'ckpts', 'meta.json')))
    assert meta['CLASSES'] == ['person'] and 'CMUPanopticDataset' in \
        meta['config'] and meta['das_tpu_torch_version']
    assert glob.glob(os.path.join(work, 'tf_logs', 'events.out.tfevents.*'))


def _step_fn(model):
    """train_model's step for train_cfg with 3 steps an epoch."""
    lr_fn = make_lr_fn(1e-3, warmup_iters=3, warmup_ratio=1 / 3,
                       step_epochs=(100,), steps_per_epoch=3)
    tx_init, tx_update = make_optimizer(
        model, lr_fn, frozen_prefixes=mspn_frozen_prefixes(1))
    head = TINY15['bbox_head']
    return tx_init, make_train_step(
        tx_update, [(128 // (4 * 2 ** i), 160 // (4 * 2 ** i))
                    for i in range(4)],
        head['strides'], head['regress_ranges'], J, max_pos=128 * B)


def test_resume_continues_bit_for_bit(frames, tmp_path):
    """A 4-step run crosses its epoch end (3 steps): a save, the DCN-offset
    check and the eval hook at step 3, a save at step 4
    (max_keep 2). Restored from step 3, the step on the run's 4th batch
    gives the saved step 4 bit for bit: weights, BN statistics, momentum,
    count. A resumed train_model continues from the latest step."""
    root, ann = frames
    d = train_cfg(root, ann, evaluation=dict(interval=1))
    # a served 'hybrid_pallas' model turns the DCN-offset check on; its
    # training runs the exact 'clip' lowering
    d['model']['bbox_head'].update(dcn_gather_mode='hybrid_pallas',
                                   dcn_train_gather_mode='clip',
                                   dcn_shift_radius=1)
    cfg = Config(d)
    work = str(tmp_path / 'work')
    state = train_model(cfg, work_dir=work, max_steps=4,
                        dtype=torch.float32, device='cpu')
    assert state.step == 4
    text = _log_text(work)
    for what in ('dcn offsets @ step 3', 'eval @ step 3: MPJPE',
                 'dcn offsets @ step 4'):
        assert what in text, what
    assert 'eval @ step 4' not in text
    mgr = CheckpointManager(os.path.join(work, 'ckpts'))
    assert mgr.all_steps() == [3, 4]

    model = build_trainable_model(cfg.model, device='cpu', seed=11)
    tx_init, step = _step_fn(model)
    restored = mgr.restore(
        TrainState(0, model, tx_init(dict(model.named_parameters()))), 3)
    assert restored.step == 3 and restored.opt_state['count'] == 3
    ds = build_dataset(cfg.data['train'])
    it = iter(TrainLoader(ds, B, (128, 160), J, num_workers=2, seed=0))
    batch = [next(it) for _ in range(4)][3]
    it.close()
    after, _ = step(restored, batch)
    saved = mgr.restore(TrainState(0, build_trainable_model(
        cfg.model, device='cpu', seed=12), after.opt_state), 4)
    _assert_state_equal(after, saved)

    again = train_model(cfg, work_dir=work, resume_from='latest',
                        max_steps=5, dtype=torch.float32, device='cpu')
    assert again.step == 5 and again.opt_state['count'] == 5
    assert 'resumed from latest at step 4' in _log_text(work)
    assert mgr.all_steps() == [4, 5]


def test_train_model_needs_a_device(frames, monkeypatch):
    """Without a card and without a device named, train_model raises
    before it builds anything."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model(Config(train_cfg(*frames)), work_dir='unused')


def test_device_normalize_and_cpu_prefetch():
    """device_normalize strips Normalize from every train pipeline and
    hands its mean/std/to_rgb to the step; on the CPU prefetch_to_device
    wraps the host arrays as they are."""
    pipe = [dict(type='LoadImageFromFile'), dict(type='Normalize',
                                                 **IMG_NORM),
            dict(type='Pad', size_divisor=32)]
    cfgs, norm = device_normalize([dict(type='A', pipeline=pipe),
                                   dict(type='B', pipeline=pipe)])
    assert norm == IMG_NORM
    assert all([t['type'] for t in c['pipeline']] ==
               ['LoadImageFromFile', 'Pad'] for c in cfgs)
    one, _ = device_normalize(dict(type='A', pipeline=pipe))
    assert len(one['pipeline']) == 2
    batches = [dict(img=np.full((2, 4, 4, 3), i, np.float32),
                    gt_valid=np.ones((2, 3), bool)) for i in range(3)]
    out = list(prefetch_to_device(iter(batches), 'cpu'))
    assert len(out) == 3
    for b, o in zip(batches, out):
        for k in b:
            assert np.array_equal(o[k].numpy(), b[k])


def test_train_cli_on_the_cpu(frames, tmp_path):
    """python -m das_tpu_torch.tools.train CONFIG --device cpu --max-steps
    1 --autoscale-lr --cfg-options ...: exit 0, one step, its checkpoint,
    and the learning rate scaled by 1/8 (one card) in the saved config."""
    root, ann = frames
    cfg_path = str(tmp_path / 'tiny_train.py')
    d = train_cfg(root, ann)
    with open(cfg_path, 'w') as f:
        for k, v in d.items():
            f.write(f'{k} = {v!r}\n')
    work = str(tmp_path / 'work')
    proc = subprocess.run(
        [sys.executable, '-m', 'das_tpu_torch.tools.train', cfg_path,
         '--work-dir', work, '--device', 'cpu', '--max-steps', '1',
         '--autoscale-lr', '--cfg-options', 'data.workers_per_gpu=1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '[das_tpu_torch] trained to step 1' in proc.stdout
    assert os.listdir(os.path.join(work, 'ckpts')).count(
        'step_00000001.pt') == 1
    meta = json.load(open(os.path.join(work, 'ckpts', 'meta.json')))
    assert "'lr': 0.000125" in meta['config']
    assert "'workers_per_gpu': 1" in meta['config']
