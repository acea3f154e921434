"""The port's remaining tools and helpers against the JAX package's, on the
CPU: ``print_config``, ``fuse_conv_bn``, ``browse_dataset``,
``visualize_results``, ``export_torch`` and ``publish_model``
(``das_tpu_torch/tools/``), ``core/visualize.py``, ``mytools/vis_3d.py``,
``utils/profiling.py`` and ``utils/collect_env.py``; and that the repo's
``mytools`` converters run without JAX.

The JAX tools run in-process (``runpy``) as their own code; the JAX
``fuse_conv_bn`` with its model's ``init_all`` returning a zero tree of its
shapes (tests/test_torch_demo.py's shortcut: the strict load of the
``.pth`` overwrites every leaf). The model is tests/test_torch_eval.py's
TINY15 with seeded weights, written once by the JAX bridge's
``save_torch_checkpoint``; the datasets are tests/test_torch_train_data.py's
synthetic CMU-Panoptic frames, as PNGs.
"""

import glob
import hashlib
import json
import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest

jax = pytest.importorskip('jax')
import torch  # noqa: E402

from das_tpu.checkpoint.torch_bridge import (  # noqa: E402
    load_torch_checkpoint as jload_torch_checkpoint,
    save_torch_checkpoint as jsave_torch_checkpoint)
from das_tpu.core import visualize as jvisualize  # noqa: E402
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu_torch.apis import init_model  # noqa: E402
from das_tpu_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                      state_dict_from_flax)
from das_tpu_torch.core import visualize  # noqa: E402
from das_tpu_torch.models import build_trainable_model  # noqa: E402
from das_tpu_torch.parallel.train_step import TrainState  # noqa: E402
from das_tpu_torch.tools import (browse_dataset, export_torch,  # noqa: E402
                                 fuse_conv_bn, print_config, publish_model,
                                 visualize_results)
from das_tpu_torch.utils import collect_env, profiling  # noqa: E402

from test_torch_demo import run_jax_tool, zero_init  # noqa: E402
from test_torch_eval import TINY15  # noqa: E402
from test_torch_model import _seeded_tree, _tree_shapes  # noqa: E402
from test_torch_train_data import write_panoptic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'configs', '**', '*.py'), recursive=True))
CFG_OPTIONS = ['work_dir=./work', 'optimizer.lr=0.004',
               'extra.depths=[1, 2]', 'extra.name=x']


def run_port_tool(tool, argv, capsys):
    """A port tool's ``main(argv)``: (stdout, exit code)."""
    capsys.readouterr()
    code = tool.main(argv)
    return capsys.readouterr().out, code


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The tiny config (with the synthetic Panoptic frames as its train and
    test data), the seeded ``.pth`` and the JAX tree it holds."""
    root = tmp_path_factory.mktemp('tools')
    ann = write_panoptic(str(root))
    with open(ann) as f:
        d = json.load(f)
    for im in d['images']:
        jpg = os.path.join(root, im['file_name'])
        im['file_name'] = im['file_name'].replace('.jpg', '.png')
        cv2.imwrite(os.path.join(root, im['file_name']), cv2.imread(jpg))
    with open(ann, 'w') as f:
        json.dump(d, f)
    data = dict(type='CMUPanopticDataset', ann_file=ann,
                img_prefix=str(root), pipeline=[], norm_depth=True,
                abs_dz=True, depth_factor=1)
    cfg = str(root / 'tiny_cfg.py')
    with open(cfg, 'w') as f:
        f.write(f'model = {TINY15!r}\n'
                f'data = {dict(train=data, test=data)!r}\n')
    jmodel = jbuild_model(TINY15)
    shapes = _tree_shapes(jmodel)
    tree = _seeded_tree(shapes, seed=0, offset_std=0.8)
    ckpt = str(root / 'tiny.pth')
    jsave_torch_checkpoint(tree, ckpt)
    return dict(root=root, cfg=cfg, ckpt=ckpt, jmodel=jmodel, shapes=shapes,
                tree=tree, images=[im['file_name'] for im in d['images']])


@pytest.mark.parametrize('options', [None, CFG_OPTIONS],
                         ids=['plain', 'cfg-options'])
def test_print_config_matches_jax(options, capsys):
    """The same text as tools/misc/print_config.py for every config under
    configs/, with and without --cfg-options."""
    extra = ['--cfg-options', *options] if options else []
    for path in CONFIGS:
        got, code = run_port_tool(print_config, [path, *extra], capsys)
        want, jcode = run_jax_tool('tools/misc/print_config.py',
                                   [path, *extra])
        assert code == jcode == 0
        assert got == want, path
        assert got.startswith('Config:\n{')
        if options:
            assert "'lr': 0.004" in got and "'depths': [1, 2]" in got


def test_fuse_conv_bn_matches_jax(files, capsys, tmp_path):
    """The folded .pth: the JAX tool's keys, each array within 1e-6 of its
    largest value, the same fused pair count and meta; it loads strictly
    into the unfused model, whose forward it leaves as it was."""
    want_path = str(tmp_path / 'jax_fused.pth')
    with zero_init(files['jmodel'], files['shapes']):
        want_text, code = run_jax_tool('tools/misc/fuse_conv_bn.py', [
            files['cfg'], files['ckpt'], want_path])
    assert code == 0, want_text
    got_path = str(tmp_path / 'port_fused.pth')
    text, code = run_port_tool(fuse_conv_bn, [
        files['cfg'], files['ckpt'], got_path, '--device', 'cpu'], capsys)
    assert code == 0
    n = [ln for ln in text.splitlines() if ln.startswith('fused ')]
    assert n == [ln for ln in want_text.splitlines()
                 if ln.startswith('fused ')] and int(n[0].split()[1]) > 0
    got = torch.load(got_path, weights_only=False)
    want = torch.load(want_path, weights_only=False)
    assert got['meta'] == want['meta'] == dict(fused_conv_bn=True)
    assert set(got['state_dict']) == set(want['state_dict'])
    for k, w in want['state_dict'].items():
        g = got['state_dict'][k]
        assert g.shape == w.shape, k
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w.to(g.dtype), rtol=0,
                                   atol=1e-6 * scale, msg=k)
    fused, _ = init_model(files['cfg'], got_path, device='cpu')
    plain, _ = init_model(files['cfg'], files['ckpt'], device='cpu')
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 96, 3)
                         .astype(np.float32))
    with torch.no_grad():
        for a, b in zip(fused(x)[0], plain(x)[0]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_browse_dataset_matches_jax(files, capsys, tmp_path):
    """The GT skeletons of every synthetic frame: PNGs byte-equal to the
    JAX tool's."""
    mine, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    got, code = run_port_tool(browse_dataset, [
        files['cfg'], '--out-dir', mine], capsys)
    want, jcode = run_jax_tool('tools/misc/browse_dataset.py', [
        files['cfg'], '--out-dir', theirs])
    assert code == jcode == 0
    assert got.replace(mine, theirs) == want
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(mine)) == sorted(files['images'])
    for name in names:
        with open(os.path.join(mine, name), 'rb') as a, \
                open(os.path.join(theirs, name), 'rb') as b:
            assert a.read() == b.read(), name


def test_visualize_results_matches_jax(files, capsys, tmp_path):
    """A results pickle in the format of ``das_tpu_torch.tools.test
    --out`` (run_test's per-image dicts) with seeded poses, drawn above a
    score threshold: PNGs byte-equal to the JAX tool's."""
    rng = np.random.RandomState(2)
    outputs = []
    for name in files['images']:
        P = 3
        poses = np.concatenate([rng.uniform(4, 120, (P, 15, 1)),
                                rng.uniform(4, 90, (P, 15, 1)),
                                rng.uniform(200, 400, (P, 15, 1))], -1)
        outputs.append(dict(
            poses=poses.astype(np.float32),
            vis=(rng.rand(P, 15) > 0.2).astype(np.float32),
            centers=poses[:, 2].astype(np.float32),
            image_paths=[os.path.join(files['root'], name)],
            scores=rng.uniform(0, 1, P).tolist()))
    results = str(tmp_path / 'results.pkl')
    with open(results, 'wb') as f:
        pickle.dump(outputs, f)
    mine, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    args = ['--num', '4', '--score-thr', '0.3']
    got, code = run_port_tool(visualize_results, [
        results, '--out-dir', mine, *args], capsys)
    want, jcode = run_jax_tool('tools/misc/visualize_results.py', [
        results, '--out-dir', theirs, *args])
    assert code == jcode == 0
    assert got.replace(mine, theirs) == want
    assert len(os.listdir(theirs)) == 4
    for name in os.listdir(theirs):
        with open(os.path.join(mine, name), 'rb') as a, \
                open(os.path.join(theirs, name), 'rb') as b:
            assert a.read() == b.read(), name


def test_draw_pose_2d_matches_jax(files):
    """core/visualize: the skeletons and draw_pose_2d with visibility and
    scores, 15 and 21 joints, equal to the JAX module's."""
    assert visualize.SKELETON_15 == jvisualize.SKELETON_15
    assert visualize.SKELETON_21 == jvisualize.SKELETON_21
    img = cv2.imread(os.path.join(files['root'], files['images'][0]))
    rng = np.random.RandomState(1)
    for J in (15, 21):
        assert visualize.skeleton_for(J) == jvisualize.skeleton_for(J)
        poses = rng.uniform(0, 100, (2, J, 3))
        vis = (rng.rand(2, J) > 0.3).astype(np.float32)
        for kw in (dict(), dict(vis=vis, scores=[0.5, 0.25])):
            np.testing.assert_array_equal(
                visualize.draw_pose_2d(img, poses, **kw),
                jvisualize.draw_pose_2d(img, poses, **kw))
    np.testing.assert_array_equal(visualize.draw_pose_2d(img, poses[0]),
                                  jvisualize.draw_pose_2d(img, poses[0]))


@pytest.fixture(scope='module')
def ckpt_dir(files):
    """A checkpoint directory of the port's training (two steps) of the
    tiny model from the seeded .pth."""
    model = build_trainable_model(TINY15, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        files['tree']['params'], files['tree']['batch_stats']))
    path = str(files['root'] / 'ckpts')
    mgr = CheckpointManager(path)
    params = dict(model.named_parameters())
    for step in (2, 4):
        with torch.no_grad():
            model.bbox_head.conv_cls.bias.fill_(0.01 * step)
        mgr.save(TrainState(step, model, dict(
            momentum={k: torch.full_like(v, 0.5)
                      for k, v in params.items()}, count=step)), step)
    return path


@pytest.mark.parametrize('step', [None, '2'], ids=['latest', 'step'])
def test_export_torch_loads_in_the_jax_bridge(files, ckpt_dir, step, capsys,
                                              tmp_path):
    """The exported .pth loads in load_torch_checkpoint with no missing or
    unexpected key and arrays equal to the checkpoint's model; it carries
    the reference meta (version, time, config text, CLASSES) and loads
    strictly with init_model."""
    out = str(tmp_path / 'export.pth')
    argv = [files['cfg'], ckpt_dir, out, '--device', 'cpu']
    text, code = run_port_tool(export_torch, argv + (
        ['--step', step] if step else []), capsys)
    want_step = int(step or 4)
    assert code == 0 and f'(step {want_step})' in text
    ckpt = torch.load(out, weights_only=False)
    meta = ckpt['meta']
    assert set(meta) == {'das_tpu_torch_version', 'time', 'config',
                         'CLASSES'}
    assert meta['CLASSES'] == ('person',)
    assert "'type': 'DAS'" in meta['config']
    template = {c: jax.tree_util.tree_map(
        lambda s: np.zeros(s, np.float32), t,
        is_leaf=lambda x: isinstance(x, tuple))
        for c, t in files['shapes'].items()}
    tree, report = jload_torch_checkpoint(template, out)
    assert report['missing'] == [] and report['unexpected'] == []
    saved = torch.load(CheckpointManager(ckpt_dir).path(want_step),
                       weights_only=True)['model']
    back = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, tree['params']), jax.tree_util.tree_map(
        np.asarray, tree['batch_stats']))
    for k, v in back.items():
        torch.testing.assert_close(v, saved[k].float(), rtol=0, atol=0,
                                   msg=k)
    assert float(back['bbox_head.conv_cls.bias'][0]) == \
        pytest.approx(0.01 * want_step)
    init_model(files['cfg'], out, device='cpu')


def test_publish_model_strips_the_training_state(files, ckpt_dir, capsys,
                                                 tmp_path):
    """From a step file of the checkpoint directory (model, momentum,
    count, step) and from a reference .pth with an optimizer: no training
    state left, the name stamped with the file's sha256[:8], and the file
    loads strictly with init_model."""
    ref = str(tmp_path / 'ref.pth')
    sd = torch.load(files['ckpt'], weights_only=False)
    torch.save(dict(sd, optimizer=dict(state={}, param_groups=[])), ref)
    step_file = CheckpointManager(ckpt_dir).path(4)
    for src, name in ((step_file, 'from_step.pth'), (ref, 'from_ref')):
        text, code = run_port_tool(publish_model, [
            src, str(tmp_path / name)], capsys)
        assert code == 0
        final = text.split()[-1]
        stem = str(tmp_path / name.replace('.pth', ''))
        assert final.startswith(stem + '-') and final.endswith('.pth')
        with open(final, 'rb') as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        assert final == f'{stem}-{sha[:8]}.pth'
        ckpt = torch.load(final, weights_only=False)
        assert not set(ckpt) & set(publish_model.TRAINING_STATE)
        assert 'state_dict' in ckpt
        init_model(files['cfg'], final, device='cpu')


def test_vis_3d_matches_mytools():
    """pixel2world's (rays, camera, world) and world2pixel, float64,
    against mytools/vis_3d.py, on a camera with a skew and a rotation."""
    import mytools.vis_3d as jvis
    from das_tpu_torch.mytools import vis_3d
    rng = np.random.RandomState(0)
    K = np.array([[1400.0, 2.0, 960.0], [0.0, 1390.0, 540.0], [0, 0, 1]])
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1.0]])
    t = np.array([[10.0], [-20.0], [300.0]])
    x = np.stack([rng.uniform(0, 1920, 20), rng.uniform(0, 1080, 20),
                  rng.uniform(200, 900, 20)])
    got, want = vis_3d.pixel2world(x, K, R, t), jvis.pixel2world(x, K, R, t)
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    X = got[-1]
    np.testing.assert_array_equal(vis_3d.world2pixel(X, K, R, t),
                                  jvis.world2pixel(X, K, R, t))
    np.testing.assert_allclose(vis_3d.world2pixel(X, K, R, t), x,
                               rtol=1e-6)


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """trace writes a Chrome trace JSON (TensorBoard and Perfetto read it)
    holding a span's region and the ops under it; a span is the one
    shared no-op context while no profiler records, and a
    ``record_function`` range while one does (the JAX package's
    ``StepTimer`` has no counterpart: a rolling mean of host intervals is
    no rate)."""
    off = profiling.span('das_region')
    assert off is profiling.span('das_other')
    assert not isinstance(off, torch.profiler.record_function)
    with off, off:
        pass
    log_dir = str(tmp_path / 'trace')
    with profiling.trace(log_dir) as prof:
        on = profiling.span('das_region')
        assert isinstance(on, torch.profiler.record_function)
        with on:
            torch.relu(torch.ones(8, 8)) @ torch.ones(8, 8)
    assert profiling.span('das_region') is off
    files = glob.glob(os.path.join(log_dir, '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    region = [e for e in events if e.get('name') == 'das_region']
    assert [e.get('cat') for e in region] == ['user_annotation']
    relu = [e for e in events if e.get('name') == 'aten::relu']
    assert len(relu) == 1
    lo, hi = region[0]['ts'], region[0]['ts'] + region[0]['dur']
    assert lo <= relu[0]['ts'] and relu[0]['ts'] + relu[0]['dur'] <= hi
    assert any(e.key == 'das_region' for e in prof.key_averages())


def test_collect_env_keys(capsys):
    """Every key of the report, here and as ``python -m``; no card here."""
    env = collect_env.collect_env()
    for key in ('sys.platform', 'Python', 'Platform', 'torch',
                'CUDA runtime', 'cuDNN', 'CUDA devices', 'nvidia-smi',
                'nvcc', 'g++', 'numpy', 'cv2', 'das_tpu_torch'):
        assert key in env, key
    assert env['torch'] == torch.__version__
    assert env['numpy'] == np.__version__ and env['cv2'] == cv2.__version__
    assert env['g++'].split(':')[0].endswith('g++')
    proc = subprocess.run([sys.executable, '-m',
                           'das_tpu_torch.utils.collect_env'], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [ln.split(':')[0] for ln in proc.stdout.splitlines()] == \
        list(env)


@pytest.mark.parametrize('script', ['panoptic2coco', 'muco2coco'])
def test_mytools_converters_import_no_jax(script):
    """mytools/panoptic2coco.py and muco2coco.py need no port: importing
    them leaves jax and das_tpu out of sys.modules."""
    code = '\n'.join([
        'import sys',
        f'import mytools.{script}',
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'flax', 'das_tpu', 'torch'))",
        'print(bad)',
        'sys.exit(1 if bad else 0)'])
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
