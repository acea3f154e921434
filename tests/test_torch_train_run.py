"""The port's sustained training run (``das_tpu_torch/tools/train_run.py``)
on the CPU, a trajectory of ``train_model`` against JAX's
``make_train_step``, and the JAX package's log analysis on the port's
metrics log.

- ``train_run`` at a tiny size (TINY15 on 96x128 synthetic JPEGs, a few
  steps, ``--device cpu``) writes the JAX tool's artifact keys, plus
  ``config``, ``device`` and ``power_limit``, from its own metrics log.
- ``train_model`` for TRAJ_STEPS steps against the JAX step on the same
  loader batches from the same ``.pth``, as
  tests/test_torch_train_api.py's two-step test, with a tolerance measured
  in the test: the spread between two JAX runs whose weights differ by one
  ulp (see ``test_train_model_trajectory_matches_jax``).
- ``tools/analysis_tools/analyze_logs.py`` as a subprocess on the port's
  ``*.metrics.jsonl``.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.checkpoint import torch_bridge as jbridge  # noqa: E402
from das_tpu.parallel import train_step as jts  # noqa: E402
from das_tpu_torch.apis import train_model  # noqa: E402
from das_tpu_torch.config import Config  # noqa: E402
from das_tpu_torch.datasets import build_dataset  # noqa: E402
from das_tpu_torch.datasets.loader import TrainLoader  # noqa: E402
from das_tpu_torch.tools import train_run  # noqa: E402
from test_e2e import TINY15  # noqa: E402
from test_torch_model import _seeded_tree  # noqa: E402
from test_torch_train_api import (B, J, _metrics, frames,  # noqa: E402,F401
                                  jtiny, one_torch_thread, train_cfg)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX tool's artifact (tools/analysis_tools/train_run.py)
JAX_KEYS = {'steps', 'batch', 'hw', 'wall_s', 'loss_first10', 'loss_last10',
            'loss_curve', 'step_s_min', 'step_s_p50', 'step_s_p90',
            'grad_norm_last', 'checkpoints', 'finite', 'decreasing'}
TRAJ_STEPS = 12


@pytest.fixture(scope='module')
def tiny_run(tmp_path_factory):
    """``train_run.main`` on the CPU: TINY15 with exp_panoptic's train
    pipeline (ResizePose fixed at 96x128), 8 synthetic images, B=2, 5
    steps, f32. Returns (artifact, its file, the work dir)."""
    tmp = tmp_path_factory.mktemp('train_run')
    shipped = Config.fromfile(os.path.join(ROOT, 'configs', 'das',
                                           'exp_panoptic.py'))
    cfg_path = str(tmp / 'tiny_panoptic.py')
    with open(cfg_path, 'w') as f:
        for k, v in dict(
                model=TINY15, optimizer=dict(shipped.optimizer),
                optimizer_config=dict(shipped.optimizer_config),
                lr_config=dict(shipped.lr_config),
                runner=dict(shipped.runner),
                data=dict(train=[dict(pipeline=[
                    dict(t) for t in shipped.train_pipeline])])).items():
            f.write(f'{k} = {v!r}\n')
    out = str(tmp / 'run.json')
    work = str(tmp / 'work')
    art = train_run.main([
        '--config', cfg_path, '--steps', '5', '--batch', str(B),
        '--images', '8', '--workers', '1', '--hw', '96', '128',
        '--device', 'cpu', '--dtype', 'float32',
        '--data-dir', str(tmp / 'data'), '--work-dir', work, '--out', out])
    return art, out, work


def test_train_run_tool_on_the_cpu(tiny_run):
    """The artifact has the JAX tool's keys (those of TRAIN_RUN_r05.json
    among them) plus config, device and power_limit; it parses from its
    file; the run took its steps from its own metrics log, finite, and
    saved at each epoch end (4 steps an epoch) and at the end."""
    art, out, work = tiny_run
    with open(out) as f:
        assert json.load(f) == art
    with open(os.path.join(ROOT, 'TRAIN_RUN_r05.json')) as f:
        assert JAX_KEYS <= set(json.load(f))
    assert set(art) == JAX_KEYS | {'config', 'device', 'power_limit'}
    assert art['steps'] == 5 and art['batch'] == B
    assert art['hw'] == [96, 128]
    assert art['device'] == 'cpu' and art['power_limit'] is None
    assert art['config'].endswith('tiny_panoptic.py')
    assert art['finite'] is True and isinstance(art['decreasing'], bool)
    assert art['checkpoints'] == ['meta.json', 'step_00000004.pt',
                                  'step_00000005.pt']
    rows = _metrics(work)
    assert [r['step'] for r in rows] == [1, 2, 3, 4, 5]
    losses = [r['loss'] for r in rows]
    assert art['loss_first10'] == round(float(np.mean(losses)), 4)
    assert len(art['loss_curve']) == 5
    assert art['step_s_min'] <= art['step_s_p50'] <= art['step_s_p90']


def test_train_run_refuses_other_joint_counts():
    """The synthetic set is Panoptic-style: a 21-joint config raises."""
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', 'das',
                                       'exp_mupots.py'))
    with pytest.raises(ValueError, match='15 joints'):
        train_run.run_config(cfg, 'a.json', 'd', 4, 1)


def test_analyze_logs_reads_the_port_metrics(tiny_run):
    """tools/analysis_tools/analyze_logs.py (the JAX package's) as a
    subprocess on the port's metrics jsonl: the loss curve's first and last
    values, and the images/s summary."""
    _, _, work = tiny_run
    jsonl = glob.glob(os.path.join(work, '*.metrics.jsonl'))
    assert len(jsonl) == 1
    rows = _metrics(work)
    tool = os.path.join(ROOT, 'tools', 'analysis_tools', 'analyze_logs.py')
    curve = subprocess.run(
        [sys.executable, tool, 'plot_curve', jsonl[0], '--keys', 'loss',
         'grad_norm'], capture_output=True, text=True, timeout=120)
    assert curve.returncode == 0, curve.stderr
    assert (f'loss: first {rows[0]["loss"]:.4f} @ 1, last '
            f'{rows[-1]["loss"]:.4f} @ 5') in curve.stdout
    assert 'grad_norm: first' in curve.stdout
    speed = subprocess.run(
        [sys.executable, tool, 'cal_train_time', jsonl[0]],
        capture_output=True, text=True, timeout=120)
    assert speed.returncode == 0, speed.stderr
    ips = [r['img_per_s'] for r in rows]
    assert f'mean {sum(ips) / len(ips):.2f} img/s' in speed.stdout


def _jax_run(jmodel, tree, batches, lr_fn):
    """JAX's make_train_step over ``batches`` from ``tree``: each step's
    metrics."""
    params = jax.tree_util.tree_map(jnp.asarray, tree['params'])
    tx_init, tx_update = jts.make_optimizer(
        params, lr_fn, frozen_prefixes=jts.mspn_frozen_prefixes(1))
    state = jts.TrainState(jnp.zeros((), jnp.int32), params,
                           jax.tree_util.tree_map(jnp.asarray,
                                                  tree['batch_stats']),
                           tx_init(params))
    head = TINY15['bbox_head']
    step = _jax_step(jmodel, tx_update, head)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


_STEPS = {}


def _jax_step(jmodel, tx_update, head):
    """The JAX step, compiled once for the module's runs."""
    if 'step' not in _STEPS:
        _STEPS['step'] = jts.make_train_step(
            jmodel, tx_update, [(128 // (4 * 2 ** i), 160 // (4 * 2 ** i))
                                for i in range(4)],
            head['strides'], head['regress_ranges'], J, max_pos=128 * B,
            donate=False)
    return _STEPS['step']


def test_train_model_trajectory_matches_jax(frames, tmp_path, jtiny):
    """train_model(device='cpu', fp32) for TRAJ_STEPS steps from a .pth that
    JAX's save_torch_checkpoint wrote, against JAX's make_train_step from
    the same tree on the same loader batches (3 steps an epoch: the run
    crosses 4 epoch ends, its saves and the warmup's end).

    Tolerance, per step and metric (loss, grad_norm): the larger of the
    one-step test's (loss rtol 1e-4, grad_norm rtol 1e-3) and 10x the
    spread between two JAX runs whose weights differ by one ulp (every
    leaf times 1 + 2^-23), at that step or any before it. A random-init
    run amplifies any change of rounding step by step, and the second JAX
    run measures by how much here; 10x is the one-step test's ratio of
    grad_norm's tolerance to its one-ulp spread."""
    root, ann = frames
    cfg = Config(train_cfg(root, ann))
    jmodel, shapes = jtiny
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  _seeded_tree(shapes, seed=0))
    pth = str(tmp_path / 'jax.pth')
    jbridge.save_torch_checkpoint(tree, pth)
    work = str(tmp_path / 'work')
    state = train_model(cfg, work_dir=work, load_from=pth,
                        max_steps=TRAJ_STEPS, log_interval=1,
                        dtype=torch.float32, device='cpu')
    assert state.step == TRAJ_STEPS
    got = _metrics(work)
    assert [m['step'] for m in got] == list(range(1, TRAJ_STEPS + 1))

    ds = build_dataset(cfg.data['train'])
    it = iter(TrainLoader(ds, B, (128, 160), J, num_workers=2, seed=0))
    batches = [next(it) for _ in range(TRAJ_STEPS)]
    it.close()
    lr_fn = jts.make_lr_fn(1e-3, warmup_iters=3, warmup_ratio=1 / 3,
                           step_epochs=(100,), steps_per_epoch=3)
    ref = _jax_run(jmodel, tree, batches, lr_fn)
    ulp = jax.tree_util.tree_map(
        lambda a: (a * np.float32(1 + 2.0 ** -23)).astype(np.float32), tree)
    other = _jax_run(jmodel, ulp, batches, lr_fn)
    spread = {'loss': 0.0, 'grad_norm': 0.0}
    for i in range(TRAJ_STEPS):
        for k, base in (('loss', 1e-4), ('grad_norm', 1e-3)):
            want = ref[i][k]
            spread[k] = max(spread[k], abs(other[i][k] - want))
            tol = max(base * abs(want), 10 * spread[k])
            assert abs(got[i][k] - want) <= tol, (i + 1, k, got[i][k], want,
                                                  tol)
    assert all(np.isfinite(m['loss']) for m in got)
