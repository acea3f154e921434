"""The port's demo and validate_hybrid CLIs (``das_tpu_torch/tools/``)
against the JAX package's ``tools/demo.py`` and ``tools/validate_hybrid.py``,
on the CPU in fp32.

Both packages' tools load one ``.pth``, written by the JAX bridge's
``save_torch_checkpoint`` from tests/test_torch_eval.py's TINY15 model with
seeded weights (conv_offset kernels at 0.8/sqrt(fan_in), the cls bias at
0). The JAX tools run in-process (``runpy``) as their own code, with two
shortcuts that change no result: the JAX model's ``init_all`` returns a
zero tree of its shapes (its eager init takes minutes on the CPU; every
leaf is then overwritten by the strict load of the ``.pth``), and the JAX
validate_hybrid's jitted forward is compiled once for its three runs. The
JAX demo runs its model in f32 (its ``init_model`` is called with bf16).
"""

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys

import cv2
import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import das_tpu.apis.inference as jinference  # noqa: E402
from das_tpu.checkpoint.torch_bridge import (  # noqa: E402
    save_torch_checkpoint as jsave_torch_checkpoint)
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu_torch.apis.inference import results_to_host  # noqa: E402
from das_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from das_tpu_torch.models import build_model  # noqa: E402
from das_tpu_torch.parallel.train_step import TrainState  # noqa: E402
from das_tpu_torch.tools import demo, validate_hybrid  # noqa: E402

from test_torch_eval import TINY15, _assert_people_agree  # noqa: E402
from test_torch_model import _seeded_tree, _tree_shapes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_THR = '0.05'
# (mode, radius, budget): each mode both passing and failing among them
VALIDATE = [('hybrid', 1, 20), ('hybrid', 2, 300), ('shift', 2, 300),
            ('shift', 3, 300), ('both', 2, 300), ('both', 3, 300)]


@contextlib.contextmanager
def zero_init(jmodel, shapes):
    """The JAX model class's ``init_all`` returning zeros of ``shapes``."""
    zeros = {c: jax.tree_util.tree_map(
        lambda s: jnp.zeros(s, jnp.float32), t,
        is_leaf=lambda x: isinstance(x, tuple)) for c, t in shapes.items()}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(type(jmodel), 'init_all', lambda self, rng, x: zeros)
        yield m


def run_jax_tool(path, argv):
    """``python tools/<path> argv`` in this process: (stdout, exit code)."""
    out = io.StringIO()
    code = 0
    old = sys.argv
    sys.argv = [path] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, path), run_name='__main__')
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = old
    return out.getvalue(), code


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The config file, the seeded ``.pth``, one 90x120 frame and a
    checkpoint directory of the port holding the same weights."""
    root = tmp_path_factory.mktemp('tools')
    jmodel = jbuild_model(TINY15)
    shapes = _tree_shapes(jmodel)
    tree = _seeded_tree(shapes, seed=0, offset_std=0.8)
    ckpt = str(root / 'tiny.pth')
    jsave_torch_checkpoint(tree, ckpt)
    cfg = str(root / 'tiny_cfg.py')
    with open(cfg, 'w') as f:
        f.write(f'model = {TINY15!r}\n')
    rng = np.random.RandomState(3)
    small = rng.randint(0, 255, (12, 16, 3)).astype(np.float32)
    img = str(root / 'frame.png')
    cv2.imwrite(img, cv2.resize(small, (120, 90)).astype(np.uint8))
    model = build_model(TINY15, device='cpu')
    validate_hybrid.load_weights(model, ckpt)
    ckpt_dir = str(root / 'ckpts')
    params = dict(model.named_parameters())
    CheckpointManager(ckpt_dir).save(TrainState(3, model, dict(
        momentum={k: torch.zeros_like(v) for k, v in params.items()},
        count=3)), 3)
    return dict(root=root, jmodel=jmodel, shapes=shapes, ckpt=ckpt, cfg=cfg,
                img=img, ckpt_dir=ckpt_dir)


@pytest.fixture(scope='module')
def jax_demo(files):
    """The JAX demo on the frame (f32, --out a PNG): its JSON, the padded
    batch and scale factors it hands its predict function."""
    seen = {}
    real_init, real_make = jinference.init_model, jinference.make_predict_fn

    def make_predict_fn(*args):
        predict = real_make(*args)

        def capture(variables, img, sf):
            seen['img'], seen['sf'] = np.asarray(img), np.asarray(sf)
            return predict(variables, img, sf)
        return capture

    out = str(files['root'] / 'jax_demo.png')
    with zero_init(files['jmodel'], files['shapes']) as m:
        m.setattr(jinference, 'init_model', lambda config, ckpt, dtype:
                  real_init(config, ckpt, dtype=jnp.float32))
        m.setattr(jinference, 'make_predict_fn', make_predict_fn)
        m.setattr(jax.config, 'update', lambda *a: None)
        text, code = run_jax_tool('tools/demo.py', [
            files['cfg'], files['ckpt'], files['img'], '--out', out,
            '--score-thr', SCORE_THR])
    assert code == 0, text
    return dict(json=json.loads(text[:text.rindex('}') + 1]), out=out,
                **seen)


def as_results(res):
    people = res['people']
    return [dict(poses=np.array([p['joints_uvd'] for p in people],
                                np.float32).reshape(-1, 15, 3),
                 scores=[p['score'] for p in people],
                 image_paths=[res['image']])]


def test_demo_preprocessing_and_drawing_are_the_jax_tools(files, jax_demo,
                                                          tmp_path):
    """The padded batch and the scale factors the JAX tool hands its model
    (1333x640 keep-ratio resize of the 90x120 uint8 frame, normalised,
    padded to 640x864) equal the port's bit for bit; the port drawing the
    JAX tool's people writes the same PNG, byte for byte."""
    frame = cv2.imread(files['img'])
    padded, sf = demo.preprocess(frame)
    assert jax_demo['img'].shape == (1, 640, 864, 3)
    np.testing.assert_array_equal(padded[None], jax_demo['img'])
    np.testing.assert_array_equal(sf, jax_demo['sf'])
    people = jax_demo['json']['people']
    assert people
    mine = str(tmp_path / 'port.png')
    cv2.imwrite(mine, demo.draw(frame, people))
    with open(mine, 'rb') as a, open(jax_demo['out'], 'rb') as b:
        assert a.read() == b.read()


def test_demo_people_match_jax_at_f32(files, jax_demo, tmp_path):
    """The port's demo in f32 on the CPU: the people above the score
    threshold match the JAX tool's (the same count, scores within
    SCORE_TOL, joints within POSE_RTOL: tests/test_torch_eval.py)."""
    got = demo.run(files['cfg'], files['ckpt'], files['img'],
                   out=str(tmp_path / 'port.png'),
                   score_thr=float(SCORE_THR), device='cpu',
                   dtype='float32')
    want = jax_demo['json']
    assert got['num_people'] == want['num_people'] > 0
    assert all(p['score'] >= float(SCORE_THR) for p in got['people'])
    _assert_people_agree(as_results(got), as_results(want), 'demo')
    assert os.path.getsize(tmp_path / 'port.png') > 0


def test_demo_score_filter_and_json():
    """people_above keeps the scores at or above the threshold, in order,
    with their joints; results_to_host's dict in, the JSON's lists out."""
    decoded = dict(
        scores=torch.tensor([[0.9, 0.2, 0.3, 0.0]]),
        poses=torch.arange(4 * 15 * 3, dtype=torch.float32)
        .reshape(1, 4, 15, 3),
        centers=torch.zeros(1, 4, 3), vis=torch.ones(1, 4, 15),
        valid=torch.tensor([[True, True, True, False]]))
    out = results_to_host(decoded, ['x.png'])[0]
    people = demo.people_above(out, 0.3)
    assert [p['score'] for p in people] == pytest.approx([0.9, 0.3])
    assert people[1]['joints_uvd'] == decoded['poses'][0, 2].tolist()
    json.dumps(people)


def test_demo_cli_runs_on_the_cpu(files, tmp_path):
    """python -m das_tpu_torch.tools.demo CONFIG CKPT IMAGE --device cpu
    (bf16, as a user runs it): exit 0, the JSON of the people above the
    threshold and the drawn frame."""
    out = str(tmp_path / 'cli.png')
    proc = subprocess.run(
        [sys.executable, '-m', 'das_tpu_torch.tools.demo', files['cfg'],
         files['ckpt'], files['img'], '--device', 'cpu', '--out', out,
         '--score-thr', SCORE_THR], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = proc.stdout
    res = json.loads(text[:text.rindex('}') + 1])
    assert res['image'] == files['img']
    assert res['num_people'] == len(res['people']) > 0
    assert all(p['score'] >= float(SCORE_THR) and
               np.asarray(p['joints_uvd']).shape == (15, 3)
               for p in res['people'])
    assert f'saved {out}' in text.splitlines()
    assert cv2.imread(out).shape == (90, 120, 3)


@pytest.fixture(scope='module')
def jax_tables(files):
    """The JAX validate_hybrid on the .pth for each VALIDATE case, at
    64x96 on RandomState(0) inputs: (stdout, exit code)."""
    real_jit = jax.jit
    compiled = {}

    def jit(fn, **kw):
        if fn.__name__ != 'fwd':
            return real_jit(fn, **kw)
        return compiled.setdefault(fn.__code__, real_jit(fn, **kw))

    out = {}
    with zero_init(files['jmodel'], files['shapes']) as m:
        m.setattr(jax, 'jit', jit)
        for mode, radius, budget in VALIDATE:
            out[mode, radius, budget] = run_jax_tool(
                'tools/validate_hybrid.py', [
                    '--config', files['cfg'], '--ckpt', files['ckpt'],
                    '--height', '64', '--width', '96', '--radius',
                    str(radius), '--budget', str(budget), '--mode', mode])
    for mode in ('hybrid', 'shift', 'both'):
        assert {out[k][1] for k in out if k[0] == mode} == {0, 1}, mode
    return out


def table(text):
    """The (max|off|, flagged) rows and the verdict line of the tool's
    output."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith('layer'))
    rows = []
    for ln in lines[start + 1:]:
        if not ln.strip():
            break
        mx, flagged = ln[70:].split()[:2]
        rows.append((float(mx), int(flagged)))
    return rows, lines[-1]


def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = validate_hybrid.main(argv)
    return out.getvalue(), code


@pytest.mark.parametrize('mode,radius,budget', VALIDATE)
def test_validate_hybrid_matches_jax(files, jax_tables, mode, radius,
                                     budget):
    """Per DCN layer and level, paired by order: max|off| as printed
    (3 decimals) within one unit of the last place, flagged pixels equal;
    the same verdict line and exit code for the mode."""
    text, code = run_port([
        '--config', files['cfg'], '--ckpt', files['ckpt'], '--height',
        '64', '--width', '96', '--radius', str(radius), '--budget',
        str(budget), '--mode', mode, '--device', 'cpu'])
    want_text, want_code = jax_tables[mode, radius, budget]
    got, verdict = table(text)
    want, want_verdict = table(want_text)
    assert len(got) == len(want) == 16
    for (g_mx, g_fl), (w_mx, w_fl) in zip(got, want):
        assert abs(g_mx - w_mx) <= 1.001e-3 and g_fl == w_fl, (got, want)
    assert verdict == want_verdict
    assert code == want_code
    assert text.splitlines()[0] == want_text.splitlines()[0]


def test_validate_hybrid_reads_a_checkpoint_directory(files):
    """--ckpt as the port's checkpoint directory (its latest step) gives
    the table of the .pth it was saved from."""
    argv = ['--config', files['cfg'], '--height', '64', '--width', '96',
            '--radius', '1', '--budget', '20', '--device', 'cpu']
    text, code = run_port(argv + ['--ckpt', files['ckpt_dir']])
    want, want_code = run_port(argv + ['--ckpt', files['ckpt']])
    assert f'restored {files["ckpt_dir"]} at step 3' in text
    assert table(text) == table(want) and code == want_code == 1
    with pytest.raises(FileNotFoundError):
        run_port(argv + ['--ckpt', str(files['root'] / 'nothing')])


def test_validate_hybrid_images(files):
    """--images: the frames through cv2 (BGR->RGB, resize, (x - 127.5) /
    58), as the JAX tool reads them."""
    frame = cv2.imread(files['img'])
    got = validate_hybrid.inputs([files['img']] * 2, 64, 96)
    want = (cv2.resize(frame[..., ::-1].astype(np.float32), (96, 64))
            - 127.5) / 58.0
    assert got.shape == (2, 64, 96, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[1], want.astype(np.float32))
    np.testing.assert_array_equal(
        validate_hybrid.inputs(None, 8, 4),
        np.random.RandomState(0).randn(2, 8, 4, 3).astype(np.float32))


def test_tools_need_a_device_without_cuda(files, monkeypatch, tmp_path):
    """With no card, the demo, validate_hybrid, fuse_conv_bn and
    export_torch on their default device raise; none runs on the CPU on
    its own."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    from das_tpu_torch.tools import export_torch, fuse_conv_bn
    calls = [
        lambda: demo.main([files['cfg'], files['ckpt'], files['img']]),
        lambda: validate_hybrid.main(['--config', files['cfg']]),
        lambda: fuse_conv_bn.main([files['cfg'], files['ckpt'],
                                   str(tmp_path / 'f.pth')]),
        lambda: export_torch.main([files['cfg'], files['ckpt_dir'],
                                   str(tmp_path / 'e.pth')])]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError), match='CUDA'):
            call()
    assert not (tmp_path / 'f.pth').exists()
