"""The harness on the CPU at a tiny size: cells, configurations, mixes and
metrics are found by name; a run's result has the contract's keys; the
measurement path refuses to run without a card; nothing imports JAX or
the JAX package, and the reference nothing of the program."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dasbench import run
from dasbench.drivers import serve
from dasbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp('bench'))


def test_new_files_are_found_by_name(root):
    """A configuration, a mix, a cell and a metric added as files and
    entries only: the run finds and reports them."""
    (root / 'dasbench/metrics/serve.extra_ms.py').write_text(
        'def read(record):\n    return 1.5\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['per_layer'].append(dict(
        name='serve.extra_ms', unit='ms', better='lower',
        source='program_span', layer='device', moves='serve_p95_ms',
        workloads=['tiny-serve2']))
    cfg = json.loads((root / 'dasbench/configs/tiny.json').read_text())
    cfg['name'] = 'tiny2'
    (root / 'dasbench/configs/tiny2.json').write_text(json.dumps(cfg))
    bench['configs'].append(dict(name='tiny2', source='tiny', reduced=[],
                                 file='dasbench/configs/tiny2.json',
                                 why='tiny'))
    mix = json.loads((root / 'dasbench/traffic/tiny_serve.json').read_text())
    mix['params']['batch'] = 1
    (root / 'dasbench/traffic/tiny_serve1.json').write_text(json.dumps(mix))
    bench['workloads'].append(dict(name='tiny-serve2', config='tiny2',
                                   traffic='tiny_serve1', chips=1,
                                   why='tiny'))
    for m in bench['end_to_end']:
        if m['name'].startswith('serve'):
            m['workloads'].append('tiny-serve2')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    r = run.execute(root, 'tiny-serve2', 7, 0.5, True, 'cpu')
    assert r['metrics']['serve.extra_ms'] == dict(value=1.5, unit='ms')
    assert r['correct']


@pytest.mark.parametrize('cell,trace', [('tiny-serve', False),
                                        ('tiny-serve', True),
                                        ('tiny-train', False),
                                        ('tiny-train', True)])
def test_result_has_the_contract_keys(root, cell, trace):
    r = run.execute(root, cell, 2 ** 31 + 12345, 0.5, trace, 'cpu')
    checks = r.pop('checks')
    assert set(r) == KEYS | ({'breakdown'} if trace else set())
    line = json.loads(json.dumps(dict(r, checks=checks)))
    assert list(line)[-1] == 'checks'
    assert r['correct'] and r['attempted'] > 0 and r['failed'] == 0
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    want = run.cell_metrics(bench, cell, trace)
    for m in r['metrics']:
        assert m in {w['name'] for w in want}
    if trace:
        assert set(r['device']) >= {'busy_s', 'window_s'}
        assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert {w['name'] for w in want} == set(r['metrics'])


def test_same_seed_same_inputs(root):
    a = run.execute(root, 'tiny-train', 99, 0.3, False, 'cpu')['checks']
    b = run.execute(root, 'tiny-train', 99, 0.3, False, 'cpu')['checks']
    assert a == b


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result: it never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run(
        [sys.executable, '-m', 'dasbench.run', '--workload',
         'panoptic-serve-b4', '--seed', '1', '--seconds', '1', '--trace',
         '0'], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
    assert 'CUDA' in p.stderr


def _loaded(code):
    p = subprocess.run([sys.executable, '-c', code + (
        '\nimport sys, json\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_imports_load_no_jax_nor_jax_package():
    tops = _loaded('import dasbench.run, dasbench.calibrate, '
                   'dasbench.drivers.serve, dasbench.drivers.train, '
                   'dasbench.reference.model')
    assert not tops & {'jax', 'jaxlib', 'flax', 'das_tpu'}


def test_reference_loads_nothing_of_the_program():
    tops = _loaded('import dasbench.reference.model, '
                   'dasbench.reference.train, dasbench.reference.decode, '
                   'dasbench.reference.preprocess, dasbench.weights')
    assert not tops & {'jax', 'jaxlib', 'flax', 'das_tpu', 'das_tpu_torch'}


def test_a_mix_above_capacity_stops_sending_at_the_window(root):
    """A mix offered above what the path sustains sends back to back,
    sends nothing once the window's clock has run out, and reports the
    images completed."""
    mix = json.loads((root / 'dasbench/traffic/tiny_serve.json').read_text())
    mix['params'].update(rate=1000.0, saturate=True)
    (root / 'dasbench/traffic/tiny_serve_sat.json').write_text(
        json.dumps(mix))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['workloads'].append(dict(name='tiny-serve-sat', config='tiny',
                                   traffic='tiny_serve_sat', chips=1,
                                   why='tiny'))
    for m in bench['end_to_end']:
        if m['name'] == 'serve_img_s':
            m['workloads'] = ['tiny-serve-sat']
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    spec = run.load_spec(root, 'tiny-serve-sat')
    cell = serve.Cell(run.Context(root, spec, 3, 0.5, False, 'cpu'))
    cell.load(3)
    w = cell.window(0.5)
    assert 0 < len(w['lat']) < 500
    # the last request was sent before the window closed
    assert w['secs'] - w['svc'][-1] / 1e3 < 0.5
    r = run.execute(root, 'tiny-serve-sat', 3, 0.5, False, 'cpu')
    assert set(r['metrics']) == {'setup_s', 'serve_img_s'} and r['correct']
