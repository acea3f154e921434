"""The program's spans (``das_tpu_torch.utils.profiling.span``) and the
benchmark's reading of them (``dasbench/spans.py``), on the CPU at a tiny
size: a span is a shared no-op without a profiler and a
``record_function`` range under one; a request and a train step with
remat emit the layers' spans, nested as the layers are; the helpers give
exact values on a hand-built trace of two threads; every reader of the
benchmark reads the same on a trace that carries the spans.

One test needs a card (it skips without one): each kernel launched in
``das.head`` starts on the device no earlier than its runtime call, which
lies inside the span, so host and device share one clock. On the card:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import copy
import json

import pytest
import torch

from das_tpu_torch.apis.inference import (init_model, make_predict_fn,
                                          results_to_host)
from das_tpu_torch.config import Config
from das_tpu_torch.ops.preprocess import make_preprocess_fn
from das_tpu_torch.parallel import TrainState
from das_tpu_torch.utils import profiling
from dasbench import run, spans
from dasbench.drivers import serve, train
from dasbench.tests import tiny

SERVE_SPANS = {'das.preprocess', 'das.predict', 'das.backbone', 'das.neck',
               'das.head', 'das.decode', 'das.to_host'}
PHASES = ('das.train.targets', 'das.train.forward', 'das.train.loss',
          'das.train.backward', 'das.train.optimizer')


@pytest.fixture(scope='module')
def repo_config(tmp_path_factory):
    path = tmp_path_factory.mktemp('tracing') / 'tiny.py'
    path.write_text(tiny.TINY_PY.format(remat=True, layers=1, max_pos=32))
    return Config.fromfile(str(path))


def _request(cfg, device, hw=(64, 96)):
    """A tiny model's serving path: (preprocess, predict, frames)."""
    model, cfg = init_model(copy.deepcopy(cfg), device=device)
    head = cfg.model.bbox_head
    predict = make_predict_fn(model, dict(cfg.model.test_cfg),
                              int(head.num_joints), tuple(head.strides),
                              device=device)
    pre = make_preprocess_fn(hw, hw, hw)
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (2, *hw, 3), generator=g,
                           dtype=torch.uint8).to(device)
    sf = torch.ones(2, 2, device=device)

    def once(i):
        results_to_host(predict(pre(frames), sf), ['a', 'b'])
    return once


def _by_name(tr):
    out = {}
    for s in tr['spans']:
        out.setdefault(s[0], []).append(s)
    return out


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[2] + inner[3] <= outer[2] + \
        outer[3]


def test_span_is_a_shared_noop_off_and_a_range_on():
    off = profiling.span('das.head')
    assert off is profiling.span('das.decode')
    assert not isinstance(off, torch.profiler.record_function)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.span('das.head')
        assert isinstance(on, torch.profiler.record_function)
        assert profiling.span('das.head') is not on
    assert profiling.span('das.head') is off


def test_a_request_emits_the_layers_spans_nested(repo_config):
    once = _request(repo_config, 'cpu')
    once(0)
    tr = spans.profile(once, 2, torch.device('cpu'))
    got = _by_name(tr)
    assert set(got) == SERVE_SPANS
    assert all(len(v) == 2 for v in got.values())
    own = spans.Owners(tr)
    for i, name in enumerate(own.names):
        up = own.chain[i] - {name}
        want = set() if name in ('das.preprocess', 'das.predict',
                                 'das.to_host') else {'das.predict'}
        assert up == want, (name, up)
    for k in range(2):
        for name in ('das.backbone', 'das.neck', 'das.head', 'das.decode'):
            assert _inside(got[name][k], got['das.predict'][k])
    r = spans.readings(tr)
    assert set(r) == {'serve.head_host_ms', 'serve.head_launches',
                      'serve.head_idle_ms', 'serve.host_syncs'}
    # no runtime on the CPU: nothing launched, nothing blocks
    assert r['serve.head_launches'] == 0 and r['serve.host_syncs'] == 0
    assert 0 < r['serve.head_host_ms'] < spans.host_ms(tr, 'das.predict')


@pytest.fixture(scope='module')
def step_trace(repo_config):
    """One tiny train step with remat, profiled: (trace, max_pos)."""
    model, tx_init, step, max_pos = train.make_trainer(
        copy.deepcopy(repo_config), torch.float32, 'cpu', 2, (64, 96))
    state = [TrainState(0, model, tx_init(dict(model.named_parameters())))]
    gen = torch.Generator().manual_seed(3)
    batch = train.synthetic_batch(2, 64, 96, tiny.J, 2, 3, gen, 'cpu')

    def once(i):
        state[0], _ = step(state[0], batch)
    return spans.profile(once, 1, torch.device('cpu')), max_pos


def test_a_train_step_with_remat_emits_its_phases(step_trace):
    tr = step_trace[0]
    got = _by_name(tr)
    assert len(got['das.train.step']) == 1
    whole = got['das.train.step'][0]
    for name in PHASES:
        assert len(got[name]) == 1 and _inside(got[name][0], whole), name
    starts = [got[name][0][2] for name in PHASES]
    assert starts == sorted(starts)
    backward = got['das.train.backward'][0]
    # every stage and tower of the tiny model is a remat region
    assert len(got['das.remat.recompute']) >= 4
    own = spans.Owners(tr)
    for i, name in enumerate(own.names):
        if name == 'das.remat.recompute':
            assert 'das.train.backward' in own.chain[i]
    for s in got['das.remat.recompute']:
        assert _inside(s, backward)
    assert {'das.head', 'das.backbone', 'das.neck'} <= set(got)
    for name in ('das.head', 'das.backbone', 'das.neck'):
        for s in got[name]:
            assert _inside(s, got['das.train.forward'][0]), name
    r = spans.readings(tr)
    assert set(r) == {'train.step_host_ms', 'train.remat_host_ms',
                      'train.optimizer_host_ms', 'train.launches'}
    assert r['train.remat_host_ms'] < r['train.step_host_ms']


def _hand_trace():
    """Two threads: the main one (1) steps, the autograd engine's (2)
    recomputes two remat regions inside the backward; times in us, two
    units."""
    sp = [('das.train.step', 1, 0.0, 100.0),
          ('das.train.backward', 1, 40.0, 50.0),
          ('das.remat.recompute', 2, 50.0, 10.0),
          ('das.remat.recompute', 2, 70.0, 5.0),
          ('das.train.optimizer', 1, 90.0, 10.0)]
    rt = [('cudaLaunchKernel', 1, 10.0, 1.0, 1),
          ('cudaMemcpyAsync', 1, 20.0, 1.0, 6),
          ('cudaStreamSynchronize', 1, 30.0, 5.0, 8),
          ('cudaLaunchKernel', 1, 45.0, 1.0, 2),
          ('cudaLaunchKernel', 2, 55.0, 1.0, 3),
          ('cuLaunchKernel', 2, 72.0, 1.0, 4),
          ('cudaLaunchKernel', 1, 95.0, 1.0, 5),
          ('cudaLaunchKernel', 1, 103.0, 1.0, 7),
          ('cudaDeviceSynchronize', 1, 105.0, 4.0, 9)]
    ops = [('k1', 12.0, 8.0, 1), ('Memcpy HtoD (Pageable -> Device)', 22.0,
                                  6.0, 6),
           ('k2', 47.0, 5.0, 2), ('k3', 56.0, 10.0, 3),
           ('direct_copy_kernel', 73.0, 7.0, 4), ('k5', 96.0, 2.0, 5),
           ('k7', 104.0, 2.0, 7)]
    return dict(device=[o[:3] for o in ops], host=[], window=(0.0, 110.0),
                units=2, spans=sp, runtime=rt, launched=ops)


def test_helpers_exact_on_a_hand_built_trace():
    tr = _hand_trace()
    # the idle gaps: [0,12) [20,22) [28,47) step; [52,56) the first
    # recompute; [66,73) [80,96) the backward; [98,104) the optimizer;
    # [106,110) outside every span
    assert spans.gaps(tr) == [(0.0, 12.0), (20.0, 22.0), (28.0, 47.0),
                              (52.0, 56.0), (66.0, 73.0), (80.0, 96.0),
                              (98.0, 104.0), (106.0, 110.0)]
    assert spans.launches(tr, 'das.train.step') == 5 / 2
    assert spans.launches(tr, 'das.train.backward') == 3 / 2
    assert spans.launches(tr, 'das.remat.recompute') == 2 / 2
    assert spans.launches(tr, 'das.train.optimizer') == 1 / 2
    assert spans.host_syncs(tr) == 1 / 2
    assert spans.host_ms(tr, 'das.remat.recompute') == 15 / 1e3 / 2
    assert spans.host_ms(tr, 'das.train.step') == 100 / 1e3 / 2
    assert spans.idle_ms(tr, 'das.train.step') == 66 / 1e3 / 2
    assert spans.idle_ms(tr, 'das.train.backward') == 27 / 1e3 / 2
    assert spans.idle_ms(tr, 'das.remat.recompute') == 4 / 1e3 / 2
    assert spans.readings(tr) == {
        'train.step_host_ms': 0.05, 'train.remat_host_ms': 15 / 1e3 / 2,
        'train.optimizer_host_ms': 10 / 1e3 / 2, 'train.launches': 2.5}
    t = spans.table(tr)
    assert list(t)[:3] == ['das.train.step', 'das.train.backward',
                           'das.remat.recompute']

    def row(name, **want):
        got = {k: round(v * 2e3, 9) if k.endswith('_ms') else v * 2
               for k, v in t[name].items()}
        zero = dict.fromkeys(('host_ms', 'launches', 'syncs', 'idle_ms',
                              'device_ms', 'copy_ms'), 0)
        assert got == {**zero, **want}, name
    row('das.train.step', host_ms=40, launches=1, syncs=1, idle_ms=33,
        device_ms=14, copy_ms=6)
    row('das.train.backward', host_ms=35, launches=1, idle_ms=23,
        device_ms=5)
    row('das.remat.recompute', host_ms=15, launches=2, idle_ms=4,
        device_ms=17, copy_ms=7)
    row('das.train.optimizer', host_ms=10, launches=1, idle_ms=6,
        device_ms=2)
    row(spans.OUTSIDE, host_ms=10, launches=1, syncs=1, idle_ms=4,
        device_ms=2)


def test_helpers_read_nothing_without_spans():
    """A program without spans (the parent of this change): every helper
    returns None and the readings are empty; nothing raises."""
    tr = dict(_hand_trace(), spans=[])
    assert spans.readings(tr) == {}
    assert spans.host_ms(tr, 'das.head') is None
    assert spans.launches(tr, 'das.head') is None
    assert spans.idle_ms(tr, 'das.head') is None
    assert spans.host_syncs(tr) is None
    assert set(spans.table(tr)) == {spans.OUTSIDE}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    # two threads for this module only: a later module in the same process
    # (a CLI against an in-process run) must see the default again
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny.make_root(tmp_path_factory.mktemp('bench'))
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def records(root, step_trace):
    """A traced record of each tiny cell: the serving driver's own run
    through ``spans.SpanContext``; for training, the driver's record
    around the profiled step (its run adds minutes of reference steps)."""
    spec = run.load_spec(root, 'tiny-serve')
    ctx = spans.SpanContext(root, spec, 2 ** 31 + 77, 0.3, True, 'cpu')
    tr, max_pos = step_trace
    return {'tiny-serve': serve.run(ctx)['record'],
            'tiny-train': dict(kind='train', config=tiny.dasbench_config(),
                               batch=2, hw=(64, 96), max_pos=max_pos,
                               trace=tr, window=dict(units=4, seconds=2.0),
                               launches_ok=True)}


@pytest.mark.parametrize('cell', ['tiny-serve', 'tiny-train'])
def test_readers_read_the_same_with_the_spans(root, records, cell):
    """Every per-layer reader of the cell reads the same number on the
    traced record with and without the new lists, and the span readings
    are there."""
    rec = records[cell]
    bare = dict(rec, trace={k: v for k, v in rec['trace'].items()
                            if k not in ('spans', 'runtime', 'launched')})
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    names = [m['name'] for m in run.cell_metrics(bench, cell, True)]
    assert names
    for name in names:
        assert run.read_metric(root, name, rec) == \
            run.read_metric(root, name, bare), name
    assert spans.readings(rec['trace'])


@pytest.mark.cuda
def test_head_launches_share_the_device_clock(repo_config):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the trace has no device side '
                    'without one')
    dev = torch.device('cuda')
    once = _request(repo_config, dev)
    once(0)
    tr = spans.profile(once, 1, dev)
    (head,) = _by_name(tr)['das.head']
    own = spans.Owners(tr)
    calls = [r for r in tr['runtime'] if r[0].startswith(spans.LAUNCH)]
    mine = [r for r, i in zip(calls, own.of([r[2] for r in calls]))
            if own.under(i, 'das.head')]
    assert len(mine) == spans.launches(tr, 'das.head') > 0
    ops = {o[3]: o for o in tr['launched']}
    for name, _, ts, _, corr in mine:
        assert head[2] <= ts < head[2] + head[3], name
        assert ops[corr][1] >= ts, (name, ops[corr][0])
