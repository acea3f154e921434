"""The program's own spans in a profiled window, and what happened inside
them: host time, kernel launches, blocking runtime calls, the device's
idle gaps and the device time launched, each put down to a layer.

``das_tpu_torch.utils.profiling.span`` opens a ``record_function`` range
named ``das.<layer>`` while a profiler records, so the spans lie in the
same trace as the CUDA runtime's calls and the device's operations, on
one clock. ``profile`` traces as ``dasbench.trace.profile`` does and
returns its dict with three lists more:

- ``spans``: the ``user_annotation`` events named ``das.*``, as
  (name, tid, ts, dur);
- ``runtime``: the ``cuda_runtime`` and ``cuda_driver`` events, as
  (name, tid, ts, dur, correlation);
- ``launched``: the device's operations, as (name, ts, dur,
  correlation).

One rule puts an instant down to a span: the innermost program span open
then on any thread, taken as the latest-starting one (a span is open on
[ts, ts + dur)). A span lies under the span its own start is put down
to, so remat's recompute, which the autograd engine runs on its own
thread, lies under the backward that the main thread waits in. Every
helper gives its value a unit (a request or a step: ``units``).

Run one cell with its profiled window traced this way:

    python -m dasbench.spans --workload <cell> --seed <n> --seconds <s>

It prints one JSON line: the cell's end-to-end numbers, ``correct``, the
readings of ``readings``, the table of ``table``, the profiled window's
ms a unit beside the untraced window's, and what a span costs with no
profiler and under one (``span_cost_ns``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from . import run
from .trace import DEVICE_CATS, WINDOW, _union

PREFIX = 'das.'
OUTSIDE = '(outside)'
LAUNCH = ('cudaLaunch', 'cuLaunch')
BLOCKING = frozenset(('cudaStreamSynchronize', 'cudaDeviceSynchronize',
                      'cudaEventSynchronize', 'cudaMemcpy'))
RUNTIME_CATS = ('cuda_runtime', 'cuda_driver')


def profile(fn: Callable[[int], None], units: int, device: torch.device
            ) -> Dict:
    """``dasbench.trace.profile``'s dict for ``fn(i)``, i < units, with
    ``spans``, ``runtime`` and ``launched`` besides."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(units):
                fn(i)
            sync()
    fd, path = tempfile.mkstemp(suffix='.json', prefix='dasbench_spans_')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    return read_events(events, units)


def read_events(events: List[Dict], units: int) -> Dict:
    """The dict of ``profile`` from a Chrome trace's events."""
    dev, host, window = [], [], None
    spans, runtime, launched = [], [], []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, name = e.get('cat', ''), e.get('name', '')
        ts, dur = float(e['ts']), float(e.get('dur', 0.0))
        corr = (e.get('args') or {}).get('correlation')
        if cat in DEVICE_CATS:
            dev.append((name, ts, dur))
            launched.append((name, ts, dur, corr))
        elif cat == 'user_annotation' and name == WINDOW:
            window = (ts, dur)
        elif cat == 'user_annotation' and name.startswith(PREFIX):
            spans.append((name, e.get('tid'), ts, dur))
        elif cat == 'cpu_op':
            host.append((name, ts, dur))
        elif cat in RUNTIME_CATS:
            runtime.append((name, e.get('tid'), ts, dur, corr))
    if window is None:
        raise RuntimeError('the profiled window is missing from the trace')
    dev.sort(key=lambda s: s[1])
    return dict(device=dev, host=host, window=window, units=units,
                spans=spans, runtime=runtime, launched=launched)


class Owners:
    """The spans of a trace, and which of them an instant is put down
    to."""

    def __init__(self, tr: Dict):
        # a parent before a child that starts with it
        spans = sorted(tr.get('spans', []), key=lambda s: (s[2], -s[3]))
        self.names = [s[0] for s in spans]
        self.starts = [s[2] for s in spans]
        self.ends = [s[2] + s[3] for s in spans]
        # each span's own name and those of the spans it lies under
        self.chain: List[frozenset] = []
        for i in range(len(spans)):
            j = i - 1
            while j >= 0 and self.ends[j] <= self.starts[i]:
                j -= 1
            up = self.chain[j] if j >= 0 else frozenset()
            self.chain.append(up | {self.names[i]})

    def of(self, times: List[float]) -> List[int]:
        """For each instant, the index of the span it is put down to, or
        -1 where no span is open."""
        out = [-1] * len(times)
        active: List[int] = []
        k = 0
        for q in sorted(range(len(times)), key=times.__getitem__):
            t = times[q]
            while k < len(self.starts) and self.starts[k] <= t:
                active.append(k)
                k += 1
            # the latest-starting open span; one that closed before a
            # span that started earlier is dropped when it surfaces
            i = len(active) - 1
            while i >= 0 and self.ends[active[i]] <= t:
                del active[i]
                i -= 1
            out[q] = active[i] if i >= 0 else -1
        return out

    def name(self, i: int) -> str:
        return self.names[i] if i >= 0 else OUTSIDE

    def under(self, i: int, name: str) -> bool:
        """Whether span ``i`` is ``name`` or lies under a span named so."""
        return i >= 0 and name in self.chain[i]


def gaps(tr: Dict) -> List[tuple]:
    """The device's idle gaps in the window, as ``trace.idle_gaps`` cuts
    them: (start, end) in us."""
    lo, dur = tr['window']
    out, t = [], lo
    for a, b in _union(tr['device'], lo, lo + dur):
        if a > t:
            out.append((t, a))
        t = b
    if t < lo + dur:
        out.append((t, lo + dur))
    return out


def host_ms(tr: Dict, name: str) -> Optional[float]:
    """ms a unit inside the spans named ``name`` (their durations
    summed), or None where the trace has none."""
    durs = [s[3] for s in tr.get('spans', []) if s[0] == name]
    return sum(durs) / 1e3 / tr['units'] if durs else None


def launches(tr: Dict, name: str) -> Optional[float]:
    """Kernel launches a unit whose runtime call lies in a span named
    ``name`` or under one."""
    if not any(s[0] == name for s in tr.get('spans', [])):
        return None
    own = Owners(tr)
    calls = [r[2] for r in tr['runtime'] if r[0].startswith(LAUNCH)]
    return sum(own.under(i, name) for i in own.of(calls)) / tr['units']


def host_syncs(tr: Dict) -> Optional[float]:
    """Blocking runtime calls a unit inside any program span (those
    outside every span, such as the window's closing synchronise, are
    left out)."""
    if not tr.get('spans'):
        return None
    own = Owners(tr)
    calls = [r[2] for r in tr['runtime'] if r[0] in BLOCKING]
    return sum(i >= 0 for i in own.of(calls)) / tr['units']


def idle_ms(tr: Dict, name: str) -> Optional[float]:
    """The device's idle ms a unit whose gap begins in a span named
    ``name`` or under one."""
    if not any(s[0] == name for s in tr.get('spans', [])):
        return None
    own = Owners(tr)
    cut = gaps(tr)
    at = own.of([a for a, _ in cut])
    return sum(b - a for (a, b), i in zip(cut, at)
               if own.under(i, name)) / 1e3 / tr['units']


def table(tr: Dict) -> Dict[str, Dict[str, float]]:
    """By innermost span (``(outside)`` for none), a unit: ``host_ms``,
    the window's time it was innermost on any thread; ``launches`` and
    ``syncs``, runtime calls made in it; ``idle_ms``, the device's idle
    time whose gap began in it; ``device_ms`` and ``copy_ms``, the device
    time of the operations launched from it (``copy_ms``: those named
    ``*copy*`` or ``*memcpy*``: casts and copies)."""
    own = Owners(tr)
    lo, dur = tr['window']
    u = tr['units']
    rows = defaultdict(lambda: dict(host_ms=0.0, launches=0.0, syncs=0.0,
                                    idle_ms=0.0, device_ms=0.0,
                                    copy_ms=0.0))
    cuts = sorted({lo, lo + dur} | {t for t in own.starts + own.ends
                                    if lo < t < lo + dur})
    for (a, b), i in zip(zip(cuts, cuts[1:]), own.of(cuts[:-1])):
        rows[own.name(i)]['host_ms'] += (b - a) / 1e3 / u
    runtime = tr['runtime']
    at = own.of([r[2] for r in runtime])
    where = {}
    for r, i in zip(runtime, at):
        if r[0].startswith(LAUNCH):
            rows[own.name(i)]['launches'] += 1 / u
        elif r[0] in BLOCKING:
            rows[own.name(i)]['syncs'] += 1 / u
        if len(r) > 4 and r[4] is not None:
            where[r[4]] = own.name(i)
    cut = gaps(tr)
    for (a, b), i in zip(cut, own.of([a for a, _ in cut])):
        rows[own.name(i)]['idle_ms'] += (b - a) / 1e3 / u
    for name, _, d, corr in tr.get('launched', []):
        row = rows[where.get(corr, OUTSIDE)]
        row['device_ms'] += d / 1e3 / u
        if any(k in name.lower() for k in ('copy', 'memcpy')):
            row['copy_ms'] += d / 1e3 / u
    return {k: rows[k] for k in sorted(rows, key=lambda k: -rows[k]
                                       ['host_ms'])}


def readings(tr: Dict) -> Dict[str, float]:
    """What the spans give of a served request (where the trace has
    ``das.predict``) or of a training step (``das.train.step``): the
    head's host ms, launches and idle, the host syncs; the step's host
    ms, remat's and the optimizer's, the step's launches. Empty where the
    program has no spans."""
    names = {s[0] for s in tr.get('spans', [])}
    out = {}
    if 'das.predict' in names:
        out.update({'serve.head_host_ms': host_ms(tr, 'das.head'),
                    'serve.head_launches': launches(tr, 'das.head'),
                    'serve.head_idle_ms': idle_ms(tr, 'das.head'),
                    'serve.host_syncs': host_syncs(tr)})
    if 'das.train.step' in names:
        out.update({
            'train.step_host_ms': host_ms(tr, 'das.train.step'),
            'train.remat_host_ms': host_ms(tr, 'das.remat.recompute'),
            'train.optimizer_host_ms': host_ms(tr, 'das.train.optimizer'),
            'train.launches': launches(tr, 'das.train.step')})
    return {k: v for k, v in out.items() if v is not None}


def span_cost_ns(device: torch.device, n: int = 200000) -> Dict[str, float]:
    """ns for one ``span`` entered and left, with no profiler and under
    one that records the host and, on a card, the device."""
    from das_tpu_torch.utils.profiling import span

    def each(k):
        t0 = time.perf_counter()
        for _ in range(k):
            with span('das.cost'):
                pass
        return (time.perf_counter() - t0) / k * 1e9
    each(1000)
    off = each(n)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        each(1000)
        on = each(n // 10)
    return dict(off=off, on=on)


class SpanContext(run.Context):
    """The harness's context, its profiled window traced by ``profile``."""

    def profile(self, fn, units: int) -> Dict:
        return profile(fn, units, self.device)


def run_cell(root, workload: str, seed: int, seconds: float,
             device: str) -> Dict:
    """One traced run of ``workload`` through its driver: what ``main``
    prints, less the device."""
    from .trace import idle_pct
    spec = run.load_spec(root, workload)
    ctx = SpanContext(root, spec, seed, seconds, True, device)
    driver = importlib.import_module(
        f"dasbench.drivers.{spec['traffic']['driver']}")
    out = driver.run(ctx)
    rec, tr = out['record'], out['trace']
    if rec['kind'] == 'serve':
        untraced = rec['service_ms']
    else:
        untraced = rec['window']['seconds'] / rec['window']['units'] * 1e3
    checks = out['checks']
    return dict(
        workload=workload, seed=seed,
        correct=bool(out['attempted'] > 0 and out['failed'] == 0 and
                     all(v <= lim for _, v, lim in checks)),
        e2e=out['e2e'], idle_share=idle_pct(rec),
        traced_ms_a_unit=tr['window'][1] / 1e3 / tr['units'],
        untraced_ms_a_unit=untraced, units=tr['units'],
        spans_a_unit=len(tr['spans']) / tr['units'],
        readings=readings(tr), table=table(tr),
        span_cost_ns=span_cost_ns(ctx.device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ[var] = str(run.ROOT / 'build' / 'dasbench_cache' / sub)
    if not torch.cuda.is_available():
        print('dasbench.spans: needs a CUDA card', file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(run.ROOT, args.workload, args.seed, args.seconds,
                      'cuda')
    result['device'] = dict(kind=torch.cuda.get_device_name(0))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
