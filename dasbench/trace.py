"""The traced run's recordings and their reduction: CUDA-event spans, and
a ``torch.profiler`` trace of a few steady requests or steps, read back
from its exported JSON (device intervals, host operations)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW = 'dasbench.window'


class Spans:
    """Named stream spans: ``mark(name)`` records a CUDA event (a host
    timestamp on the CPU); ``close(a, b, name)`` keeps the pair of the
    last two such marks; ``hook(module, name)`` marks ``name0`` and
    ``name1`` around each forward of a module and keeps that pair. Read
    after a synchronise."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.pairs: Dict[str, List] = defaultdict(list)
        self.marks: Dict[str, object] = {}
        self.handles = []

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks[name] = ev

    def close(self, start: str, end: str, name: str):
        if start in self.marks and end in self.marks:
            self.pairs[name].append((self.marks[start], self.marks[end]))

    def add_ms(self, name: str, ms: float):
        self.pairs[name].append(ms)

    def reset(self):
        self.pairs.clear()
        self.marks.clear()

    def hook(self, module, name: str):
        def before(mod, inp):
            self.mark(name + '0')

        def after(mod, inp, out):
            self.mark(name + '1')
            self.close(name + '0', name + '1', name)
        self.handles += [module.register_forward_pre_hook(before),
                         module.register_forward_hook(after)]

    def unhook(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def read_ms(self) -> Dict[str, List[float]]:
        out = {}
        for name, pairs in self.pairs.items():
            vals = []
            for p in pairs:
                if isinstance(p, float):
                    vals.append(p)
                elif self.cuda:
                    vals.append(p[0].elapsed_time(p[1]))
                else:
                    vals.append((p[1] - p[0]) * 1e3)
            out[name] = vals
        return out


class NoSpans(Spans):
    """Spans that record nothing: the untraced runs."""

    def mark(self, name: str):
        pass

    def close(self, start: str, end: str, name: str):
        pass

    def add_ms(self, name: str, ms: float):
        pass


def profile(fn: Callable[[int], None], units: int, device: torch.device
            ) -> Dict:
    """Run ``fn(i)`` for i < units under torch.profiler and return the
    trace: 'device' [(name, start_us, dur_us)], 'host' [(name, start_us,
    dur_us)], 'window' (start_us, dur_us) of the profiled region, which
    ends in a synchronise, and 'units'."""
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
    fd, path = tempfile.mkstemp(suffix='.json', prefix='dasbench_trace_')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    dev, host, window = [], [], None
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, name = e.get('cat', ''), e.get('name', '')
        span = (name, float(e['ts']), float(e.get('dur', 0.0)))
        if cat in DEVICE_CATS:
            dev.append(span)
        elif cat == 'user_annotation' and name == WINDOW:
            window = span[1:]
        elif cat == 'cpu_op':
            host.append(span)
    if window is None:
        raise RuntimeError('the profiled window is missing from the trace')
    dev.sort(key=lambda s: s[1])
    return dict(device=dev, host=host, window=window, units=units)


def _union(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    merged = []
    for _, ts, dur in spans:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(tr: Dict) -> float:
    """Seconds of the window in which some device operation ran."""
    lo, dur = tr['window']
    return sum(b - a for a, b in _union(tr['device'], lo, lo + dur)) / 1e6


def window_s(tr: Dict) -> float:
    return tr['window'][1] / 1e6


def kernel_s(tr: Dict, names: Tuple[str, ...]) -> float:
    """Device seconds of the operations whose name contains one of
    ``names``."""
    return sum(d for n, _, d in tr['device'] if any(k in n for k in names)) \
        / 1e6


def top_device_ops(tr: Dict, n: int = 10) -> List[List]:
    acc = defaultdict(float)
    for name, _, d in tr['device']:
        acc[name[:160]] += d / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Dict, n: int = 10) -> List[List]:
    """The device's idle time in the window, summed by what the host was
    doing when each gap began (the innermost host operation running then;
    'host python' where none was)."""
    lo, dur = tr['window']
    busy = _union(tr['device'], lo, lo + dur)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if t < lo + dur:
        gaps.append((t, lo + dur))
    host = sorted(tr['host'], key=lambda s: s[1])
    starts = [s[1] for s in host]
    acc = defaultdict(float)
    for a, b in gaps:
        label = 'host python'
        # the latest-starting host operation still running at a
        top = bisect.bisect_right(starts, a) - 1
        for i in range(top, max(-1, top - 4096), -1):
            name, ts, d = host[i]
            if ts + d >= a:
                label = name
                break
        acc[label[:160]] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def call_s(tr: Dict, kernel: str, before: str, after: str) -> float:
    """Device seconds of every launch of ``kernel`` together with the
    operation just before it whose name contains ``before`` and the one
    just after whose name contains ``after`` (the parts of one library
    call on one stream: a memset, the kernel, a cast)."""
    dev, total = tr['device'], 0.0
    for i, (name, _, d) in enumerate(dev):
        if kernel not in name:
            continue
        total += d
        if i > 0 and before in dev[i - 1][0]:
            total += dev[i - 1][2]
        if i + 1 < len(dev) and after in dev[i + 1][0]:
            total += dev[i + 1][2]
    return total / 1e6


def mean_span_ms(record: Dict, name: str):
    """The mean of a span over the traced window's requests, or None."""
    vals = record.get('spans', {}).get(name)
    return sum(vals) / len(vals) if vals else None


def idle_pct(record: Dict) -> float:
    tr = record['trace']
    return 100.0 * (1.0 - busy_s(tr) / window_s(tr))
