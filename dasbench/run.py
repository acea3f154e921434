"""Run one cell of the benchmark once:

    python -m dasbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``dasbench/configs/<name>.json``)
and a traffic mix (``dasbench/traffic/<name>.json``), which names its
driver (``dasbench/drivers/<driver>.py``); a per-layer metric is read by
``dasbench/metrics/<name>.py``. All are found by name.

The run needs a CUDA card (it exits non-zero without one, and never runs
on the CPU), loads and warms up the program, measures for ``--seconds``,
compares what the timed path produced with the plain reference, prints
each compared number beside its limit on standard error, and prints one
JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end ones, or with ``--trace 1`` the
per-layer ones), ``device`` and, when traced, ``breakdown``; the numbers
compared come last under ``checks``.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'das_tpu')


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def load_spec(root: Path, name: str) -> Dict:
    """The cell ``name`` with its configuration, traffic mix and the
    benchmark's metrics, found by name under ``root``."""
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    cell = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    config = json.loads((root / configs[cell['config']]['file']).read_text())
    traffic = json.loads(
        (root / 'dasbench' / 'traffic' / f"{cell['traffic']}.json")
        .read_text())
    return dict(bench=bench, cell=cell, config=config, traffic=traffic)


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    key = 'per_layer' if trace else 'end_to_end'
    return [m for m in bench[key] if cell in m.get('workloads', [cell])]


def read_metric(root: Path, name: str, record: Dict):
    """``dasbench/metrics/<name>.py``'s ``read(record)``: a number, or None
    where the record holds nothing for it."""
    path = root / 'dasbench' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'dasbench.metrics.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


class Context:
    """What a driver gets: the cell's data, the seed and window, the
    device, and the run's clocks and recordings."""

    def __init__(self, root: Path, spec: Dict, seed: int, seconds: float,
                 trace: bool, device):
        import torch
        self.torch = torch
        self.root, self.seed, self.seconds, self.trace = root, seed, \
            seconds, trace
        self.cell, self.config, self.traffic = spec['cell'], \
            spec['config'], spec['traffic']
        self.device = torch.device(device)
        self.setup_s = None

    def log(self, msg: str):
        print(f'[dasbench] {msg}', file=sys.stderr, flush=True)

    def sync(self):
        if self.device.type == 'cuda':
            self.torch.cuda.synchronize(self.device)

    def spans(self):
        from .trace import NoSpans, Spans
        return Spans(self.device) if self.trace else NoSpans(self.device)

    def open_window(self) -> float:
        """Set-up ends: synchronise and start the window's clock."""
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - START
        return t0

    def close_window(self):
        self.sync()

    def memory_peak(self) -> int:
        if self.device.type != 'cuda':
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def reset_peak(self):
        if self.device.type == 'cuda':
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def empty_cache(self):
        if self.device.type == 'cuda':
            self.torch.cuda.empty_cache()

    def profile(self, fn, units: int) -> Dict:
        from .trace import profile
        return profile(fn, units, self.device)


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str) -> Dict:
    """One run of ``workload``: the result line's object, less the device
    name and count, which the caller adds."""
    spec = load_spec(root, workload)
    ctx = Context(root, spec, seed, seconds, trace, device)
    driver = importlib.import_module(
        f"dasbench.drivers.{spec['traffic']['driver']}")
    out = driver.run(ctx)
    metrics = {}
    for m in cell_metrics(spec['bench'], workload, trace):
        value = out['e2e'].get(m['name']) if not trace else read_metric(
            root, m['name'], out['record'])
        if value is not None:
            metrics[m['name']] = dict(value=float(value), unit=m['unit'])
    for name, n in out['samples'].items():
        ctx.log(f'{name}: {n} samples')
    dev = dict(memory_peak_bytes=int(out['memory_peak_bytes']))
    result = dict(attempted=int(out['attempted']), failed=int(out['failed']),
                  metrics=metrics, device=dev)
    if trace:
        from . import trace as tr
        dev.update(busy_s=tr.busy_s(out['trace']),
                   window_s=tr.window_s(out['trace']))
        result['breakdown'] = dict(device_ops=tr.top_device_ops(out['trace']),
                                   idle_gaps=tr.idle_gaps(out['trace']))
    checks = out['checks']
    result['correct'] = bool(result['attempted'] > 0 and
                             result['failed'] == 0 and
                             all(v <= lim for _, v, lim in checks))
    result['checks'] = {n: dict(value=float(v), limit=float(lim))
                        for n, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(ROOT, args.workload)
    chips = int(spec['cell']['chips'])
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ[var] = str(ROOT / 'build' / 'dasbench_cache' / sub)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'dasbench: the cell needs {chips} CUDA card(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = execute(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), 'cuda')
    found = forbidden_modules()
    if found:
        print(f'dasbench: the run loaded {found}, which the port must not '
              'load', file=sys.stderr)
        return 3
    result['device'] = dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                            count=chips, **result['device'])
    checks = result.pop('checks')
    for name, c in checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    result['checks'] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
