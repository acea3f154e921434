"""The readings that the limits of ``correct`` are set from, on the card:

    python -m dasbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults F,...] [--dtype float32] \
        [--seconds 2] [--out FILE]

In one process it builds the cell's program once and, for each of
``--seeds``, loads that seed's weights and inputs, drives the cell's own
path (a short window of requests at the cell's load; or the first
training steps) and prints the numbers ``dasbench.check`` compares. For
each of ``--control-seeds`` it prints the same numbers of the control,
the reference put in the program's place one precision lower
(``reference.precision.CONTROL``), and for a training cell also of the
fault "half of the batch left out, the mean taken over the rest" (the
reference on the first half of each batch), and of each of ``--faults``
planted in the program's sampler backward (``SAMPLER_FAULTS``). With
``--dtype`` the program computes in that type instead of the
configuration's, a second witness beside the reference. The benchmark's
own runs do not run this. One JSON line a reading; ``--out`` keeps them all.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

from . import check
from .drivers import serve, train
from .reference import precision
from .run import ROOT, Context, load_spec


def serve_readings(ctx, seeds, control_seeds, seconds):
    cell = serve.Cell(ctx)
    for seed in seeds:
        cell.load(seed)
        cell.request(-1)
        w = cell.window(seconds)
        nums = check.serve_numbers(ctx.config, seed, w['kept'], cell.pool,
                                   cell.sf, ctx.device)
        yield dict(kind='program', seed=seed, requests=len(w['lat']),
                   failed=w['bad'], **nums)
    for seed in control_seeds:
        cell.load(seed)
        rows = [cell.order[k] for k in range(int(cell.p['sample']))]
        samples = check.control_samples(ctx.config, seed, rows, cell.pool,
                                        cell.sf, ctx.device)
        yield dict(kind='control', seed=seed, **check.serve_numbers(
            ctx.config, seed, samples, cell.pool, cell.sf, ctx.device))


def sweep(ctx, seed, rates, seconds):
    """The serving path at each offered rate (requests/s, an open loop):
    the rate it completed, its latency's median and 95th percentile, in
    the window's first and second halves (a backlog that grows shows as
    a second half slower than the first), and the largest wait."""
    import numpy as np
    cell = serve.Cell(ctx)
    cell.load(seed)
    cell.request(-1)
    for rate in rates:
        w = cell.window(seconds, rate=rate)
        lat, secs, late = w['lat'], w['secs'], w['late']
        h = len(lat) // 2
        yield dict(kind='sweep', seed=seed, rate=rate,
                   completed_per_s=len(lat) / secs,
                   p50_ms=float(np.percentile(lat, 50)),
                   p95_ms=float(np.percentile(lat, 95)),
                   p95_first_half_ms=float(np.percentile(lat[:h], 95)),
                   p95_second_half_ms=float(np.percentile(lat[h:], 95)),
                   largest_wait_ms=late)


def _zero_image_gradient(bwd):
    def faulted(*a, **k):
        dflat, dx, dy = bwd(*a, **k)
        return (None if dflat is None else dflat.zero_()), dx, dy
    return faulted


def _swap_xy(bwd):
    def faulted(*a, **k):
        dflat, dx, dy = bwd(*a, **k)
        return dflat, dy, dx
    return faulted


# faults planted in the program's sampler backward (every DCN and RU
# sample of the step): its image gradient zeroed; its dx and dy swapped
SAMPLER_FAULTS = {'sampler_bwd_zero_image': _zero_image_gradient,
                  'sampler_bwd_swap_xy': _swap_xy}


@contextlib.contextmanager
def planted(fault: str):
    """The program's sampler backward (on the card and on the CPU) with
    ``fault`` planted, for the duration."""
    from das_tpu_torch.ops import gather
    names = ('sample_rows_bilinear_backward_cuda',
             'sample_rows_bilinear_backward_plain')
    real = {n: getattr(gather, n) for n in names}
    try:
        for n in names:
            setattr(gather, n, SAMPLER_FAULTS[fault](real[n]))
        yield
    finally:
        for n in names:
            setattr(gather, n, real[n])


def train_readings(ctx, seeds, control_seeds, seconds, faults=(),
                   steps=True):
    """With ``steps`` false, only ``sampler_bwd_gap`` (the reference's
    steps are not run)."""
    cell = train.Cell(ctx)
    n = int(cell.p['first_steps'])
    dev = ctx.device
    for seed in seeds:
        cell.load(seed)
        first = cell.first_steps()
        batches = cell.pool[:n]
        gap = check.sampler_backward_gap(first['sampler'], dev)
        if not steps:
            yield dict(kind='program', seed=seed, sampler_bwd_gap=gap,
                       shape=list(first['sampler']['grad'].shape))
        else:
            p0 = check.initial_params(ctx.config, seed, dev)
            ref = check.reference_steps(ctx.config, seed, batches, dev)
            nums = check.train_numbers(first, ref, p0)
            yield dict(kind='program', seed=seed, losses=first['losses'],
                       ref_losses=ref['losses'],
                       grad_norm=first['grad_norm'],
                       ref_grad_norm=ref['grad_norm'], sampler_bwd_gap=gap,
                       **nums)
        if seed not in control_seeds:
            continue
        yield dict(kind='control', seed=seed,
                   sampler_bwd_gap=check.sampler_backward_gap(
                       first['sampler'], dev, control=True),
                   **({} if not steps else check.train_numbers(
                       check.reference_steps(ctx.config, seed, batches, dev,
                                             precision.CONTROL), ref, p0)))
        if steps:
            yield dict(kind='half_batch', seed=seed, **check.train_numbers(
                check.reference_steps(ctx.config, seed, batches, dev,
                                      precision.EXACT, True), ref, p0))
        for fault in faults:
            cell.load(seed)
            with planted(fault):
                bad = cell.first_steps()
            yield dict(kind=fault, seed=seed,
                       sampler_bwd_gap=check.sampler_backward_gap(
                           bad['sampler'], dev),
                       **({} if not steps else
                          check.train_numbers(bad, ref, p0)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--sweep', default='',
                    help='offered rates (requests/s) to sweep instead')
    ap.add_argument('--out')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--faults', default='',
                    help='training: faults planted in the program on the '
                    'control seeds, of ' + ', '.join(SAMPLER_FAULTS))
    ap.add_argument('--sampler-only', action='store_true',
                    help='training: read only sampler_bwd_gap')
    ap.add_argument('--dtype', default='',
                    help="the program's compute dtype instead of the "
                    "configuration's (a witness)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    control = [int(s) for s in args.control_seeds.split(',') if s]
    spec = load_spec(ROOT, args.workload)
    if args.dtype:
        spec['config']['compute_dtype'] = args.dtype
    ctx = Context(ROOT, spec, seeds[0], args.seconds, False, args.device)
    kind = spec['traffic']['driver']
    if kind == 'train':
        # a training control reads the reference's steps of the same seed
        seeds += [s for s in control if s not in seeds]
    out = []
    rates = [float(r) for r in args.sweep.split(',') if r]
    faults = [f for f in args.faults.split(',') if f]
    if rates:
        lines = sweep(ctx, seeds[0], rates, args.seconds)
    elif kind == 'train':
        lines = train_readings(ctx, seeds, control, args.seconds, faults,
                               not args.sampler_only)
    else:
        lines = serve_readings(ctx, seeds, control, args.seconds)
    for r in lines:
        line = json.dumps(dict(workload=args.workload, **r), default=str)
        print(line, flush=True)
        out.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text('\n'.join(out) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
