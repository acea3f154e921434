"""``correct`` comes out false when the timed path is broken underneath a
run (the harness's look for a chip skipped, the tiny cells on the CPU),
once for each fault the cells can have, and when the control (the
reference one precision lower) takes the program's place. The one-chip
cells have no exchange between chips to leave out."""

import numpy as np
import pytest
import torch

import das_tpu_torch.apis.inference as inference
import das_tpu_torch.parallel as parallel
from dasbench import calibrate, check, run
from dasbench.drivers import serve
from dasbench.reference import precision
from dasbench.tests import tiny


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp('faults'))


def failed_checks(root, cell):
    r = run.execute(root, cell, 31337, 0.4, False, 'cpu')
    return r['correct'], [k for k, c in r['checks'].items()
                          if c['value'] > c['limit']]


def test_sound_runs_are_correct(root):
    for cell in ('tiny-serve', 'tiny-train'):
        assert failed_checks(root, cell) == (True, [])


def test_an_answer_altered_where_it_is_produced(root, monkeypatch):
    real = inference.results_to_host

    def shifted(decoded, paths):
        out = real(decoded, paths)
        out[0]['poses'] = out[0]['poses'] + 2.0
        return out
    monkeypatch.setattr(inference, 'results_to_host', shifted)
    ok, failed = failed_checks(root, 'tiny-serve')
    assert not ok and 'decode_gap_px' in failed


def test_a_served_batch_half_left_out(root, monkeypatch):
    """The second half of the frames is answered with the first half's
    people."""
    real = inference.results_to_host

    def halved(decoded, paths):
        out = real(decoded, paths)
        h = len(out) // 2
        return out[:h] + [dict(r) for r in out[:h]]
    monkeypatch.setattr(inference, 'results_to_host', halved)
    ok, failed = failed_checks(root, 'tiny-serve')
    assert not ok and 'decode_gap_px' in failed


def test_the_head_resamples_other_points(root):
    """The RU is handed other points than the decode ranks first: each
    index moved to the next point of the level."""
    from das_tpu_torch.models.recursive_update import RecursiveUpdateBranch

    def moved(mod, args):
        if isinstance(mod, RecursiveUpdateBranch) and len(args) > 2 \
                and args[2] is not None:
            n = args[1].shape[1] * args[1].shape[2]  # (N, H, W, 3J)
            return args[0], args[1], (args[2] + 1) % n
    hook = torch.nn.modules.module.register_module_forward_pre_hook(moved)
    try:
        ok, failed = failed_checks(root, 'tiny-serve')
    finally:
        hook.remove()
    assert not ok and 'select_gap' in failed


@pytest.mark.parametrize('fault', sorted(calibrate.SAMPLER_FAULTS))
def test_a_sampler_backward_broken(root, fault):
    """The bilinear sampler's backward (the DCN's and the RU's) with its
    image gradient zeroed, or its dx and dy swapped."""
    with calibrate.planted(fault):
        ok, failed = failed_checks(root, 'tiny-train')
    assert not ok and 'sampler_bwd_gap' in failed


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    real = parallel.make_train_step

    def frozen(*a, **k):
        step = real(*a, **k)

        def same(state, batch):
            saved = {n: t.clone() for n, t in
                     state.model.state_dict().items()}
            _, metrics = step(state, batch)
            state.model.load_state_dict(saved)
            return state, metrics
        return same
    monkeypatch.setattr(parallel, 'make_train_step', frozen)
    ok, failed = failed_checks(root, 'tiny-train')
    assert not ok and 'change_gap_median' in failed and 'bn_gap' in failed


def test_half_of_the_batch_left_out(root, monkeypatch):
    real = parallel.make_train_step

    def halved(*a, **k):
        step = real(*a, **k)

        def half(state, batch):
            n = batch['img'].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    monkeypatch.setattr(parallel, 'make_train_step', halved)
    ok, failed = failed_checks(root, 'tiny-train')
    assert not ok and 'bn_gap' in failed


def test_the_serving_control_fails(root):
    """The reference in the program's place, its convolutions in fp8 and
    its preprocessing and decode in bfloat16."""
    spec = run.load_spec(root, 'tiny-serve')
    ctx = run.Context(root, spec, 5, 0.0, False, 'cpu')
    cell = serve.Cell(ctx)
    cell.load(5)
    rows = [cell.order[k] for k in range(2)]
    samples = check.control_samples(ctx.config, 5, rows, cell.pool, cell.sf,
                                    'cpu')
    nums = check.serve_numbers(ctx.config, 5, samples, cell.pool, cell.sf,
                               'cpu')
    lim = ctx.config['limits']['serve']
    assert any(nums[k] > lim[k] for k in lim), nums


def test_the_training_control_fails(root):
    spec = run.load_spec(root, 'tiny-train')
    cfg = spec['config']
    gen = torch.Generator().manual_seed(3)
    from dasbench.drivers import train
    batches = [train.synthetic_batch(2, *cfg['train_hw'], tiny.J, 2, 3, gen,
                                     'cpu') for _ in range(3)]
    ref = check.reference_steps(cfg, 5, batches, 'cpu')
    ctl = check.reference_steps(cfg, 5, batches, 'cpu', precision.CONTROL)
    nums = check.train_numbers(ctl, ref, check.initial_params(cfg, 5, 'cpu'))
    lim = cfg['limits']['train']
    assert any(nums[k] > lim[k] for k in lim), nums


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([1.0, 1.06, 1.2, -448.0, 3e-3])
    q = precision.round_e4m3(t)
    assert q[0] == 1.0 and q[3] == -448.0
    assert abs(float(q[2]) - 1.25) < 1e-6
    assert np.isfinite(q.numpy()).all()


def test_precision_flags_are_restored():
    before = torch.backends.cuda.matmul.allow_tf32
    with precision.use(precision.CONTROL):
        assert precision.current().matmul == 'fp8'
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
