"""The port's hand kernels against their plain versions, and a train step
against the CPU's, on the card.

These tests need an NVIDIA GPU (sm_90) and nvcc; without them they skip.
They import neither JAX nor ``das_tpu``, so they also run where JAX is not
installed; there, skip the JAX test harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from das_tpu_torch.core.targets import get_targets
from das_tpu_torch.models import build_trainable_model
from das_tpu_torch.ops import (conv_gn, dcn_shift, deform_conv, gather,
                               oks_nms)
from das_tpu_torch.ops.deform_conv import modulated_deform_conv
from das_tpu_torch.ops.interp import sample_bilinear_abs as interp_sample
from das_tpu_torch.parallel import (TrainState, frozen_mask, make_lr_fn,
                                    make_optimizer, make_train_step,
                                    mspn_frozen_prefixes, param_groups)
from das_tpu_torch.tools.profile_train import synthetic_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(n, h, w, cin, cout, dt, dev, seed=0, spread=1.4, far=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g)
    off = (torch.rand(n, h, w, 18, generator=g) * 2 - 1) * spread
    if far:
        off = off.reshape(n, h, w, 9, 2)
        off[torch.rand(n, h, w, 9, generator=g) < 0.15] *= 5.0
        off = off.reshape(n, h, w, 18)
    mask = torch.sigmoid(torch.randn(n, h, w, 9, generator=g))
    wt = torch.randn(3, 3, cin, cout, generator=g) * 0.2
    b = torch.randn(cout, generator=g)
    return (x.to(dev, dt), off.to(dev), mask.to(dev, dt), wt.to(dev, dt),
            b.to(dev, dt))


@pytest.mark.parametrize('shape', [(2, 8, 6, 3, 5), (2, 8, 11, 4, 6),
                                   (1, 9, 7, 40, 130)])
@pytest.mark.parametrize('radius', [1, 2])
def test_dcn_shift_kernel_matches_plain_fp32(cuda, shape, radius):
    """fp32: kernel == plain version, atol 1e-4 (f32 FMA products; sums
    in another order)."""
    a = _inputs(*shape, torch.float32, cuda)
    before = dcn_shift.launches
    got = dcn_shift.deform_conv_shift(*a, radius=radius)
    torch.cuda.synchronize()
    assert dcn_shift.launches == before + 1
    want = dcn_shift.deform_conv_shift_plain(*a, radius=radius)
    assert (got - want).abs().max().item() <= 1e-4


def test_dcn_shift_kernel_matches_plain_bf16_serving_shape(cuda):
    """bf16 at the level-0 serving shape: max error <= 1e-2 x max|ref|
    (the tap tiles are the plain version's up to the double rounding of
    PyTorch's bf16 add; the f32 sums run in another order, so the bf16
    rounding of a sum can differ)."""
    a = list(_inputs(1, 160, 288, 256, 256, torch.bfloat16, cuda,
                     spread=0.8))
    a[3] = a[3] * 0.25
    got = dcn_shift.deform_conv_shift(*a, radius=1).float()
    want = dcn_shift.deform_conv_shift_plain(*a, radius=1).float()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


# the serving levels of a B=4 640x1152 request
LEVELS = [(160, 288), (80, 144), (40, 72), (20, 36)]
# (N, H, W, Cin, Cout, radius, takes the wgmma pass)
WGMMA_CASES = [(4, h, w, 256, 256, 1, 1) for h, w in LEVELS] + [
    (4, 80, 144, 256, 256, 2, 1), (4, 13, 21, 256, 256, 1, 1),
    (4, 13, 21, 256, 256, 2, 1), (2, 9, 7, 8, 16, 1, 0),
    (2, 13, 21, 72, 136, 2, 0), (1, 8, 16, 64, 64, 1, 1),
    (2, 13, 21, 128, 192, 1, 1), (2, 13, 21, 128, 192, 2, 1),
    (3, 5, 40, 192, 320, 1, 1), (2, 20, 36, 256, 128, 2, 1)]


@pytest.mark.parametrize('case', WGMMA_CASES)
def test_dcn_shift_wgmma_pass_matches_plain(cuda, case):
    """The wgmma pass at the four serving levels (B=4, 256 channels, r=1),
    at level 1 at r=2, on ragged patches, Cin of one to four 64-channel
    slices and Cout below, at and across a column block; and the WMMA pass
    where Cin is no multiple of 64: each call takes the pass its shapes
    name (the wgmma count moves with the launch count, or stays), max
    error <= 1e-2 x max|ref|, and two runs are equal bit for bit."""
    n, h, w, cin, cout, radius, takes = case
    a = list(_inputs(n, h, w, cin, cout, torch.bfloat16, cuda,
                     spread=0.8 * radius))
    a[3] = a[3] * 0.25
    before = dcn_shift.launches, dcn_shift.wgmma_launches
    got = dcn_shift.deform_conv_shift(*a, radius=radius)
    again = dcn_shift.deform_conv_shift(*a, radius=radius)
    torch.cuda.synchronize()
    assert (dcn_shift.launches, dcn_shift.wgmma_launches) == \
        (before[0] + 2, before[1] + 2 * takes)
    assert torch.equal(got, again)
    want = dcn_shift.deform_conv_shift_plain(*a, radius=radius).float()
    assert ((got.float() - want).abs().max() / want.abs().max()).item() \
        <= 1e-2


@pytest.mark.parametrize('hw,radius', [(hw, 1) for hw in LEVELS]
                         + [((80, 144), 2)])
def test_dcn_shift_wmma_pass_at_the_serving_levels(cuda, hw, radius):
    """The WMMA pass, which the serving shapes took before the wgmma pass,
    called by name on the same inputs (the library's
    ``dcn_shift_forward_pass``): max error <= 1e-2 x max|ref|."""
    x, off, mask, wt, b = _inputs(4, *hw, 256, 256, torch.bfloat16, cuda,
                                  spread=0.8 * radius)
    wt = wt * 0.25
    out = torch.empty_like(x)
    assert dcn_shift.LIB.load().dcn_shift_forward_pass(
        x.data_ptr(), off.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        b.data_ptr(), out.data_ptr(), *x.shape, 256, radius, 1, 1,
        torch.cuda.current_stream().cuda_stream) == 0
    want = dcn_shift.deform_conv_shift_plain(x, off, mask, wt, b,
                                             radius=radius).float()
    assert ((out.float() - want).abs().max() / want.abs().max()).item() \
        <= 1e-2


@pytest.mark.parametrize('case', ['offsets 0, mask 1', 'far negative x',
                                  'Cout 192', 'no bias'])
def test_dcn_shift_wgmma_pass_corner_cases(cuda, case):
    """One tap tile that is a plain 3x3 conv's (offsets 0, mask 1); far
    negative inputs, where a padded zero times a weight and a corner outside
    the image must agree; Cout across a column block; no bias. Max error
    <= 1e-2 x max|ref|."""
    x, off, mask, wt, b = _inputs(2, 13, 21, 128,
                                  192 if case == 'Cout 192' else 128,
                                  torch.bfloat16, cuda, spread=1.6)
    wt = wt * 0.25
    if case == 'offsets 0, mask 1':
        off, mask = torch.zeros_like(off), torch.ones_like(mask)
    if case == 'far negative x':
        x = -x.abs() - 100
    if case == 'no bias':
        b = None
    before = dcn_shift.wgmma_launches
    got = dcn_shift.deform_conv_shift(x, off, mask, wt, b).float()
    torch.cuda.synchronize()
    assert dcn_shift.wgmma_launches == before + 1
    want = dcn_shift.deform_conv_shift_plain(x, off, mask, wt, b).float()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


def test_dcn_shift_other_bf16_shapes_keep_off_the_wgmma_pass(cuda):
    """Cin or Cout no multiple of 64, or f32: the WMMA or the f32 kernel,
    and the wgmma count stays."""
    before = dcn_shift.wgmma_launches
    for shape, dt in [((2, 9, 7, 72, 136), torch.bfloat16),
                      ((2, 9, 7, 64, 72), torch.bfloat16),
                      ((2, 9, 7, 64, 64), torch.float32)]:
        a = _inputs(*shape, dt, cuda)
        got = dcn_shift.deform_conv_shift(*a).float()
        want = dcn_shift.deform_conv_shift_plain(*a).float()
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2
    assert dcn_shift.wgmma_launches == before


def test_hybrid_pallas_on_the_card_is_exact(cuda):
    """Kernel base + exact repair == the exact 'patch' gather, far
    offsets, fp32, atol 1e-4."""
    n, h, w = 2, 8, 6
    a = _inputs(n, h, w, 3, 5, torch.float32, cuda, far=True)
    got = modulated_deform_conv(*a, gather_mode='hybrid_pallas',
                                shift_radius=1, shift_budget=h * w)
    want = modulated_deform_conv(*a, gather_mode='patch')
    assert (got - want).abs().max().item() <= 1e-4


def test_dcn_shift_kernel_refuses_what_it_does_not_take(cuda):
    a = _inputs(1, 4, 4, 8, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        dcn_shift.deform_conv_shift(a[0].half(), *a[1:])
    with pytest.raises(ValueError):
        dcn_shift.deform_conv_shift(*a, radius=3)
    with pytest.raises(ValueError):
        dcn_shift.deform_conv_shift(a[0].transpose(1, 2), *a[1:])


# K1's backward: the kernel against the closed form. Both take U = G W^T
# from one product and the tile as the forward rounds it, and reduce in f32
# in other orders. f32: within 1e-5 of max|ref|. bf16: dx, dmask, dweight
# and dbias come back in bf16, where a sum the two sides take in another
# order can round to the neighbouring bf16 value, one step of the output
# type: within BWD_BF16_TOL = 2^-7 (bf16's spacing relative to a value in
# [1, 2)) of max|ref|; doffset (f32, from the same bf16 values) is held at
# the same bound.
# Cin 8 and 128 take the kernels' 16-byte loads; Cin 6 (no multiple of 8
# for bf16 nor of 4 for f32) takes one element a lane
BWD_SHAPES = [(2, 9, 7, 8, 16), (2, 13, 21, 128, 192), (2, 9, 7, 6, 16),
              (2, 13, 21, 64, 64)]
BWD_BF16_TOL = 2.0 ** -7
BWD_NAMES = ('dx', 'doffset', 'dmask', 'dweight', 'dbias')


def _bwd_inputs(shape, dt, dev, radius, case, seed=0):
    """x, offset (f32), mask, weight and an output gradient; offsets all 0,
    each exactly +-radius, next to the kinks, or spread past the radius."""
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g)
    if case == 'zero':
        off = torch.zeros(n, h, w, 18)
    elif case == 'at +-r':
        off = (torch.randint(0, 2, (n, h, w, 18), generator=g) * 2.0
               - 1.0) * radius
    elif case == 'next to the kinks':
        # within an ulp or two of 0, +-1 and +-r, where the displacement
        # i - d rounds onto a kink of the hat in f32
        near = torch.tensor([1 - 2 ** -24, -(1 - 2 ** -24), 2 ** -30,
                             -2 ** -30, 1 + 2 ** -23, -1 - 2 ** -23,
                             radius - 2 ** -22, -radius + 2 ** -22, 0.5])
        off = near[torch.randint(0, 9, (n, h, w, 18), generator=g)]
    else:
        off = (torch.rand(n, h, w, 18, generator=g) * 2 - 1) * 1.2 * radius
    mask = torch.sigmoid(torch.randn(n, h, w, 9, generator=g))
    wt = torch.randn(3, 3, cin, cout, generator=g) * (0.2 if cin < 64
                                                      else 0.05)
    gout = torch.randn(n, h, w, cout, generator=g)
    return (x.to(dev, dt), off.to(dev), mask.to(dev, dt), wt.to(dev, dt),
            gout.to(dev, dt))


def _bwd_close(got, want, dt, what):
    tol = 1e-5 if dt == torch.float32 else BWD_BF16_TOL
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (what, name, err)


@pytest.mark.parametrize('shape', BWD_SHAPES)
@pytest.mark.parametrize('case', ['zero', 'at +-r', 'next to the kinks',
                                  'generic'])
@pytest.mark.parametrize('radius', [1, 2])
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_dcn_shift_backward_kernel_matches_closed_form(cuda, shape, case,
                                                       radius, dt):
    """Each of dx, doffset, dmask, dweight and dbias from one backward
    call (one launch of the library: the tap kernel and the dx kernel)
    against ``deform_conv_shift_backward_plain`` on the same inputs."""
    x, off, mask, wt, g = _bwd_inputs(shape, dt, cuda, radius, case)
    before = dcn_shift.backward_launches
    got = dcn_shift.deform_conv_shift_backward_cuda(x, off, mask, wt, g,
                                                    radius)
    torch.cuda.synchronize()
    assert dcn_shift.backward_launches == before + 1
    want = dcn_shift.deform_conv_shift_backward_plain(x, off, mask, wt, g,
                                                      radius)
    _bwd_close(got, want, dt, (shape, case, radius, dt))


@pytest.mark.parametrize('radius', [1, 2])
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_dcn_shift_backward_kernel_unaligned_x(cuda, radius, dt):
    """An x that starts one element past a 16-byte boundary (Cin 8, which
    would take 16-byte loads) takes the one-element-a-lane kernels and
    still matches the closed form."""
    x, off, mask, wt, g = _bwd_inputs((2, 9, 7, 8, 16), dt, cuda, radius,
                                      'generic')
    x = torch.empty(x.numel() + 1, dtype=dt, device=cuda)[1:].view(
        x.shape).copy_(x)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = dcn_shift.deform_conv_shift_backward_cuda(x, off, mask, wt, g,
                                                    radius)
    want = dcn_shift.deform_conv_shift_backward_plain(x, off, mask, wt, g,
                                                      radius)
    _bwd_close(got, want, dt, ('unaligned', radius, dt))


# The tiled pass (bf16, Cin a multiple of 64, 16-byte aligned x, U, tile
# and dx): the patch-staged tap kernel beside the dx kernel that both
# passes share. H and W are no multiples of the 8 x 16 patch, so blocks
# hold partial patches.
TILED_SHAPES = [(2, 13, 21, 64, 64), (2, 9, 20, 128, 192)]
BWD_CASES = ['zero', 'at +-r', 'next to the kinks', 'generic']
# the four levels of a B=4 640x1344 train step, Cin = Cout = 256, r=1
TRAIN_LEVELS = [(4, h, w, 256, 256) for h, w in
                [(160, 336), (80, 168), (40, 84), (20, 42)]]


def _tiled_call(x, off, mask, u, radius, lanes):
    """One library call of the backward on the tiled (lanes=0) or the lane
    pass (lanes=1): (tile, doffset, dmask, dx) from x, offset, mask and U.
    The library reports the tiled tap kernel exactly where lanes=0."""
    N, H, W, Cin = x.shape
    P = N * H * W
    tile = torch.empty(P, 9 * Cin, dtype=x.dtype, device=x.device)
    doff = torch.empty(N, H, W, 18, device=x.device)
    dmask = torch.empty_like(mask)
    dx = torch.empty_like(x)
    tiled = ctypes.c_int(-1)
    err = dcn_shift.LIB.load().dcn_shift_backward_pass(
        x.data_ptr(), off.data_ptr(), mask.data_ptr(), u.data_ptr(),
        tile.data_ptr(), doff.data_ptr(), dmask.data_ptr(), dx.data_ptr(),
        N, H, W, Cin, radius, 1, lanes, ctypes.byref(tiled),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and tiled.value == 1 - lanes
    return tile, doff, dmask, dx


@pytest.mark.parametrize('shape,case,radius', [
    (s, c, r) for s in TILED_SHAPES for c in BWD_CASES for r in (1, 2)]
    + [(s, 'generic', 1) for s in TRAIN_LEVELS])
def test_dcn_shift_backward_tiled_pass_matches_closed_form(cuda, shape, case,
                                                           radius):
    """The tiled pass (it is the pass the call takes: the tiled count moves
    with the backward count) against the closed form: each output within
    2^-7 of max|ref|, as the lane pass is held; also at the four levels of
    a train step."""
    x, off, mask, wt, g = _bwd_inputs(shape, torch.bfloat16, cuda, radius,
                                      case)
    before = dcn_shift.backward_launches, dcn_shift.backward_tiled_launches
    got = dcn_shift.deform_conv_shift_backward_cuda(x, off, mask, wt, g,
                                                    radius)
    torch.cuda.synchronize()
    assert (dcn_shift.backward_launches, dcn_shift.backward_tiled_launches) \
        == (before[0] + 1, before[1] + 1)
    want = dcn_shift.deform_conv_shift_backward_plain(x, off, mask, wt, g,
                                                      radius)
    _bwd_close(got, want, torch.bfloat16, (shape, case, radius))


@pytest.mark.parametrize('shape,case,radius', [
    (s, c, r) for s in [(2, 13, 21, 64, 64), (2, 13, 21, 128, 192)]
    for c in BWD_CASES for r in (1, 2)]
    + [(s, 'generic', 1) for s in TRAIN_LEVELS])
def test_dcn_shift_backward_tiled_tile_and_dx_against_lanes(cuda, shape,
                                                            case, radius):
    """The tiled pass's tile equals the lane pass's value for value (the
    forward's rounding; TMA's zeros can only flip the sign of a zero); its
    dx is the same bits run after run, and the lane pass's bits (one dx
    kernel); dmask and doffset agree within 2^-7 and 1e-5 of max|lanes|
    (f32 sums in another order)."""
    n, h, w, cin, cout = shape
    x, off, mask, wt, g = _bwd_inputs((n, h, w, cin, cout), torch.bfloat16,
                                      cuda, radius, case)
    u = (g.reshape(-1, cout) @ wt.reshape(9 * cin, cout).t()).contiguous()
    tiled = _tiled_call(x, off, mask, u, radius, 0)
    again = _tiled_call(x, off, mask, u, radius, 0)
    lanes = _tiled_call(x, off, mask, u, radius, 1)
    assert torch.equal(tiled[0], lanes[0])
    assert torch.equal(tiled[3].view(torch.int16), again[3].view(torch.int16))
    assert torch.equal(tiled[3].view(torch.int16), lanes[3].view(torch.int16))
    for i, tol in ((1, 1e-5), (2, BWD_BF16_TOL)):
        err = (tiled[i].float() - lanes[i].float()).abs().max().item()
        assert err <= tol * lanes[i].float().abs().max().item(), (i, err)


def test_dcn_shift_backward_pass_by_shape(cuda):
    """The shapes alone pick the pass: f32, Cin 6 or 96 (no multiple of
    64) and an x off 16-byte alignment stay on the lane pass; bf16 Cin 64
    takes the tiled pass. Each still matches the closed form."""
    def counts():
        return dcn_shift.backward_launches, dcn_shift.backward_tiled_launches

    for shape, dt, unaligned, tiled in [
            ((2, 9, 7, 64, 16), torch.float32, False, 0),
            ((2, 9, 7, 6, 16), torch.bfloat16, False, 0),
            ((2, 9, 7, 96, 16), torch.bfloat16, False, 0),
            ((2, 9, 7, 64, 16), torch.bfloat16, True, 0),
            ((2, 9, 7, 64, 16), torch.bfloat16, False, 1)]:
        x, off, mask, wt, g = _bwd_inputs(shape, dt, cuda, 1, 'generic')
        if unaligned:
            x = torch.empty(x.numel() + 1, dtype=dt, device=cuda)[1:].view(
                x.shape).copy_(x)
        before = counts()
        got = dcn_shift.deform_conv_shift_backward_cuda(x, off, mask, wt, g,
                                                        1)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + tiled), (shape, dt)
        want = dcn_shift.deform_conv_shift_backward_plain(x, off, mask, wt,
                                                          g, 1)
        _bwd_close(got, want, dt, (shape, dt, unaligned))


def test_dcn_shift_backward_tiled_failure_raises(cuda, monkeypatch):
    """A call the tiled pass takes whose launch fails raises; nothing gives
    way to the lane pass. The library refuses radius 3 on the tiled shapes;
    and a failing launch (the library's return replaced by an error) makes
    the wrapper raise after one library call, with no count moved."""
    x, off, mask, wt, g = _bwd_inputs(TILED_SHAPES[0], torch.bfloat16, cuda,
                                      1, 'generic')
    n, h, w, cin, cout = TILED_SHAPES[0]
    u = (g.reshape(-1, cout) @ wt.reshape(9 * cin, cout).t()).contiguous()
    lib = dcn_shift.LIB.load()
    dx = torch.empty_like(x)
    assert lib.dcn_shift_backward_pass(
        x.data_ptr(), off.data_ptr(), mask.data_ptr(), u.data_ptr(), None,
        None, None, dx.data_ptr(), n, h, w, cin, 3, 1, 0, None,
        torch.cuda.current_stream().cuda_stream) != 0
    calls = []

    class Failing:
        def __getattr__(self, name):
            return getattr(lib, name)

        def dcn_shift_backward(self, *args):
            calls.append(args)
            return 1

    monkeypatch.setattr(dcn_shift.LIB, 'load', lambda: Failing())
    before = dcn_shift.backward_launches, dcn_shift.backward_tiled_launches
    with pytest.raises(RuntimeError):
        dcn_shift.deform_conv_shift_backward_cuda(x, off, mask, wt, g, 1)
    assert len(calls) == 1
    assert (dcn_shift.backward_launches,
            dcn_shift.backward_tiled_launches) == before


@pytest.mark.parametrize('variant', ['all', 'x without a gradient',
                                     'bias None'])
def test_shift_on_the_card_runs_k1_forward_and_backward(cuda, variant):
    """``'shift'`` (the training lowering) on CUDA tensors under autograd:
    one K1 forward launch, one backward call, gradients equal to the
    closed form's on the same inputs (f32, 1e-5 of max|ref|); a leaf that
    asks for no gradient gets none."""
    x, off, mask, wt, g = _bwd_inputs((2, 10, 12, 16, 8), torch.float32,
                                      cuda, 1, 'at +-r')
    bias = None if variant == 'bias None' else \
        torch.randn(8, device=cuda, requires_grad=True)
    leaves = [x, off, mask, wt]
    for t in leaves:
        t.requires_grad_(not (t is x and variant == 'x without a gradient'))
    f0, b0 = dcn_shift.launches, dcn_shift.backward_launches
    out = modulated_deform_conv(x, off, mask, wt, bias, gather_mode='shift',
                                shift_radius=1)
    assert out.grad_fn.name() == 'DeformConvShiftBackward'
    out.backward(g)
    torch.cuda.synchronize()
    assert (dcn_shift.launches - f0, dcn_shift.backward_launches - b0) == \
        (1, 1)
    want = dcn_shift.deform_conv_shift_backward_plain(
        x.detach(), off.detach(), mask.detach(), wt.detach(), g, 1)
    if variant == 'x without a gradient':
        assert x.grad is None
    got = [x.grad if x.grad is not None else want[0], off.grad, mask.grad,
           wt.grad, bias.grad if bias is not None else want[4]]
    _bwd_close(got, want, torch.float32, variant)


def test_shift_on_the_card_takes_no_plain_path(cuda):
    """A CUDA ``'shift'`` or ``'hybrid'`` call the kernel does not take
    raises instead of running the plain expansion."""
    a = _inputs(1, 4, 4, 8, 8, torch.float32, cuda)
    for mode in ('shift', 'hybrid'):
        with pytest.raises(ValueError):
            modulated_deform_conv(*a, gather_mode=mode, shift_radius=3)
        with pytest.raises(TypeError):
            modulated_deform_conv(a[0].half(), *a[1:], gather_mode=mode,
                                  shift_radius=1)


def _convgn_inputs(n, h, w, cin, cout, dt, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g)
    wt = torch.randn(3, 3, cin, cout, generator=g) * 0.05
    gamma = torch.rand(cout, generator=g) + 0.5
    beta = torch.randn(cout, generator=g) * 0.1
    return x.to(dev, dt), wt.to(dev, dt), gamma.to(dev), beta.to(dev)


# tests/test_ops.py:474-475 as (n, h, w, cin, cout, groups), and element-path
# shapes: Cin or Cout not a multiple of 8, a ragged last pixel tile; then
# shapes for the bf16 wgmma pass: ragged 8 x 16 patches, Cin across a
# 64-channel slice, Cout across a 256-channel column block
CONVGN_SHAPES = [(2, 8, 16, 8, 8, 4), (2, 10, 18, 32, 64, 8),
                 (2, 20, 36, 64, 64, 32), (1, 9, 7, 3, 6, 3),
                 (2, 5, 11, 12, 130, 13), (2, 13, 21, 72, 136, 17),
                 (1, 7, 40, 128, 264, 33), (2, 7, 40, 128, 256, 32),
                 (2, 9, 7, 3, 6, 3)]


@pytest.mark.parametrize('shape', CONVGN_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_conv_gn_kernel_matches_plain(cuda, shape, dt):
    """fp32: kernel == plain version, atol 2e-5 (f32 FMA products, sums in
    another order). bf16: max error <= 1e-2 x max|ref| (the f32 results
    differ by summation order, so a bf16 rounding can differ by a step)."""
    n, h, w, cin, cout, groups = shape
    a = _convgn_inputs(n, h, w, cin, cout, dt, cuda)
    before = conv_gn.launches
    got = conv_gn.conv_gn_relu(*a, groups=groups)
    torch.cuda.synchronize()
    assert conv_gn.launches == before + 1
    assert got.dtype == dt and got.shape == (n, h, w, cout)
    want = conv_gn.conv_gn_relu_plain(*a, groups=groups)
    err = (got.float() - want.float()).abs().max().item()
    if dt == torch.float32:
        assert err <= 2e-5
    else:
        assert err <= 1e-2 * want.float().abs().max().item()
    # per-block partial sums in fixed slots, no atomics: a run repeats
    assert torch.equal(got, conv_gn.conv_gn_relu(*a, groups=groups))


@pytest.mark.parametrize('cout', [256, 64])
@pytest.mark.parametrize('hw', [(160, 288), (80, 144), (40, 72), (20, 36)])
def test_conv_gn_kernel_matches_plain_bf16_serving_width(cuda, cout, hw):
    """bf16 at the head's widths (256 -> 256 and 256 -> 64, 32 groups) on the
    four levels of a B=4 640x1152 request, where the conv pass runs wgmma
    fed by TMA: max error <= 1e-2 x max|ref|, two runs equal bit for bit."""
    a = _convgn_inputs(4, *hw, 256, cout, torch.bfloat16, cuda, seed=1)
    got = conv_gn.conv_gn_relu(*a, groups=32)
    assert torch.equal(got, conv_gn.conv_gn_relu(*a, groups=32))
    want = conv_gn.conv_gn_relu_plain(*a, groups=32).float()
    assert ((got.float() - want).abs().max() / want.abs().max()).item() \
        <= 1e-2


def test_conv_gn_kernel_refuses_what_it_does_not_take(cuda):
    a = _convgn_inputs(1, 4, 4, 8, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        conv_gn.conv_gn_relu(a[0].half(), *a[1:], groups=4)
    with pytest.raises(ValueError):
        conv_gn.conv_gn_relu(a[0].transpose(1, 2), *a[1:], groups=4)
    with pytest.raises(ValueError):
        conv_gn.conv_gn_relu(*a, groups=3)
    with pytest.raises(ValueError):
        conv_gn.conv_gn_relu(a[0], a[1][:2], *a[2:], groups=4)


def _nms_inputs(B, M, J, dev, seed=0):
    """Candidates with near duplicates (every third pose is a jittered copy
    of one before it), areas of the poses' boxes, ~90% valid."""
    rng = np.random.RandomState(seed)
    kpts = rng.rand(B, M, J, 2).astype(np.float32) * 60
    kpts[:, 1::3] = kpts[:, 0::3][:, :kpts[:, 1::3].shape[1]] + \
        rng.randn(*kpts[:, 1::3].shape).astype(np.float32)
    areas = ((kpts[..., 0].max(-1) - kpts[..., 0].min(-1)) *
             (kpts[..., 1].max(-1) - kpts[..., 1].min(-1)))
    valid = rng.rand(B, M) < 0.9
    return (torch.from_numpy(kpts).to(dev), torch.from_numpy(areas).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize('B,M,J', [(1, 48, 15), (1, 16, 4), (2, 130, 17),
                                   (4, 3720, 15), (2, 777, 17), (3, 64, 15)])
def test_oks_nms_kernel_matches_plain(cuda, B, M, J):
    """The keep mask equals the plain version's bit for bit (the same
    expression order for sim, no fused multiply-add)."""
    kpts, areas, valid = _nms_inputs(B, M, J, cuda)
    sig = oks_nms.default_sigmas(J)
    before = oks_nms.launches
    got = oks_nms.oks_nms_keep(kpts, areas, valid, 0.9, sig)
    torch.cuda.synchronize()
    assert oks_nms.launches == before + 1
    want = oks_nms.oks_nms_keep_plain(kpts, areas, valid, 0.9, sig)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < B * M


@pytest.mark.parametrize('B,M,J', [(1, 16, 4), (3, 64, 15), (2, 777, 17),
                                   (4, 3720, 15), (1, 48, 15)])
def test_oks_nms_kernel_max_keep_and_ragged_m(cuda, B, M, J):
    """M below 64, one block exactly, no multiple of 64 and a request's M:
    with max_keep=k the mask is the first k kept of the plain version's
    full mask, bit for bit."""
    kpts, areas, valid = _nms_inputs(B, M, J, cuda, seed=2)
    sig = oks_nms.default_sigmas(J)
    want = oks_nms.oks_nms_keep_plain(kpts, areas, valid, 0.9, sig)
    assert torch.equal(oks_nms.oks_nms_keep(kpts, areas, valid, 0.9, sig),
                       want)
    for k in (0, 1, 7, 100, M):
        got = oks_nms.oks_nms_keep(kpts, areas, valid, 0.9, sig, max_keep=k)
        assert torch.equal(got, want & (want.cumsum(-1) <= k)), k
        plain = oks_nms.oks_nms_keep_plain(kpts, areas, valid, 0.9, sig,
                                           max_keep=k)
        assert torch.equal(got, plain), k


@pytest.mark.parametrize('B,M,J', [(2, 200, 17), (4, 3720, 15)])
def test_oks_nms_sorted_on_the_card_matches_fixed(cuda, B, M, J):
    """The decode's hard NMS on the card (sort, K3 with max_keep, top-k; one
    kernel launch) against oks_nms_fixed on the card: the same indices and
    validity. Scores are distinct, so no tie can swap."""
    kpts, areas, valid = _nms_inputs(B, M, J, cuda, seed=3)
    g = torch.Generator().manual_seed(5)
    scores = torch.stack([torch.randperm(M, generator=g) for _ in range(B)]) \
        .float().to(cuda) / M
    sig = oks_nms.default_sigmas(J)
    before = oks_nms.launches
    idx, ok = oks_nms.oks_nms_sorted(kpts, scores, areas, valid, 0.9, sig,
                                     max_dets=100)
    torch.cuda.synchronize()
    assert oks_nms.launches == before + 1
    fidx, fok = oks_nms.oks_nms_fixed(kpts, scores, areas, valid, 0.9, sig,
                                      max_dets=100)
    assert torch.equal(ok, fok) and torch.equal(idx, fidx)
    assert int(ok.sum()) == 100 * B


def test_oks_nms_kernel_refuses_what_it_does_not_take(cuda):
    kpts, areas, valid = _nms_inputs(1, 20, 15, cuda)
    sig = oks_nms.default_sigmas(15)
    with pytest.raises(TypeError):
        oks_nms.oks_nms_keep(kpts.double(), areas, valid, 0.9, sig)
    with pytest.raises(TypeError):
        oks_nms.oks_nms_keep(kpts, areas, valid.float(), 0.9, sig)
    with pytest.raises(ValueError):
        oks_nms.oks_nms_keep(kpts, areas[:, :5], valid, 0.9, sig)
    with pytest.raises(ValueError):
        oks_nms.oks_nms_keep(kpts, areas, valid, 0.9, sig[:3])
    with pytest.raises(ValueError):
        oks_nms.oks_nms_keep(kpts, areas, valid, 0.9, sig, max_keep=-2)


def test_oks_nms_sorted_on_the_card_refuses_past_its_cap(cuda):
    """The kernel's limit is MAX_CANDIDATES (what oks_nms.cu reports):
    oks_nms_sorted takes that many candidates on the card and raises past
    it, and past MAX_JOINTS joints, before any launch."""
    cap = oks_nms.LIB.load().oks_nms_max_candidates()
    assert cap == oks_nms.MAX_CANDIDATES == 12608
    sig = oks_nms.default_sigmas(15)
    for M in (cap, cap + 1):
        kpts, areas, valid = _nms_inputs(1, M, 15, cuda, seed=4)
        scores = torch.rand(1, M, device=cuda)
        before = oks_nms.launches
        if M > cap:
            with pytest.raises(ValueError, match='candidates'):
                oks_nms.oks_nms_sorted(kpts, scores, areas, valid, 0.9, sig,
                                       max_dets=100)
            assert oks_nms.launches == before
        else:
            _, ok = oks_nms.oks_nms_sorted(kpts, scores, areas, valid, 0.9,
                                           sig, max_dets=100)
            assert oks_nms.launches == before + 1 and int(ok.sum()) == 100
    kpts, areas, valid = _nms_inputs(1, 64, 33, cuda)
    with pytest.raises(ValueError, match='joints'):
        oks_nms.oks_nms_sorted(kpts, torch.rand(1, 64, device=cuda), areas,
                               valid, 0.9, np.full(33, 0.05), max_dets=10)


# (N, R, C, P, index type): the probe's shape
# (tools/analysis_tools/pallas_gather_probe.py:26-28); the RU's at levels 0
# and 1 of a served B=4 640x1152 request (60 = B x J tables: take_at of uvd
# C=3 and of the offsets C=8 at K=1000 points, the [uvd, conf] corners C=6
# at 8000) and of a B=4 640x1344 train step (K = max_pos = 512, and all
# four corners at once); the repair's at budget 2048 on 256-channel maps;
# and indices past both ends
GATHER_SHAPES = [(1, 11520, 128, 11520, torch.int32),
                 (60, 11520, 3, 1000, torch.int64),
                 (60, 11520, 8, 1000, torch.int64),
                 (60, 11520, 6, 8000, torch.int64),
                 (60, 13440, 3, 512, torch.int64),
                 (60, 13440, 8, 512, torch.int64),
                 (60, 13440, 6, 4096, torch.int64),
                 (4, 11520, 256, 2048, torch.int64),
                 (2, 1000, 8, 3000, torch.int32),
                 (2, 1000, 6, 3000, torch.int64),
                 (60, 46080, 3, 1000, torch.int64),
                 (60, 46080, 8, 1000, torch.int64),
                 (60, 46080, 6, 8000, torch.int64),
                 (60, 53760, 3, 512, torch.int64),
                 (60, 53760, 8, 512, torch.int64),
                 (60, 53760, 6, 4096, torch.int64),
                 (60, 53760, 8, 4 * 512, torch.int64),
                 (60, 53760, 6, 4 * 4096, torch.int64),
                 (4, 46080, 256, 2048, torch.int64)]


@pytest.mark.parametrize('shape', GATHER_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_gather_rows_kernel_matches_plain(cuda, shape, dt):
    """The forward equals the plain version bit for bit (a copy); the
    backward matches the plain scatter-add within 1e-5 x max|ref| in f32
    and 2^-7 x max|ref| (one bf16 step) in bf16 (f32 atomics in another
    order)."""
    N, R, C, P, itype = shape
    g = torch.Generator().manual_seed(0)
    lo, hi = (-R // 2, R + R // 2) if R == 1000 else (0, R)
    idx = torch.randint(lo, hi, (N, P), generator=g).to(itype).to(cuda)
    table = torch.randn(N, R, C, generator=g).to(cuda, dt)
    ct = torch.randn(N, P, C, generator=g).to(cuda, dt)
    before = gather.launches, gather.backward_launches
    t = table.clone().requires_grad_()
    got = gather.gather_rows(t, idx)
    got.backward(ct)
    torch.cuda.synchronize()
    assert (gather.launches, gather.backward_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    want = gather.scatter_rows_plain(ct, idx, R, dt).float()
    tol = 1e-5 if dt == torch.float32 else 2.0 ** -7
    assert t.grad.dtype == dt
    assert (t.grad.float() - want).abs().max() <= tol * want.abs().max()


def test_gather_rows_kernel_refuses_what_it_does_not_take(cuda):
    table = torch.randn(2, 10, 4, device=cuda)
    idx = torch.zeros(2, 3, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        gather.gather_rows(table.half(), idx)
    with pytest.raises(TypeError):
        gather.gather_rows(table, idx.float())
    with pytest.raises(ValueError):
        gather.gather_rows(table.transpose(1, 2), idx)
    with pytest.raises(ValueError):
        gather.gather_rows(table, idx[:1])


# (N, [(R, C, P)]): the RU's take_at at levels 1 and 0 of a served request
# and of a train step, four segments of which the first and third are one
# table, and two segments of small tables (indices past both ends)
GROUPED_SHAPES = [(60, [(11520, 3, 1000), (11520, 8, 1000)]),
                  (60, [(13440, 3, 512), (13440, 8, 512)]),
                  (4, [(11520, 256, 2048), (2880, 6, 300), (11520, 256, 700),
                       (720, 7, 5000)]),
                  (60, [(46080, 3, 1000), (46080, 8, 1000)]),
                  (60, [(53760, 3, 512), (53760, 8, 512)]),
                  (2, [(1000, 8, 3000), (1000, 6, 3000)])]


@pytest.mark.parametrize('shape', GROUPED_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_grouped_gather_kernel_matches_plain(cuda, shape, dt):
    """One launch for all segments and one for all their gradients: the
    forward equals the plain version bit for bit, each table's gradient
    matches the plain one within 1e-5 x max|ref| in f32 and 2^-7 x max|ref|
    in bf16 (f32 atomics in another order); a table gathered twice gets the
    sum of both."""
    N, segs = shape
    g = torch.Generator().manual_seed(0)
    tables, idxs, cts = [], [], []
    for s, (R, C, P) in enumerate(segs):
        if len(segs) == 4 and s == 2:
            tables.append(tables[0])
        else:
            tables.append(torch.randn(N, R, C, generator=g).to(cuda, dt)
                          .requires_grad_())
        idxs.append(torch.randint(-R // 4, R + R // 4, (N, P), generator=g)
                    .to(torch.int32 if s % 2 else torch.int64).to(cuda))
        cts.append(torch.randn(N, P, C, generator=g).to(cuda, dt))
    before = gather.launches, gather.backward_launches
    got = gather.gather_rows_grouped(tables, idxs)
    torch.autograd.backward(got, cts)
    torch.cuda.synchronize()
    assert (gather.launches, gather.backward_launches) == \
        (before[0] + 1, before[1] + 1)
    plain = [t.detach() for t in tables]
    for o, w in zip(got, gather.gather_grouped_plain(plain, idxs)):
        assert torch.equal(o, w)
    uniq = [t for s, t in enumerate(tables) if not (len(segs) == 4 and s == 2)]
    which = [next(u for u, t in enumerate(uniq) if t is tab)
             for tab in tables]
    want = gather.scatter_grouped_plain(cts, idxs, which,
                                        [t.shape[1] for t in uniq],
                                        [dt] * len(uniq))
    tol = 1e-5 if dt == torch.float32 else 2.0 ** -7
    for t, w in zip(uniq, want):
        assert t.grad.dtype == dt
        assert (t.grad.float() - w.float()).abs().max() \
            <= tol * w.float().abs().max()


# (N, H, W, C, P): the RU's samples at levels 1 and 0 of a served request
# and its dense level 3, the uvd field alone, and the hybrid repair's nine
# taps at levels 1 and 0
SAMPLER_SHAPES = [(60, 80, 144, 8, 1000), (60, 80, 144, 6, 8000),
                  (60, 20, 36, 6, 5760), (60, 80, 144, 3, 1000),
                  (4, 80, 144, 256, 9 * 2048), (60, 160, 288, 8, 1000),
                  (60, 160, 288, 6, 8000), (60, 20, 36, 8, 720),
                  (4, 160, 288, 256, 9 * 2048)]


@pytest.mark.parametrize('shape', SAMPLER_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_fused_sampler_kernel_matches_plain_bit_for_bit(cuda, shape, dt):
    """One launch per sample, equal bit for bit to the plain composition
    (torch elementwise weights around the plain row gather), with points
    outside the image and whole coordinates on and past its border; under
    autograd the same one launch (the sampler's Function) and no row
    gather."""
    N, H, W, C, P = shape
    g = torch.Generator().manual_seed(0)
    x = torch.rand(N, P, generator=g) * (W + 3) - 2
    y = torch.rand(N, P, generator=g) * (H + 3) - 2
    x[:, :36] = torch.tensor([-1.0, 0.0, W - 1.0, float(W), -0.5, W - 0.5]) \
        .repeat_interleave(6)
    y[:, :36] = torch.tensor([-1.0, 0.0, H - 1.0, float(H), -0.5, H - 0.5]) \
        .repeat(6)
    x, y = x.to(cuda), y.to(cuda)
    flat = torch.randn(N, H * W, C, generator=g).to(cuda, dt)
    before = gather.sampler_launches, gather.launches
    got = gather.sample_rows_bilinear(flat, x, y, H, W)
    torch.cuda.synchronize()
    assert (gather.sampler_launches, gather.launches) == \
        (before[0] + 1, before[1])
    want = gather.sample_rows_bilinear_plain(flat, x, y, H, W,
                                             gather=gather.gather_rows_plain)
    assert torch.equal(got, want)
    leaf = flat.clone().requires_grad_()
    out = gather.sample_rows_bilinear(leaf, x, y, H, W)
    assert (gather.sampler_launches, gather.launches) == \
        (before[0] + 2, before[1])
    assert torch.equal(out, want)


# (N, H, W, C, P): exp_panoptic's level-0 DCN of a served B=4 640x1152
# request (nine taps of 160x288 pixels) and a ragged one (odd sizes, 40
# channels, a point count that is no multiple of nine)
MASKED_SHAPES = [(4, 160, 288, 256, 9 * 46080), (3, 13, 21, 40, 2459)]


@pytest.mark.parametrize('shape', MASKED_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_masked_sampler_kernel_is_the_unmasked_kernel_times_mask(cuda, shape,
                                                                 dt):
    """The masked instance of the fused sampler == the unmasked kernel then
    ``* mask[..., None]``, and == the plain sampler then the product, bit
    for bit, with points outside the image and on its border; one launch,
    counted as a sample and as a masked one."""
    N, H, W, C, P = shape
    g = torch.Generator().manual_seed(1)
    x = torch.rand(N, P, generator=g) * (W + 3) - 2
    y = torch.rand(N, P, generator=g) * (H + 3) - 2
    x[:, :36] = torch.tensor([-1.0, 0.0, W - 1.0, float(W), -0.5, W - 0.5]) \
        .repeat_interleave(6)
    y[:, :36] = torch.tensor([-1.0, 0.0, H - 1.0, float(H), -0.5, H - 0.5]) \
        .repeat(6)
    x, y = x.to(cuda), y.to(cuda)
    flat = torch.randn(N, H * W, C, generator=g).to(cuda, dt)
    mask = torch.sigmoid(torch.randn(N, P, generator=g)).to(cuda, dt)
    before = gather.sampler_launches, gather.sampler_masked_launches
    got = gather.sample_rows_bilinear(flat, x, y, H, W, mask)
    torch.cuda.synchronize()
    assert (gather.sampler_launches, gather.sampler_masked_launches) == \
        (before[0] + 1, before[1] + 1)
    want = gather.sample_rows_bilinear(flat, x, y, H, W) * mask[..., None]
    assert torch.equal(got, want)
    del want
    assert torch.equal(got, gather._sample_plain(flat, x, y, H, W, mask))


def test_eval_dcn_im2col_no_less_precise_than_per_tap(cuda):
    """The eval DCN on the card in bf16 (one masked sample, one matmul that
    sums in f32) against the f64 DCN of the same bf16 inputs: its relative
    L2 error is no larger than the per-tap route's (nine bf16 products,
    contractions and sums), with and without bias, at exp_panoptic's
    level-2 width and an odd size."""
    x, off, mask, wt, b = _inputs(2, 41, 73, 256, 256, torch.bfloat16, cuda,
                                  seed=3)
    for bias in (b, None):
        args = (x, off, mask, wt, bias)
        with torch.inference_mode():
            before = gather.sampler_masked_launches
            got = modulated_deform_conv(*args, gather_mode='patch')
            assert gather.sampler_masked_launches == before + 1
            per_tap = deform_conv._deform_conv_per_tap(*args, 3, 1)
        ref = deform_conv._deform_conv_per_tap(
            *[None if a is None else a.cpu().double() for a in args], 3, 1)

        def rel(out):
            return float((out.cpu().double() - ref).norm() / ref.norm())
        assert rel(got) <= rel(per_tap), (rel(got), rel(per_tap))


@pytest.mark.parametrize('cfg, hw, samples, masked', [
    ('configs/das/exp_panoptic.py', (640, 1152), 24, 16),
    ('configs/das/exp_mupots.py', (736, 1280), 36, 20)])
def test_full_width_eval_request_masked_samples(cuda, cfg, hw, samples,
                                                masked):
    """One full-width B=4 bf16 eval request of the recipe: every DCN call
    (three towers and each RU layer's update conv at four levels) one
    masked sample, the RU's own samples unmasked."""
    from das_tpu_torch.config import Config
    from das_tpu_torch.models import build_model
    model = build_model(dict(Config.fromfile(cfg).model),
                        dtype=torch.bfloat16, device=cuda)
    img = torch.randn(4, *hw, 3, device=cuda)
    before = gather.sampler_launches, gather.sampler_masked_launches
    with torch.inference_mode():
        model(img)
    torch.cuda.synchronize()
    assert (gather.sampler_launches - before[0],
            gather.sampler_masked_launches - before[1]) == (samples, masked)


def test_fused_sampler_kernel_refuses_what_it_does_not_take(cuda):
    flat = torch.randn(2, 30, 4, device=cuda)
    x = torch.rand(2, 9, device=cuda) * 4
    y = torch.rand(2, 9, device=cuda) * 5
    with pytest.raises(TypeError):
        gather.sample_rows_bilinear(flat.half(), x, y, 6, 5)
    with pytest.raises(ValueError):
        gather.sample_rows_bilinear(flat.transpose(1, 2), x, y, 6, 5)
    with pytest.raises(ValueError):
        gather.sample_rows_bilinear(flat, x[:1], y, 6, 5)
    with pytest.raises(ValueError):
        gather.sample_rows_bilinear(flat, x, y, 6, 6)


def _offset_copy(t, offset):
    """``t`` copied into a contiguous tensor whose base lies ``offset``
    elements past a 16-byte boundary."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _sample_points(N, H, W, P, grid, g):
    """(x, y) (N, P) f32: generic points, whole numbers, the borders and
    points wholly outside; for a ``grid`` (G, H, W), a 3x3 DCN's taps of
    every pixel (taps outermost) with offsets in (-1, 1), a third of them
    whole and 15% five times farther."""
    if grid is None:
        x = torch.rand(N, P, generator=g) * (W + 3) - 2
        y = torch.rand(N, P, generator=g) * (H + 3) - 2
        x[:, 36:72] = x[:, 36:72].round()
        y[:, 60:90] = y[:, 60:90].round()
    else:
        G = grid[0]
        tap = torch.arange(G, dtype=torch.float32)
        ys = torch.arange(H, dtype=torch.float32)[None, :, None] \
            + (tap // 3 - 1)[:, None, None]
        xs = torch.arange(W, dtype=torch.float32)[None, None, :] \
            + (tap % 3 - 1)[:, None, None]
        off = torch.rand(2, N, G, H, W, generator=g) * 2 - 1
        off[:, :, ::3] = off[:, :, ::3].round()
        off = torch.where(torch.rand(off.shape, generator=g) < 0.15,
                          off * 5, off)
        x = (xs + off[0]).reshape(N, -1)
        y = (ys + off[1]).reshape(N, -1)
    x[:, :36] = torch.tensor([-1.0, 0.0, W - 1.0, float(W), -0.5, W - 0.5]) \
        .repeat_interleave(6)
    y[:, :36] = torch.tensor([-1.0, 0.0, H - 1.0, float(H), -0.5, H - 0.5]) \
        .repeat(6)
    return x.contiguous(), y.contiguous()


# (N, H, W, C, P, grid): the RU's rows (C = 3, 6, 8), an odd C, and the
# DCN's nine taps of every pixel on 256- and 64-channel maps; then the
# training shapes: the 'clip' DCN's nine taps of every level-0 pixel of
# exp_panoptic's B=4 640x1344 bucket and of exp_mupots' B=4 800x1280, and
# the RU's samples of a train step at its sparse level 0 (offsets C=8 at
# max_pos=512 points, [uvd, conf] C=6 at 512 x 8) and at a dense level 3
# (every point, and x 8), for exp_panoptic_tpu (N = 4 x 15) and exp_mupots
# (4 x 21)
SAMPLER_BWD_SHAPES = [(4, 9, 13, 3, 300, None), (4, 9, 13, 6, 700, None),
                      (4, 9, 13, 8, 300, None), (2, 9, 13, 5, 300, None),
                      (2, 12, 40, 256, 9 * 480, (9, 12, 40)),
                      (2, 11, 37, 64, 9 * 407, (9, 11, 37)),
                      (4, 160, 336, 256, 9 * 53760, (9, 160, 336)),
                      (4, 200, 320, 256, 9 * 64000, (9, 200, 320)),
                      (60, 160, 336, 8, 512, None),
                      (60, 160, 336, 6, 4096, None),
                      (60, 20, 42, 8, 840, None), (60, 20, 42, 6, 6720, None),
                      (84, 200, 320, 8, 512, None),
                      (84, 200, 320, 6, 4096, None),
                      (84, 25, 40, 6, 8000, None)]
NEEDS = [(True, False, False), (False, True, True), (True, True, True)]


@pytest.mark.parametrize('shape', SAMPLER_BWD_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('needs', NEEDS, ids=['image', 'coordinates', 'all'])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'base+1'])
def test_sampler_backward_kernel_matches_closed_form(cuda, shape, dt, needs,
                                                     offset):
    """The sampler's backward kernel against the closed form
    ``sample_rows_bilinear_backward_plain`` on the same inputs: the image
    gradient, dx and dy within 1e-5 x max|ref| in f32 and one bf16 step
    (2^-7 x max|ref|) in bf16 (f32 atomics and sums in another order), at
    the RU's narrow rows, an odd C, the DCN's nine taps on 256- and
    64-channel maps, with bases one element past 16 bytes (the narrow
    units), for each gradient subset, one launch a call."""
    N, H, W, C, P, grid = shape
    g = torch.Generator().manual_seed(1)
    x, y = (t.to(cuda) for t in _sample_points(N, H, W, P, grid, g))
    flat = _offset_copy(torch.randn(N, H * W, C, generator=g).to(cuda, dt),
                        offset)
    ct = _offset_copy(torch.randn(N, P, C, generator=g).to(cuda, dt), offset)
    want = gather.sample_rows_bilinear_backward_plain(ct, flat, x, y, H, W,
                                                      needs)
    tol = 1e-5 if dt == torch.float32 else 2.0 ** -7
    before = gather.sampler_backward_launches
    got = gather.sample_rows_bilinear_backward_cuda(ct, flat, x, y, H, W,
                                                    needs)
    torch.cuda.synchronize()
    assert gather.sampler_backward_launches == before + 1
    for name, a, b in zip(('flat', 'x', 'y'), got, want):
        assert (a is None) == (b is None), name
        if b is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


class _FailingLibrary:
    """A built library whose every function reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 1


def test_sampler_backward_kernel_refuses_what_it_does_not_take(cuda,
                                                                monkeypatch):
    """The backward's wrapper raises on a type, a stride, a shape or a
    device that the kernel does not take; where the library reports a failed launch, or the build
    fails, the sampler's backward and the row adjoint raise rather than
    run anything else."""
    flat = torch.randn(2, 30, 4, device=cuda)
    x = torch.rand(2, 9, device=cuda) * 4
    y = torch.rand(2, 9, device=cuda) * 5
    ct = torch.randn(2, 9, 4, device=cuda)
    bwd = gather.sample_rows_bilinear_backward_cuda
    with pytest.raises(TypeError):
        bwd(ct.half(), flat.half(), x, y, 6, 5)
    with pytest.raises(ValueError):           # grad in another type
        bwd(ct.bfloat16(), flat, x, y, 6, 5)
    with pytest.raises(ValueError):           # a strided gradient
        bwd(torch.randn(2, 4, 9, device=cuda).transpose(1, 2), flat, x, y,
            6, 5)
    with pytest.raises(ValueError):
        bwd(ct[:, :8], flat, x, y, 6, 5)
    with pytest.raises(ValueError):
        bwd(ct.cpu(), flat, x, y, 6, 5)
    idx = torch.randint(0, 30, (2, 9), device=cuda)
    monkeypatch.setattr(gather.LIB, 'load', lambda: _FailingLibrary())
    with pytest.raises(RuntimeError, match='launch failed'):
        bwd(ct, flat, x, y, 6, 5)
    with pytest.raises(RuntimeError, match='launch failed'):
        gather.scatter_grouped_cuda([ct], [idx], [0], [30], [torch.float32])

    def no_build():
        raise RuntimeError('nvcc failed on gather_rows.cu')
    monkeypatch.setattr(gather.LIB, 'load', no_build)
    leaf = flat.clone().requires_grad_()
    with pytest.raises(RuntimeError, match='nvcc failed'):
        gather.sample_rows_bilinear(leaf, x, y, 6, 5)
    with pytest.raises(RuntimeError, match='nvcc failed'):
        bwd(ct, flat, x, y, 6, 5)


def test_grad_recording_samples_launch_the_sampler_pair(cuda):
    """A sample that autograd records on the card is one fused sampler
    launch and, in the backward, one launch of its backward kernel, with
    no row gather and no adjoint; so are the 'clip' DCN's nine taps."""
    g = torch.Generator().manual_seed(2)
    img = torch.randn(2, 9, 13, 6, generator=g).to(cuda).requires_grad_()
    x, y = (t.to(cuda).requires_grad_()
            for t in _sample_points(2, 9, 13, 300, None, g))
    before = _k4_counts()
    out = interp_sample(img, x, y)
    out.backward(torch.randn(out.shape, generator=g).to(cuda))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k4_counts(), before)) == (0, 0, 1, 1)
    assert img.grad is not None and x.grad is not None
    a = [t.requires_grad_() for t in
         _inputs(2, 16, 40, 64, 32, torch.bfloat16, cuda)]
    before = _k4_counts()
    out = modulated_deform_conv(*a, gather_mode='clip')
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k4_counts(), before)) == (0, 0, 1, 1)
    assert all(t.grad is not None for t in a)


# (N, [(R, C, P)]): the row adjoint's narrow and unaligned rows: tables
# whose f32 buffers are no multiple of 16 bytes, before others
ADJOINT_SHAPES = [(3, [(5, 3, 40), (7, 8, 30)]),
                  (3, [(5, 6, 40), (9, 5, 70), (4, 128, 50)])]


@pytest.mark.parametrize('shape', ADJOINT_SHAPES)
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'base+1'])
def test_row_adjoint_kernel_narrow_and_unaligned(cuda, shape, dt, offset):
    """The row adjoint against ``scatter_grouped_plain`` (tolerances of
    test_grouped_gather_kernel_matches_plain) where the output gradients'
    bases lie one element past 16 bytes (the narrow units) and a table's
    buffer follows one of an odd size in the one allocation."""
    N, segs = shape
    g = torch.Generator().manual_seed(3)
    grads, idxs = [], []
    for R, C, P in segs:
        grads.append(_offset_copy(torch.randn(N, P, C, generator=g)
                                  .to(cuda, dt), offset))
        idxs.append(torch.randint(-2, R + 2, (N, P), generator=g).to(cuda))
    which = list(range(len(segs)))
    rows = [R for R, _, _ in segs]
    before = gather.backward_launches
    got = gather.scatter_grouped_cuda(grads, idxs, which, rows,
                                      [dt] * len(segs))
    torch.cuda.synchronize()
    assert gather.backward_launches == before + 1
    want = gather.scatter_grouped_plain(grads, idxs, which, rows,
                                        [dt] * len(segs))
    tol = 1e-5 if dt == torch.float32 else 2.0 ** -7
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == b.shape
        assert (a.float() - b.float()).abs().max() \
            <= tol * b.float().abs().max()


J = 4
TRAIN_MODEL = dict(
    type='DAS',
    backbone=dict(
        type='MSPN2', unit_channels=32, num_stages=1, num_units=4,
        num_blocks=[1, 1, 1, 1], norm_cfg=dict(type='BN'),
        res_top_channels=8, frozen_stages=1),
    neck=dict(type='FPN', in_channels=[32, 32, 32, 32], out_channels=32,
              norm_cfg=dict(type='BN'), num_outs=4),
    bbox_head=dict(
        type='DASHead', num_classes=1, in_channels=32, stacked_convs=2,
        feat_channels=32, strides=[8, 16, 32, 64],
        regress_ranges=((-1, 80), (80, 160), (160, 320), (320, 1e8)),
        num_joints=J, depth_factor=20, z_norm=50, root_idx=2,
        cls_branch=(32,), reg_branch=((32,), (32,), (32,), (32,)),
        centerness_branch=(32,), conv_bias=True, dcn_on_last_conv=True,
        recursive_update=dict(prev_loss=True, num_heads=2, in_channels=32,
                              feat_channels=32, num_layers=1, dim=3,
                              num_joints=J)),
    train_cfg=dict(code_weight=[1.0, 1.0, 1] + [2] * J * 6,
                   sparse_refine=True))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One fp32 step of the tiny model ('patch' DCN, so K4 runs in the exact
    DCN's corners and in the RU) on the card and on the CPU, same weights
    and batch: loss terms rtol 1e-4, grad_norm rtol 1e-3, each update
    -lr * lr_mult * trainable * momentum within 2e-2 of its leaf's largest
    CPU update (a random-init train-mode step is ill-conditioned; see
    tests/test_torch_card_paths.py::test_cut_train_step_card_vs_cpu), a
    leaf whose CPU update is zero to rounding (below 1e-6 of the largest of
    all: a conv bias before a norm) within 1e-5 of that largest, frozen
    parameters unchanged."""
    H, W = 64, 96
    featmaps = [(H // (4 * 2 ** i), W // (4 * 2 ** i)) for i in range(4)]
    head = TRAIN_MODEL['bbox_head']
    batch = synthetic_batch(2, H, W, J, seed=2)
    out = {}
    for dev in ('cpu', cuda):
        model = build_trainable_model(TRAIN_MODEL, device=dev, seed=1)
        tx_init, tx_update = make_optimizer(
            model, make_lr_fn(2e-3), frozen_prefixes=mspn_frozen_prefixes(1))
        state = TrainState(0, model, tx_init(dict(model.named_parameters())))
        step = make_train_step(tx_update, featmaps, head['strides'],
                               head['regress_ranges'], J, max_pos=64)
        first = {k: v.clone() for k, v in model.state_dict().items()}
        before = gather.launches
        state, metrics = step(state, batch)
        ran = gather.launches - before
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {k: m.cpu() for k, m in
                          state.opt_state['momentum'].items()},
                         {k: v.cpu() for k, v in model.state_dict().items()},
                         first, ran)
    (mc, momc, sdc, first, _), (mg, momg, sdg, _, ran) = \
        out['cpu'], out[str(cuda)]
    assert ran > 0
    for k, v in mc.items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        assert abs(mg[k] - v) <= rtol * abs(v) + 1e-7, (k, mg[k], v)
    model = build_trainable_model(TRAIN_MODEL, device='cpu')
    lr_mult, _ = param_groups(model)
    trainable = frozen_mask(model, mspn_frozen_prefixes(1))
    f = {k: -make_lr_fn(2e-3)(0) * lr_mult[k] * trainable[k]
         for k in trainable}
    top = max(float((f[k] * m).abs().max()) for k, m in momc.items())
    for k, m in momc.items():
        want, got = f[k] * m, f[k] * momg[k]
        own = float(want.abs().max())
        tol = 2e-2 * own if own >= 1e-6 * top else 1e-5 * top
        assert float((got - want).abs().max()) <= tol, k
        if trainable[k] == 0.0:
            assert torch.equal(sdc[k], first[k]) and \
                torch.equal(sdg[k], first[k].cpu()), k


def test_train_gradients_k4_vs_plain_on_the_card(cuda, monkeypatch):
    """The tiny model's gradient pass on the card, fp32, with K4 and then
    with its plain pair in K4's place. The forward is the same bit for bit,
    so the loss terms are equal; each gradient leaf agrees within 1e-3 of
    its largest plain value, or within 10x the difference of two plain
    passes (atomics in another order) where that is more; a leaf that is
    zero to rounding (below 1e-6 of the largest of all) within that 1e-6."""
    H, W = 64, 96
    featmaps = [(H // (4 * 2 ** i), W // (4 * 2 ** i)) for i in range(4)]
    head = TRAIN_MODEL['bbox_head']
    b = synthetic_batch(2, H, W, J, seed=2)
    model = build_trainable_model(TRAIN_MODEL, device=cuda, seed=1)
    targets = get_targets(featmaps, head['strides'], head['regress_ranges'],
                          *[torch.from_numpy(b[k]).to(cuda) for k in (
                              'gt_poses_3d', 'gt_centers2d', 'gt_depths',
                              'gt_valid')], J)
    img = torch.from_numpy(b['img']).to(cuda)

    def grads():
        model.zero_grad(set_to_none=True)
        losses = model.loss(img, targets, 64)
        sum(v for k, v in losses.items() if 'loss' in k).backward()
        return ({k: v.item() for k, v in losses.items()},
                {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None})

    before = (gather.launches, gather.backward_launches,
              gather.sampler_launches, gather.sampler_backward_launches)
    lk, gk = grads()
    assert gather.launches > before[0] and gather.backward_launches > before[1]
    assert gather.sampler_launches > before[2] and \
        gather.sampler_backward_launches > before[3]
    # every row gather on the card, the one-segment ones too, goes through
    # the grouped launchers; every sample through the sampler's pair
    monkeypatch.setattr(gather, 'gather_grouped_cuda',
                        gather.gather_grouped_plain)
    monkeypatch.setattr(gather, 'scatter_grouped_cuda',
                        gather.scatter_grouped_plain)
    monkeypatch.setattr(gather, 'sample_rows_bilinear_cuda',
                        gather._sample_plain)
    monkeypatch.setattr(gather, 'sample_rows_bilinear_backward_cuda',
                        gather.sample_rows_bilinear_backward_plain)
    lp, gp = grads()
    _, gq = grads()
    assert lk == lp
    assert sorted(gk) == sorted(gp)
    top = max(float(v.abs().max()) for v in gp.values())
    for k, want in gp.items():
        own = float(want.abs().max())
        tol = max(1e-3 * own, 10 * float((gq[k] - want).abs().max()))
        if own < 1e-6 * top:
            tol = max(tol, 1e-6 * top)
        assert float((gk[k] - want).abs().max()) <= tol, k


def test_prefetch_to_device_pinned_ring_matches_the_host(cuda):
    """train_model's prefetch on the card: each batch (the loader's keys
    and dtypes, a ragged last image) arrives on the card equal to the host
    arrays, in order, through a ring of two pinned buffers refilled while
    the compute stream still reads the earlier copies; a kernel on the
    compute stream between batches does not disturb them."""
    from das_tpu_torch.apis import prefetch_to_device
    rng = np.random.RandomState(0)
    host = [dict(img=rng.rand(4, 64, 96, 3).astype(np.float32),
                 gt_poses_3d=rng.rand(4, 8, 3 + 4 * J).astype(np.float32),
                 gt_valid=rng.rand(4, 8) < 0.5) for _ in range(7)]
    seen = []
    for i, b in enumerate(prefetch_to_device(iter(host), cuda)):
        assert all(t.device.type == 'cuda' for t in b.values())
        # work on the compute stream while the next copy is under way
        seen.append({k: (t.float() * 1.0).to(t.dtype) for k, t in b.items()})
        torch.cuda._sleep(1_000_000)
    torch.cuda.synchronize()
    assert len(seen) == len(host)
    for got, want in zip(seen, host):
        for k, v in want.items():
            assert got[k].dtype == torch.from_numpy(v).dtype, k
            assert np.array_equal(got[k].cpu().numpy(), v), k


def _launches_with_plain(name, dev):
    """(kernel call, plain call, launch count) of one wrapper on small
    inputs on ``dev``; the bf16 shapes take the wgmma passes (K1, K2), whose
    shared memory is allowed per device."""
    if name == 'dcn_shift':
        a = list(_inputs(1, 20, 36, 64, 64, torch.bfloat16, dev, spread=0.8))
        a[3] = a[3] * 0.25
        return (lambda: dcn_shift.deform_conv_shift(*a, radius=1),
                lambda: dcn_shift.deform_conv_shift_plain(*a, radius=1),
                lambda: dcn_shift.launches)
    if name == 'conv_gn':
        a = _convgn_inputs(1, 20, 36, 64, 64, torch.bfloat16, dev)
        return (lambda: conv_gn.conv_gn_relu(*a, groups=32),
                lambda: conv_gn.conv_gn_relu_plain(*a, groups=32),
                lambda: conv_gn.launches)
    if name == 'oks_nms':
        kpts, areas, valid = _nms_inputs(2, 130, 17, dev)
        sig = oks_nms.default_sigmas(17)
        return (lambda: oks_nms.oks_nms_keep(kpts, areas, valid, 0.9, sig),
                lambda: oks_nms.oks_nms_keep_plain(kpts, areas, valid, 0.9,
                                                   sig),
                lambda: oks_nms.launches)
    g = torch.Generator().manual_seed(0)
    table = torch.randn(2, 1000, 8, generator=g).to(dev)
    idx = torch.randint(0, 1000, (2, 300), generator=g).to(dev)
    return (lambda: gather.gather_rows(table, idx),
            lambda: gather.gather_rows_plain(table, idx),
            lambda: gather.launches)


@pytest.mark.parametrize('name', ['dcn_shift', 'conv_gn', 'oks_nms',
                                  'gather_rows'])
def test_kernel_launches_on_its_tensors_card(cuda, monkeypatch, name):
    """A wrapper called while another card is the current device launches
    on its tensors' card (``cuda_build.on_device``) and agrees with the
    plain version there (bf16 within 1e-2 x max|ref|, the rest equal). With
    two cards: tensors on cuda:1, current device 0. With one: the current
    device reads as another index, so the wrapper takes the same switch."""
    if torch.cuda.device_count() >= 2:
        dev = torch.device('cuda', 1)
        current = torch.cuda.device(0)
    else:
        dev = torch.device('cuda', 0)
        monkeypatch.setattr(torch.cuda, 'current_device', lambda: 1)
        current = torch.cuda.device(0)
    kernel, plain, count = _launches_with_plain(name, dev)
    with current:
        before = count()
        got = kernel()
        torch.cuda.synchronize(dev)
    assert count() == before + 1 and got.device == dev
    want = plain()
    if got.dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()
    else:
        assert torch.equal(got, want)


# exp_mupots's shape at tiny widths: a 3-stage MSPN2, 21 joints with the
# root at 14, two RU layers, the 'patch' DCN (trains by 'clip')
MUPOTS_J = 21
MUPOTS_MODEL = dict(
    TRAIN_MODEL,
    backbone=dict(TRAIN_MODEL['backbone'], num_stages=3),
    bbox_head=dict(
        TRAIN_MODEL['bbox_head'], num_joints=MUPOTS_J, root_idx=14,
        depth_factor=1,
        recursive_update=dict(TRAIN_MODEL['bbox_head']['recursive_update'],
                              num_joints=MUPOTS_J, num_layers=2)),
    train_cfg=dict(code_weight=[1.0, 1.0, 1] + [2] * MUPOTS_J * 6,
                   sparse_refine=True),
    test_cfg=dict(nms_pre=100, nms_post=10, nms_thr=0.9, score_thr=0.05,
                  sparse_refine=True))


def _k4_counts():
    """(gathers, adjoints, samples, sample backwards) launched so far."""
    return (gather.launches, gather.backward_launches,
            gather.sampler_launches, gather.sampler_backward_launches)


def _remat(cfg, on):
    return dict(cfg, backbone=dict(cfg['backbone'], remat=on),
                bbox_head=dict(cfg['bbox_head'], remat=on))


def _mupots_grads(model, b, dev, hw):
    featmaps = [(hw[0] // (4 * 2 ** i), hw[1] // (4 * 2 ** i))
                for i in range(4)]
    head = MUPOTS_MODEL['bbox_head']
    targets = get_targets(featmaps, head['strides'], head['regress_ranges'],
                          *[torch.from_numpy(b[k]).to(dev) for k in (
                              'gt_poses_3d', 'gt_centers2d', 'gt_depths',
                              'gt_valid')], MUPOTS_J)
    model.zero_grad(set_to_none=True)
    losses = model.loss(torch.from_numpy(b['img']).to(dev), targets, 64)
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    return ({k: v.item() for k, v in losses.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))})


def test_remat_step_on_the_card_matches_the_plain_step(cuda):
    """The exp_mupots-shaped model's gradient pass on the card, fp32, with
    remat in backbone, head and RU against remat=False, same weights and
    batch. The forward is the same computation: the loss terms and the
    BatchNorm running statistics after it equal bit for bit. The gradients
    sum with atomics in no fixed order (K4's adjoint, cuDNN), so each leaf
    agrees within 1e-3 of its largest plain value, or within 10x the
    difference of two plain passes where that is more (as K4 against its
    plain pair); a leaf zero to rounding (below 1e-6 of the largest of all)
    within that 1e-6. The remat pass launches K4's forwards once more for
    each recomputed sample and gather (the 12 tower DCN calls, the RU's 8
    DCN calls, its 8 + 8 samples and 2 take_at gathers at 64x96 with
    max_pos 64) and the backwards as often as the plain pass."""
    hw = (64, 96)
    b = synthetic_batch(2, *hw, MUPOTS_J, root_idx=14, seed=2)
    out = {}
    for on in (False, True):
        model = build_trainable_model(_remat(MUPOTS_MODEL, on), device=cuda,
                                      seed=1)
        before = _k4_counts()
        first = _mupots_grads(model, b, cuda, hw)
        ran = tuple(a - b for a, b in zip(_k4_counts(), before))
        again = _mupots_grads(model, b, cuda, hw)
        out[on] = first, again, ran
    (lp, gp, sp), (_, gq, _), plain_ran = out[False]
    (lr, gr, sr), _, remat_ran = out[True]
    assert lr == lp
    assert sorted(sr) == sorted(sp)
    for k in sp:
        assert torch.equal(sr[k], sp[k]), k
    # levels 0-1 (384, 96 points) sparse, 2-3 dense: a take_at gather at
    # each sparse level and two samples a level in the last RU layer, 8
    # samples in the first; 12 + 8 DCN calls, one sample each; (gathers,
    # adjoints, samples, sample backwards)
    assert plain_ran == (2, 2, 20 + 16, 20 + 16)
    assert remat_ran == (2 + 2, 2, 36 + 12 + 8 + 16, 36)
    assert sorted(gr) == sorted(gp)
    top = max(float(v.abs().max()) for v in gp.values())
    for k, want in gp.items():
        own = float(want.abs().max())
        tol = max(1e-3 * own, 10 * float((gq[k] - want).abs().max()))
        if own < 1e-6 * top:
            tol = max(tol, 1e-6 * top)
        assert float((gr[k] - want).abs().max()) <= tol, k


def test_k4_counts_of_a_patch_request_and_a_clip_step(cuda):
    """K4's launches on the exp_mupots-shaped model in bf16: a served B=2
    128x192 request (its 'patch' DCNs) makes one fused sample a DCN call
    (12 + 8), two samples a level in the first RU layer (8) and in the
    last (8), and a grouped take_at where a level has more than nms_pre
    (100) points (levels 0-1: 2), with no row gather under autograd; a
    'clip' train step at 64x96 makes 36 samples and 36 sample backwards
    (12 + 8 DCN calls, 8 + 8 RU samples), and 2 gathers and 2 adjoints
    (the take_at at the two sparse levels): no DCN or RU sample goes
    through the row gather."""
    from das_tpu_torch.models import build_model
    model = build_model(MUPOTS_MODEL, dtype=torch.bfloat16, device=cuda)
    img = torch.randn(2, 128, 192, 3, device=cuda)
    before = (gather.launches, gather.backward_launches,
              gather.sampler_launches, dcn_shift.launches)
    with torch.inference_mode():
        model(img)
    torch.cuda.synchronize()
    assert (gather.launches - before[0], gather.backward_launches - before[1],
            gather.sampler_launches - before[2],
            dcn_shift.launches - before[3]) == (2, 0, 36, 0)
    trainable = build_trainable_model(MUPOTS_MODEL, dtype=torch.bfloat16,
                                      device=cuda)
    b = synthetic_batch(2, 64, 96, MUPOTS_J, root_idx=14, seed=2)
    before = _k4_counts()
    _mupots_grads(trainable, b, cuda, (64, 96))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k4_counts(), before)) == \
        (2, 2, 36, 36)
