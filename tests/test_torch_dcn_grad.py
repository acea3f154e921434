"""The gradient of the DCN shift expansion in the port against the JAX
package's, on the CPU, fp32.

The JAX package trains ``dcn_train_gather_mode='shift'`` through autodiff of
``das_tpu/ops/deform_conv.py::_deform_conv_shift``. Where an offset is an
integer or sits exactly at +-radius, the hat weight ``max(0, 1 - |t|)`` and
the clamp have kinks, and JAX's derivative there is its own: -1 at t = 0,
-0.5 at t = 1, +0.5 at t = -1, and half of the clamp's at +-radius. Every
run from the zero-initialised ``conv_offset`` starts with all offsets at 0.
Held here, at offsets all 0, exactly +-r, integers within r, within an ulp
of those (where t rounds onto a kink in f32) and generic, r in {1, 2}: the port's plain ``_deform_conv_shift`` under autograd, the
closed-form ``dcn_shift.deform_conv_shift_backward_plain`` (what the
kernel's backward is held against on the card), the autograd Function
``dcn_shift.DeformConvShift`` on CPU tensors through
``modulated_deform_conv`` and ``DeformConv2d``, and one whole train step of
a ``'shift'`` variant of the tiny train model from zero offsets. Tolerance:
rtol 1e-4 and atol 1e-5 x max|ref|, as tests/test_torch_train.py holds the
DCN gradients.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu.models.layers import DeformConv2d as JDeformConv2d  # noqa
from das_tpu.ops.deform_conv import \
    modulated_deform_conv as jdeform  # noqa: E402
from das_tpu_torch.models.layers import DeformConv2d  # noqa: E402
from das_tpu_torch.ops import dcn_shift  # noqa: E402
from das_tpu_torch.ops.deform_conv import modulated_deform_conv  # noqa
from test_torch_model import _seeded_tree, _tree_shapes  # noqa: E402
from test_torch_train import (TRAIN_MODEL, run_jax_step,  # noqa: E402
                              step_matches_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OFFSETS = ['zero', 'at +-r', 'integers', 'next to the kinks', 'generic']
NAMES = ('x', 'offset', 'mask', 'weight', 'bias')


def _offsets(case, shape, r, rng):
    if case == 'zero':
        return np.zeros(shape, np.float32)
    if case == 'at +-r':
        return (rng.choice([-1.0, 1.0], shape) * r).astype(np.float32)
    if case == 'integers':
        return rng.randint(-r, r + 1, shape).astype(np.float32)
    if case == 'next to the kinks':
        # within an ulp or two of 0, +-1 and +-r: a displacement i - d
        # then rounds to exactly +-1 in f32 where it is not exactly so
        near = np.array([1 - 2 ** -24, -(1 - 2 ** -24), 2 ** -30, -2 ** -30,
                         1 + 2 ** -23, -1 - 2 ** -23, r - 2 ** -22,
                         -r + 2 ** -22, 0.5], np.float32)
        return rng.choice(near, shape)
    # generic: spread past the radius, off the kinks
    return ((rng.rand(*shape) * 2.4 - 1.2) * r + 0.013).astype(np.float32)


def _inputs(case, r, n=2, h=5, w=6, cin=5, cout=3):
    """x, offset, mask, weight, bias and an output cotangent, numpy f32, from
    a seed of their own."""
    rng = np.random.RandomState(OFFSETS.index(case) + 10 * r)
    args = [rng.randn(n, h, w, cin).astype(np.float32),
            _offsets(case, (n, h, w, 18), r, rng),
            (1 / (1 + np.exp(-rng.randn(n, h, w, 9)))).astype(np.float32),
            (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32)]
    return args, rng.randn(n, h, w, cout).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grads(case, r):
    """jax.vjp of the JAX 'shift' path at ``_inputs(case, r)``, taken once
    for the tests that share it. The gradients of x, offset, mask and
    weight do not depend on the bias."""
    args, ct = _inputs(case, r)
    _, vjp = jax.vjp(lambda *a: jdeform(*a, gather_mode='shift',
                                        shift_radius=r),
                     *[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _close(got, want, what):
    for name, g, ref in zip(NAMES, got, want):
        if g is None:
            continue
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f'{what} d/d{name}')


def test_repaired_hat_and_clamp_keep_the_forward_bit_for_bit():
    """``hat`` and ``clamp_offset`` give what ``(1 - |t|).clamp_min(0)`` and
    ``clamp`` give, bit for bit, kinks included, in f32 and bf16, with
    JAX's derivatives there."""
    t = torch.tensor([-3.0, -2.0, -1.5, -1.0, -0.75, -0.0, 0.0, 0.3, 1.0,
                      1.0 + 2 ** -20, 2.0, 2.5, 7.0])
    for dt in (torch.float32, torch.bfloat16):
        v = t.to(dt)
        assert torch.equal(dcn_shift.hat(v), (1.0 - v.abs()).clamp_min(0.0))
        for r in (1.0, 2.0):
            assert torch.equal(dcn_shift.clamp_offset(v, r), v.clamp(-r, r))
    at = torch.tensor([0.0, 1.0, -1.0, 0.5, -0.5, 1.5], requires_grad=True)
    dcn_shift.hat(at).sum().backward()
    assert at.grad.tolist() == [-1.0, -0.5, 0.5, -1.0, 1.0, 0.0]
    o = torch.tensor([1.0, -1.0, 2.0, 0.0, -3.0], requires_grad=True)
    dcn_shift.clamp_offset(o, 1.0).sum().backward()
    assert o.grad.tolist() == [0.5, 0.5, 0.0, 1.0, 0.0]
    want = [float(jax.grad(lambda s: jnp.maximum(0.0, 1.0 - jnp.abs(s)))(
        jnp.float32(s))) for s in (0.0, 1.0, -1.0)]
    assert want == [-1.0, -0.5, 0.5]


@pytest.mark.parametrize('case', OFFSETS)
@pytest.mark.parametrize('radius', [1, 2])
def test_plain_shift_gradient_matches_jax_at_the_kinks(case, radius):
    """Step 0: ``_deform_conv_shift`` under autograd (``'shift'`` on the
    CPU) against ``jax.grad`` of the JAX ``'shift'`` path, with respect to
    x, offset, mask, weight and bias."""
    args, ct = _inputs(case, radius)
    want = _jax_grads(case, radius)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = modulated_deform_conv(*ts, gather_mode='shift',
                                shift_radius=radius)
    assert out.grad_fn.name() != 'DeformConvShiftBackward'
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ts)
    _close(got, want, f"'shift' at {case} offsets")


@pytest.mark.parametrize('case', OFFSETS)
@pytest.mark.parametrize('radius', [1, 2])
def test_closed_form_backward_matches_jax_vjp(case, radius):
    """``deform_conv_shift_backward_plain`` (no autograd) against
    ``jax.vjp``; doffset comes back in f32, the rest in x's type."""
    args, ct = _inputs(case, radius)
    want = _jax_grads(case, radius)
    x, off, mask, w, _ = [torch.from_numpy(a) for a in args]
    got = dcn_shift.deform_conv_shift_backward_plain(
        x, off, mask, w, torch.from_numpy(ct), radius)
    assert [g.dtype for g in got] == [torch.float32] * 5
    _close(got, want, f'closed form at {case} offsets')
    only = dcn_shift.deform_conv_shift_backward_plain(
        x, off, mask, w, torch.from_numpy(ct), radius,
        needs=(False, True, False, False, True))
    assert [g is None for g in only] == [True, False, True, True, False]
    assert torch.equal(only[1], got[1]) and torch.equal(only[4], got[4])


@pytest.mark.parametrize('variant', ['all', 'x without a gradient',
                                     'bias None'])
@pytest.mark.parametrize('case', OFFSETS)
def test_function_through_modulated_deform_conv_matches_jax(case, variant):
    """The autograd Function on CPU tensors (``'shift_pallas'``: the K1
    wrapper, plain forward, closed-form backward) against the JAX
    ``'shift'`` gradient, r=1; with x not requiring a gradient it returns
    none for x, with no bias none for the bias."""
    args, ct = _inputs(case, 1)
    want = _jax_grads(case, 1)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    if variant == 'x without a gradient':
        ts[0].requires_grad_(False)
    if variant == 'bias None':
        ts[4] = None
    out = modulated_deform_conv(*ts, gather_mode='shift_pallas',
                                shift_radius=1)
    assert out.grad_fn.name() == 'DeformConvShiftBackward'
    live = [t for t in ts if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad((out * torch.from_numpy(ct)).sum(), live))
    _close([next(got) if t is not None and t.requires_grad else None
            for t in ts], want, f'Function ({variant}) at {case} offsets')


def _jax_layer_params(rng, cin, cout, offset_std):
    return {'params': {
        'conv_offset': {
            'kernel': (rng.randn(3, 3, cin, 27) * offset_std)
            .astype(np.float32),
            'bias': (rng.randn(27) * offset_std).astype(np.float32)},
        'kernel': (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32),
        'bias': (rng.randn(cout) * 0.1).astype(np.float32)}}


@pytest.mark.parametrize('lowering', ['auto', 'shift_pallas'])
@pytest.mark.parametrize('conv_offset', ['zero', 'seeded'])
def test_deform_conv2d_train_gradients_match_jax(conv_offset, lowering):
    """``DeformConv2d`` (``gather_mode='shift_pallas'``, r=1) in training
    against the JAX module: its ``'auto'`` lowering is ``'shift'`` (on the
    CPU the plain expansion), an explicit ``'shift_pallas'`` runs the
    Function; gradients of x, the conv_offset conv and the DCN weight and
    bias, from a zero conv_offset (as at init: every offset 0) and from a
    seeded one."""
    rng = np.random.RandomState(3)
    n, h, w, cin, cout = 2, 6, 5, 4, 3
    x = rng.randn(n, h, w, cin).astype(np.float32)
    ct = rng.randn(n, h, w, cout).astype(np.float32)
    var = _jax_layer_params(rng, cin, cout,
                            0.0 if conv_offset == 'zero' else 0.3)
    jmod = JDeformConv2d(cout, gather_mode='shift_pallas', shift_radius=1)

    def loss(v, xx):
        return (jmod.apply(v, xx, train=True) * ct).sum()
    jv = jax.tree_util.tree_map(jnp.asarray, var)
    gv, gx = jax.grad(loss, argnums=(0, 1))(jv, jnp.asarray(x))
    gv = gv['params']
    port = DeformConv2d(cin, cout, gather_mode='shift_pallas',
                        shift_radius=1, train_gather_mode=lowering).train()
    p = var['params']
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(p['kernel'].transpose(3, 2, 0, 1)))
        port.bias.copy_(torch.from_numpy(p['bias']))
        port.conv_offset.weight.copy_(torch.from_numpy(
            p['conv_offset']['kernel'].transpose(3, 2, 0, 1)))
        port.conv_offset.bias.copy_(torch.from_numpy(p['conv_offset']['bias']))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = port(tx)
    assert (out.grad_fn.next_functions[0][0].name() ==
            'DeformConvShiftBackward') == (lowering == 'shift_pallas')
    (out.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum().backward()
    pairs = [(tx.grad.permute(0, 2, 3, 1), gx),
             (port.weight.grad.permute(2, 3, 1, 0), gv['kernel']),
             (port.bias.grad, gv['bias']),
             (port.conv_offset.weight.grad.permute(2, 3, 1, 0),
              gv['conv_offset']['kernel']),
             (port.conv_offset.bias.grad, gv['conv_offset']['bias'])]
    for i, (g, ref) in enumerate(pairs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f'{conv_offset} {lowering} {i}')


SHIFT_TRAIN_MODEL = dict(
    TRAIN_MODEL, bbox_head=dict(TRAIN_MODEL['bbox_head'],
                                dcn_train_gather_mode='shift',
                                dcn_shift_radius=1))


@pytest.fixture(scope='module')
def shift_trees():
    """The JAX 'shift' variant of TRAIN_MODEL and its seeded tree (seed 0,
    as tests/test_torch_train.py) with every conv_offset kernel and bias
    zero, as at init."""
    jmodel = jbuild_model(SHIFT_TRAIN_MODEL)
    tree = _seeded_tree(_tree_shapes(jmodel), seed=0)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        return np.zeros_like(a) if 'conv_offset' in name else a
    return jmodel, jax.tree_util.tree_map_with_path(leaf, tree)


def other_side_of_relu_ties(band, moved):
    """A forward hook for a norm that a relu follows: each output within
    ``band`` of zero takes the other side of zero (value -v, gradient
    unchanged), so the relu decides as it would on a sum rounded the
    other way; ``moved`` gets each such v."""
    def hook(module, inputs, out):
        v = out.detach()
        near = v.abs() < band
        moved.extend(v[near].tolist())
        return out - 2 * torch.where(near, v, torch.zeros_like(v))
    return hook


def test_shift_train_step_from_zero_offsets_matches_jax(shift_trees):
    """One whole step of TRAIN_MODEL with ``dcn_train_gather_mode='shift'``
    at r=1 from zero conv_offsets (every offset of every DCN exactly 0)
    against the JAX make_train_step, at test_train_step_matches_jax's
    tolerances; the conv_offset leaves move by the kink gradient.

    At this tree one output of the cls tower's DCN norm (level 0) lies
    within 1e-5 of zero, where the port's and JAX's f32 sums of the DCN
    may round to opposite sides, and the relu after it then passes the
    gradient on one side only: the cls tower's leaves differ beyond the
    tolerance. Held here that this one relu is the whole of the gap: with
    that output moved to the other side of zero (by less than 1e-5, its
    gradient unchanged) every leaf agrees."""
    jmodel, tree = shift_trees
    paths = jax.tree_util.tree_flatten_with_path(tree['params'])[0]
    offs = [a for p, a in paths if 'conv_offset' in jax.tree_util.keystr(p)]
    assert offs and not any(a.any() for a in offs)
    result = run_jax_step(jmodel, tree)
    _, _, jmom = result
    moved = [k for k, v in jmom.items()
             if 'conv_offset' in k and float(v.abs().max()) > 0]
    assert moved, 'no conv_offset leaf has a gradient'
    with pytest.raises(AssertionError, match='bbox_head.cls_convs'):
        step_matches_jax(SHIFT_TRAIN_MODEL, tree, result)
    ties = []

    def prepare(model):
        model.bbox_head.cls_convs[-1].gn.register_forward_hook(
            other_side_of_relu_ties(1e-5, ties))
    step_matches_jax(SHIFT_TRAIN_MODEL, tree, result, prepare)
    assert len(ties) == 1, ties
