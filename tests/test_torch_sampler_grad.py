"""The sampler's backward (K4's, ``das_tpu_torch.ops.gather``) against the
JAX package's gradient, on the CPU.

Where autograd records a bilinear sample, the port runs the autograd
Function ``gather.SampleRowsBilinear``: on the card the fused sampler and
its backward kernel, on the CPU the plain composition and the closed form
``gather.sample_rows_bilinear_backward_plain``, which is what the kernel is
held against on the card. Held here, on inputs made from seeds with numpy:
the closed form against ``jax.grad`` of
``das_tpu.ops.interp.sample_bilinear_abs(..., gather_mode='clip')`` at
generic, whole-number and border coordinates and at points wholly outside
the image, for each set of inputs that asks for a gradient (fp32, within
1e-5 of the largest gradient and rtol 1e-4); the closed form against
autograd through the composition it differentiates (f32 within 1e-6 of the
largest value, bf16 within one bf16 step); ``gradcheck`` of the Function
in f64; that the Function keeps no corner rows for the backward; and the
'clip' deformable conv's and the recursive update's dense and sparse
re-sampling gradients against ``jax.grad`` at tiny sizes.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.models import recursive_update as jru  # noqa: E402
from das_tpu.ops import deform_conv as jdc  # noqa: E402
from das_tpu.ops import interp as jinterp  # noqa: E402
from das_tpu_torch.models import recursive_update as ru  # noqa: E402
from das_tpu_torch.ops import deform_conv as tdc  # noqa: E402
from das_tpu_torch.ops import gather, interp  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, H, W, C, P = 2, 7, 11, 5, 60
BF16_STEP = 2.0 ** -7


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _coords(case, rng):
    """(x, y) (N, P) f32 of one kind of point."""
    if case == 'generic':
        x = rng.uniform(-1.5, W + 0.5, (N, P))
        y = rng.uniform(-1.5, H + 0.5, (N, P))
    elif case == 'whole numbers':
        x = rng.randint(-2, W + 2, (N, P)).astype(np.float64)
        y = rng.randint(-2, H + 2, (N, P)).astype(np.float64)
        # one axis whole, the other not
        x[:, ::3] += rng.uniform(0.05, 0.95, x[:, ::3].shape)
        y[:, 1::3] += rng.uniform(0.05, 0.95, y[:, 1::3].shape)
    elif case == 'borders':
        xs = np.array([-1.0, 0.0, W - 1.0, float(W), -0.5, W - 0.5])
        ys = np.array([-1.0, 0.0, H - 1.0, float(H), -0.5, H - 0.5])
        x = np.tile(np.repeat(xs, 6), (N, 2))[:, :P]
        y = np.tile(np.tile(ys, 6), (N, 2))[:, :P]
    else:   # wholly outside: every corner off the image, or all but one
        x = np.concatenate([rng.uniform(-9, -1.01, (N, P // 3)),
                            rng.uniform(W + 0.01, W + 9, (N, P // 3)),
                            rng.uniform(-1, W, (N, P - 2 * (P // 3)))], 1)
        y = np.concatenate([rng.uniform(-1, H, (N, 2 * (P // 3))),
                            rng.uniform(H + 0.01, H + 4, (N, P // 6)),
                            rng.uniform(-4, -1.01,
                                        (N, P - 2 * (P // 3) - P // 6))], 1)
    return x.astype(np.float32), y.astype(np.float32)


def _jax_grads(img, x, y, ct):
    return jax.grad(lambda *a: (jinterp.sample_bilinear_abs(
        *a, gather_mode='clip') * ct).sum(), argnums=(0, 1, 2))(
            jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize('case', ['generic', 'whole numbers', 'borders',
                                  'outside'])
def test_closed_form_matches_jax_grad_clip(case):
    """d(sum(out * ct))/d{img, x, y} of the closed form == jax.grad of the
    JAX 'clip' sampler, within 1e-5 of the largest gradient and rtol 1e-4
    (fp32), at whole-number coordinates and on the borders too, where
    ``floor`` has no slope and the derivative is the composition's."""
    rng = np.random.RandomState(['generic', 'whole numbers', 'borders',
                                 'outside'].index(case))
    img = rng.randn(N, H, W, C).astype(np.float32)
    x, y = _coords(case, rng)
    ct = rng.randn(N, P, C).astype(np.float32)
    want = _jax_grads(img, x, y, ct)
    got = gather.sample_rows_bilinear_backward_plain(
        _t(ct), _t(img).reshape(N, H * W, C), _t(x), _t(y), H, W)
    _close(got[0].reshape(N, H, W, C).numpy(), want[0], 'd/dimg')
    _close(got[1].numpy(), want[1], 'd/dx')
    _close(got[2].numpy(), want[2], 'd/dy')


@pytest.mark.parametrize('needs', [(True, False, False), (False, True, True),
                                   (False, True, False), (True, True, True)],
                         ids=['image', 'coordinates', 'x alone', 'all'])
def test_each_gradient_subset_matches_jax(needs):
    """Through ``interp.sample_bilinear_abs`` under autograd (the Function
    with the plain pair), only the inputs that require a gradient get one,
    each equal to jax.grad's (tolerances as above), the coordinates mixing
    whole numbers, borders and generic points."""
    rng = np.random.RandomState(11)
    img = rng.randn(N, H, W, C).astype(np.float32)
    x, y = _coords('generic', rng)
    xb, yb = _coords('borders', rng)
    x[:, :20], y[:, :20] = xb[:, :20], yb[:, :20]
    x[:, 20:30] = np.round(x[:, 20:30])
    ct = rng.randn(N, P, C).astype(np.float32)
    want = _jax_grads(img, x, y, ct)
    ts = [_t(a).requires_grad_(need) for a, need in zip((img, x, y), needs)]
    out = interp.sample_bilinear_abs(*ts)
    # the output's reshape, then the Function
    fn = out.grad_fn.next_functions[0][0]
    assert type(fn).__name__ == 'SampleRowsBilinearBackward'
    (out * _t(ct)).sum().backward()
    for name, t, need, w in zip(('img', 'x', 'y'), ts, needs, want):
        if need:
            _close(t.grad.numpy(), w, f'd/d{name}')
        else:
            assert t.grad is None, name


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_closed_form_matches_autograd_through_the_composition(dtype):
    """The closed form == autograd through ``sample_rows_bilinear_plain``
    (the weights, one row gather of all four corners and its adjoint):
    f32 within 1e-6 of the largest value, bf16 within one bf16 step of the
    largest image gradient and of the largest coordinate gradient, the
    products rounded to bf16 where autograd's ``mul`` rounds them."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(5)
    flat = _t(rng.randn(N, H * W, C).astype(np.float32), dt)
    xs, ys = zip(*[_coords(c, rng) for c in ('generic', 'whole numbers',
                                             'borders', 'outside')])
    x, y = _t(np.concatenate(xs, 1)), _t(np.concatenate(ys, 1))
    g = _t(rng.randn(N, 4 * P, C).astype(np.float32), dt)
    leaves = [t.clone().requires_grad_() for t in (flat, x, y)]
    out = gather.sample_rows_bilinear_plain(*leaves, H, W)
    want = torch.autograd.grad(out, leaves, g)
    got = gather.sample_rows_bilinear_backward_plain(g, flat, x, y, H, W)
    tol = 1e-6 if dt == torch.float32 else BF16_STEP
    for name, a, b in zip(('flat', 'x', 'y'), got, want):
        assert a.dtype == b.dtype, name
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, \
            name


def test_function_gradcheck_f64():
    """``gradcheck`` of ``SampleRowsBilinear`` with the plain pair in f64:
    the closed form is the Jacobian of the forward (coordinates kept 0.1
    from whole numbers, where finite differences would cross a kink), in
    the image and in both coordinates."""
    rng = np.random.RandomState(2)
    flat = _t(rng.randn(2, 4 * 6, 3)).requires_grad_()
    x = _t(rng.randint(-2, 7, (2, 15)) + rng.uniform(0.1, 0.9, (2, 15))) \
        .requires_grad_()
    y = _t(rng.randint(-2, 5, (2, 15)) + rng.uniform(0.1, 0.9, (2, 15))) \
        .requires_grad_()

    def f(a, b, c):
        return gather.SampleRowsBilinear.apply(
            a, b, c, 4, 6, gather._sample_plain,
            gather.sample_rows_bilinear_backward_plain)
    assert torch.autograd.gradcheck(f, (flat, x, y))


def test_function_keeps_no_corner_rows():
    """Where autograd records a sample, the tensors it saves for the
    backward are the image and the coordinates, nothing of the (N, 4P, C)
    corner rows or their weights."""
    rng = np.random.RandomState(3)
    img = _t(rng.randn(N, H, W, C).astype(np.float32)).requires_grad_()
    x, y = (_t(a).requires_grad_() for a in _coords('generic', rng))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        interp.sample_bilinear_abs(img, x, y)
    assert sorted(saved) == sorted([(N, H * W, C), (N, P), (N, P)])


def _dcn_inputs(offsets, seed=7, n=2, h=8, w=6, cin=3, cout=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    if offsets == 'zero':
        off = np.zeros((n, h, w, 18), np.float32)
    else:
        off = ((rng.rand(n, h, w, 18) * 2 - 1) * 1.4).reshape(n, h, w, 9, 2)
        off[rng.rand(n, h, w, 9) < 0.15] *= 5.0
        off[..., ::3, :] = np.round(off[..., ::3, :])
        off = off.reshape(n, h, w, 18).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(n, h, w, 9)))).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    ct = rng.randn(n, h, w, cout).astype(np.float32)
    return [x, off, mask, weight, bias], ct


@pytest.mark.parametrize('offsets', ['zero', 'far and whole'])
def test_clip_deform_conv_gradients_match_jax(offsets):
    """The exact 'clip' deformable conv, its nine taps one sample through
    the Function: d/d{x, offset, mask, weight, bias} == jax.grad of the JAX
    'clip' lowering, within 1e-5 of each largest gradient and rtol 1e-4
    (fp32), from zero offsets (every tap at a whole pixel: the kinks of
    the sample) and from far offsets a third of which are whole."""
    args, ct = _dcn_inputs(offsets)
    want = jax.grad(lambda *a: (jdc.modulated_deform_conv(
        *a, gather_mode='clip') * ct).sum(), argnums=tuple(range(5)))(
            *[jnp.asarray(a) for a in args])
    ts = [_t(a).requires_grad_() for a in args]
    out = tdc.modulated_deform_conv(*ts, gather_mode='clip')
    (out * _t(ct)).sum().backward()
    for name, t, w in zip(('x', 'offset', 'mask', 'weight', 'bias'), ts,
                          want):
        _close(t.grad.numpy(), w, f'd/d{name}')


def _ru_fields(seed, n=2, h=6, w=7, j=3, hd=2, d=3):
    rng = np.random.RandomState(seed)
    uvd = (rng.randn(n, h, w, j * d) * 1.5).astype(np.float32)
    samp = (rng.randn(n, h, w, j * hd * 2) * 2.0).astype(np.float32)
    samp[..., ::4] = np.round(samp[..., ::4])
    conf = rng.randn(n, h, w, j * d).astype(np.float32)
    ct = rng.randn(n, h, w, j * d).astype(np.float32)
    return (uvd, samp, conf), (j, hd, d), ct


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'sparse'])
def test_recursive_update_resampling_gradients_match_jax(sparse):
    """The recursive update's re-sampling (dense: all candidates of a level
    in one sample; sparse: the grouped take_at and two samples at the
    selected points): d/d{uvd, sampling offsets, conf} == jax.grad of the
    JAX function ('clip'), within 1e-5 of each largest gradient and rtol
    1e-4 (fp32), with a quarter of the sampling offsets whole numbers."""
    fields, dims, ct = _ru_fields(9 if sparse else 8)
    sel = np.random.RandomState(4).randint(0, 42, (2, 11))
    if sparse:
        n, h, w, c = ct.shape
        ct = ct.reshape(n, h * w, c)[np.arange(n)[:, None], sel]

        def jf(*f):
            return jru._offset_sample_sparse(*f, jnp.asarray(sel), *dims,
                                             gather_mode='clip')

        def tf(*f):
            return ru._offset_sample_sparse(*f, _t(sel), *dims)
    else:
        def jf(*f):
            return jru._offset_sample(*f, *dims, gather_mode='clip')

        def tf(*f):
            return ru._offset_sample(*f, *dims)
    want = jax.grad(lambda *f: (jf(*f) * ct).sum(), argnums=(0, 1, 2))(
        *[jnp.asarray(f) for f in fields])
    ts = [_t(f).requires_grad_() for f in fields]
    (tf(*ts) * _t(ct)).sum().backward()
    for name, t, w in zip(('uvd', 'sampling offset', 'conf'), ts, want):
        _close(t.grad.numpy(), w, f'd/d{name}')
