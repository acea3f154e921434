"""Parity of the port's row gather and bilinear sampler (K4,
das_tpu_torch.ops.gather) and of their callers with the JAX package.

On the CPU, where every wrapper runs its plain version, on inputs made from
seeds with numpy, in fp32 (TF32 off) and, where the comparison is of bits,
in bf16: the grouped row gather and its adjoint against
``jnp.take_along_axis(..., mode='clip')`` and ``jax.vjp``; the sampler built
on one gather of all four corners against ``das_tpu.ops.interp
.sample_bilinear_abs`` ('clip') and its gradients against ``jax.grad``; the
recursive update's dense and sparse re-sampling with all candidates in one
sample, and the deformable conv's nine taps in one sample, against their
JAX functions. Tolerances are stated per test.
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

# (R, C, P) of each segment; N is shared
SEGMENTS = {1: [(50, 6, 40)],
            2: [(50, 3, 40), (50, 8, 40)],
            4: [(50, 3, 40), (21, 8, 7), (50, 5, 64), (9, 256, 30)]}


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _segments(n_seg, seed=0, N=3):
    """Tables (f32), indices (some past the last row, which must clamp) and
    output cotangents of SEGMENTS[n_seg]."""
    rng = np.random.RandomState(seed)
    tables = [rng.randn(N, R, C).astype(np.float32)
              for R, C, _ in SEGMENTS[n_seg]]
    idxs = [rng.randint(0, R + R // 4, (N, P))
            for R, _, P in SEGMENTS[n_seg]]
    cts = [rng.randn(N, P, C).astype(np.float32)
           for _, C, P in SEGMENTS[n_seg]]
    return tables, idxs, cts


def _jtake(table, idx):
    return jnp.take_along_axis(table, jnp.asarray(idx)[..., None], axis=1,
                               mode='clip')


@pytest.mark.parametrize('n_seg', [1, 2, 4])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grouped_gather_matches_take_along_axis_clip(n_seg, dtype):
    """gather_rows_grouped == one take_along_axis(mode='clip') per segment,
    bit for bit, for 1, 2 and 4 segments of different R, C and P, int32 and
    int64 indices, in f32 and bf16 (a gather copies bits)."""
    tables, idxs, _ = _segments(n_seg)
    jt = [jnp.asarray(t).astype(dtype) for t in tables]
    want = [np.asarray(_jtake(t, i).astype(jnp.float32))
            for t, i in zip(jt, idxs)]
    tt = [_t(np.asarray(t.astype(jnp.float32)), getattr(torch, dtype))
          for t in jt]
    ti = [_t(i, torch.int32 if s % 2 else torch.int64)
          for s, i in enumerate(idxs)]
    before = gather.launches
    got = gather.gather_rows_grouped(tt, ti)
    assert gather.launches == before        # the plain version is no launch
    assert len(got) == n_seg
    for g, w, (R, C, P) in zip(got, want, SEGMENTS[n_seg]):
        assert g.shape == (3, P, C) and g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(g.float().numpy(), w)


@pytest.mark.parametrize('n_seg', [1, 2, 4])
def test_grouped_gather_adjoint_matches_jax_vjp(n_seg):
    """The gradient of gather_rows_grouped in each table == jax.vjp of the
    same gathers, within 1e-6 of max|ref| (f32; sums of a few terms in
    another order). With 4 segments the third gathers the first one's
    table again, so that table's gradient is the sum over both, taken in
    one buffer."""
    tables, idxs, cts = _segments(n_seg, seed=1)
    which = list(range(n_seg))
    if n_seg == 4:                       # segment 2 reads table 0: C = 3
        which[2] = 0
        cts[2] = cts[2][..., :3]
    uniq = sorted(set(which))

    def jfn(*ts):
        return [_jtake(ts[uniq.index(w)], i) for w, i in zip(which, idxs)]
    _, vjp = jax.vjp(jfn, *[jnp.asarray(tables[u]) for u in uniq])
    want = vjp([jnp.asarray(c) for c in cts])

    leaves = {u: _t(tables[u]).requires_grad_() for u in uniq}
    outs = gather.gather_rows_grouped([leaves[w] for w in which],
                                      [_t(i) for i in idxs])
    sum((o * _t(c)).sum() for o, c in zip(outs, cts)).backward()
    for u, w in zip(uniq, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaves[u].grad.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


def test_grouped_gather_skips_tables_and_outputs_without_gradient():
    """A table that needs no gradient gets none; an output that the loss
    does not use adds nothing (its gradient is not materialised)."""
    tables, idxs, cts = _segments(2, seed=2)
    a = _t(tables[0]).requires_grad_()
    b = _t(tables[1])
    out_a, out_b = gather.gather_rows_grouped([a, b], [_t(i) for i in idxs])
    assert out_a.requires_grad and not b.requires_grad
    (out_a * _t(cts[0])).sum().backward()
    want = gather.scatter_rows_plain(_t(cts[0]), _t(idxs[0]), 50,
                                     torch.float32)
    assert torch.equal(a.grad, want)
    a.grad = None
    c = _t(tables[1]).requires_grad_()
    out_a, out_c = gather.gather_rows_grouped([a, c], [_t(i) for i in idxs])
    (out_c * _t(cts[1])).sum().backward()
    assert a.grad is None and c.grad is not None


def _sample_case(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, 9, 200, 5).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 203, (2, 64)),
                        rng.randint(-2, 202, (2, 32)).astype(np.float64),
                        rng.uniform(128, 199, (2, 32))], 1).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 12, (2, 64)),
                        rng.randint(-2, 11, (2, 32)).astype(np.float64),
                        rng.uniform(0, 8, (2, 32))], 1).astype(np.float32)
    return img, x, y


def test_sample_bilinear_abs_one_gather_matches_jax_clip():
    """The sampler around one gather of all four corners == the JAX
    function with its 'clip' row gathers: out-of-bounds and whole border
    coordinates, and coordinates >= 128 on a wide image (atol 1e-6, fp32,
    the tolerance of test_torch_ops.py's sampler test)."""
    img, x, y = _sample_case()
    want = jinterp.sample_bilinear_abs(jnp.asarray(img), jnp.asarray(x),
                                       jnp.asarray(y), gather_mode='clip')
    got = interp.sample_bilinear_abs(_t(img), _t(x), _t(y))
    assert got.shape == want.shape == (2, 128, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_sample_bilinear_abs_bf16_matches_jax_bit_for_bit():
    """In bf16 the port's sampler rounds where the JAX function rounds: the
    weights in f32, cast to bf16, each product and each sum in bf16, in the
    same order; equal bits."""
    img, x, y = _sample_case(seed=3)
    jimg = jnp.asarray(img).astype(jnp.bfloat16)
    want = jinterp.sample_bilinear_abs(jimg, jnp.asarray(x), jnp.asarray(y),
                                       gather_mode='clip')
    got = interp.sample_bilinear_abs(_t(img, torch.bfloat16), _t(x), _t(y))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_sample_bilinear_abs_gradients_match_jax():
    """d(sum(out * ct))/d{img, x, y} against jax.grad: within 1e-5 of the
    largest gradient (fp32). The coordinates stay off whole numbers, where
    the sample has a kink."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 7, 11, 4).astype(np.float32)
    x = (rng.randint(-2, 12, (2, 50)) + rng.uniform(0.1, 0.9, (2, 50))) \
        .astype(np.float32)
    y = (rng.randint(-2, 8, (2, 50)) + rng.uniform(0.1, 0.9, (2, 50))) \
        .astype(np.float32)
    ct = rng.randn(2, 50, 4).astype(np.float32)
    want = jax.grad(lambda *a: (jinterp.sample_bilinear_abs(
        *a, gather_mode='clip') * ct).sum(), argnums=(0, 1, 2))(
            jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    ts = [_t(a).requires_grad_() for a in (img, x, y)]
    got = torch.autograd.grad(
        (interp.sample_bilinear_abs(*ts) * _t(ct)).sum(), ts)
    for name, g, w in zip(('img', 'x', 'y'), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f'd/d{name}')


def _ru_fields(seed, N=2, H=6, W=7, J=3, Hd=2, D=3):
    rng = np.random.RandomState(seed)
    uvd = rng.randn(N, H, W, J * D).astype(np.float32) * 1.5
    samp = rng.randn(N, H, W, J * Hd * 2).astype(np.float32) * 2.0
    conf = rng.randn(N, H, W, J * D).astype(np.float32)
    return (uvd, samp, conf), (J, Hd, D)


def test_offset_sample_dense_all_candidates_in_one_sample_matches_jax():
    """The dense re-sampling, all 2*heads candidates of a level in one
    sample == the JAX function, which samples once per candidate ('clip'):
    atol 2e-6 (fp32; the same sums in the same order, exp and divide from
    two libraries)."""
    fields, dims = _ru_fields(5)
    want = jru._offset_sample(*[jnp.asarray(f) for f in fields], *dims,
                              gather_mode='clip')
    got = ru._offset_sample(*[_t(f) for f in fields], *dims)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_offset_sample_sparse_grouped_take_at_matches_jax_and_dense():
    """The sparse re-sampling, whose two take_at fields are one grouped
    gather == the JAX function (atol 2e-6, fp32), and equals the port's
    dense values at the selected points bit for bit, as in the JAX
    package."""
    fields, dims = _ru_fields(6)
    sel = np.random.RandomState(7).randint(0, 42, (2, 11))
    want = jru._offset_sample_sparse(*[jnp.asarray(f) for f in fields],
                                     jnp.asarray(sel), *dims,
                                     gather_mode='clip')
    got = ru._offset_sample_sparse(*[_t(f) for f in fields], _t(sel), *dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    dense = ru._offset_sample(*[_t(f) for f in fields], *dims)
    N, H, W, C = dense.shape
    at = dense.reshape(N, H * W, C)[torch.arange(N)[:, None], _t(sel)]
    assert torch.equal(got, at)


def _dcn_inputs(n=2, h=8, w=6, cin=3, cout=5, seed=7):
    """The far-offset recipe of tests/test_torch_ops.py."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = ((rng.rand(n, h, w, 18).astype(np.float32) * 2 - 1) * 1.4) \
        .reshape(n, h, w, 9, 2)
    off[rng.rand(n, h, w, 9) < 0.15] *= 5.0
    mask = 1 / (1 + np.exp(-rng.randn(n, h, w, 9).astype(np.float32)))
    weight = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.2
    bias = rng.randn(cout).astype(np.float32)
    return (x, off.reshape(n, h, w, 18), mask.astype(np.float32), weight,
            bias)


@pytest.mark.parametrize('mode', ['clip', 'hybrid'])
@pytest.mark.parametrize('with_bias', [True, False])
def test_deform_conv_nine_taps_in_one_sample_matches_jax(mode, with_bias):
    """The exact lowering and the hybrid repair, each with its nine taps in
    one sample == the same mode in JAX and == JAX 'clip' (exact DCNv2), far
    offsets, atol 3e-5 (fp32, the tolerance of test_torch_ops.py's mode
    test)."""
    args = list(_dcn_inputs())
    if not with_bias:
        args[4] = None
    h, w = args[0].shape[1:3]
    kw = dict(gather_mode=mode, shift_radius=1, shift_budget=h * w)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    want = jdc.modulated_deform_conv(*jargs, **kw)
    exact = jdc.modulated_deform_conv(*jargs, gather_mode='clip')
    got = tdc.modulated_deform_conv(
        *[None if a is None else _t(a) for a in args], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), atol=3e-5)


def _masked_inputs(dt, N=2, H=6, W=5, C=4, P=40, seed=3):
    """An image, points with corners outside it and on its border, and a
    mask of the image's type."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(N, H * W, C, generator=g).to(dt)
    x = torch.rand(N, P, generator=g) * (W + 3) - 2
    y = torch.rand(N, P, generator=g) * (H + 3) - 2
    x[:, :6] = torch.tensor([-1.0, 0.0, W - 1.0, float(W), -0.5, W - 0.5])
    y[:, :6] = torch.tensor([-0.5, H - 0.5, float(H), -1.0, 0.0, H - 1.0])
    mask = torch.sigmoid(torch.randn(N, P, generator=g)).to(dt)
    return flat, x, y, H, W, mask


@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_masked_plain_sampler_is_the_sample_times_the_mask(dt):
    """The masked sample on the CPU (the plain sampler, then the product)
    == the unmasked sample times ``mask[..., None]``, bit for bit, with
    corners outside the image; it launches nothing."""
    flat, x, y, H, W, mask = _masked_inputs(dt)
    before = gather.sampler_launches, gather.sampler_masked_launches
    got = gather.sample_rows_bilinear(flat, x, y, H, W, mask)
    assert (gather.sampler_launches, gather.sampler_masked_launches) == \
        before
    want = gather.sample_rows_bilinear(flat, x, y, H, W) * mask[..., None]
    assert got.dtype == dt and torch.equal(got, want)
    img = flat.reshape(2, H, W, -1)
    assert torch.equal(interp.sample_bilinear_abs(img, x, y, mask), want)


@pytest.mark.parametrize('leaf', ['flat', 'x', 'mask'])
def test_masked_sample_raises_where_autograd_records(leaf):
    """The masked sample has no backward: where the image, a coordinate
    or the mask requires a gradient and grad is on it raises; under
    no_grad the same call runs."""
    flat, x, y, H, W, mask = _masked_inputs(torch.float32)
    args = dict(flat=flat, x=x, mask=mask)
    args[leaf] = args[leaf].clone().requires_grad_()
    with pytest.raises(RuntimeError, match='no backward'):
        gather.sample_rows_bilinear(args['flat'], args['x'], y, H, W,
                                    args['mask'])
    with torch.no_grad():
        out = gather.sample_rows_bilinear(args['flat'], args['x'], y, H, W,
                                          args['mask'])
    assert torch.equal(out, gather.sample_rows_bilinear(
        flat, x, y, H, W) * mask[..., None])


def _dcn_f64(with_bias, n=2, h=7, w=9, cin=5, cout=6):
    args = [None if a is None else _t(a).double()
            for a in _dcn_inputs(n, h, w, cin, cout, seed=11)]
    if not with_bias:
        args[4] = None
    return args


@pytest.mark.parametrize('with_bias', [True, False])
def test_deform_conv_im2col_route_matches_per_tap_f64(with_bias):
    """Where autograd does not record, the exact DCN takes the im2col
    route (one masked sample, one matmul); in f64 it equals the per-tap
    route to 1e-12, with and without bias, at an odd H x W."""
    args = _dcn_f64(with_bias)
    with torch.no_grad():
        got = tdc.modulated_deform_conv(*args, gather_mode='patch')
    route = tdc._deform_conv_im2col(*args, 3, 1)
    want = tdc._deform_conv_per_tap(*args, 3, 1)
    assert torch.equal(got, route)
    assert got.shape == want.shape == (2, 7, 9, 6)
    assert (got - want).abs().max().item() <= 1e-12


@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16])
def test_deform_conv_under_autograd_takes_the_per_tap_route(dt,
                                                            monkeypatch):
    """Where autograd records (the 'clip' training lowering), the exact DCN
    runs the per-tap loop: its output and the gradients of x, offset,
    mask, weight and bias equal bit for bit those of a direct call of
    ``_deform_conv_per_tap``, and the im2col route is never called."""
    base = [None if a is None else _t(a) for a in _dcn_inputs(h=7, w=9)]

    def leaves():
        return [a.to(dt if i != 1 else torch.float32).requires_grad_()
                for i, a in enumerate(base)]

    def im2col(*a, **k):
        raise AssertionError('the im2col route ran under autograd')
    monkeypatch.setattr(tdc, '_deform_conv_im2col', im2col)
    got_in = leaves()
    got = tdc.modulated_deform_conv(*got_in, gather_mode='clip')
    want_in = leaves()
    want = tdc._deform_conv_per_tap(*want_in, 3, 1)
    assert torch.equal(got, want)
    ct = torch.randn(got.shape, generator=torch.Generator().manual_seed(5)) \
        .to(dt)
    (got * ct).sum().backward()
    (want * ct).sum().backward()
    for a, b in zip(got_in, want_in):
        assert a.grad is not None and torch.equal(a.grad, b.grad)


def test_fused_sampler_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper raises on a type, a stride or a shape that the
    kernel does not take, and never falls back: without a card it cannot
    launch, and a device that has no kernel raises."""
    flat = torch.randn(2, 6 * 5, 4)
    x = torch.rand(2, 9) * 4
    y = torch.rand(2, 9) * 5
    with pytest.raises(TypeError):
        gather.sample_rows_bilinear_cuda(flat.half(), x, y, 6, 5)
    with pytest.raises(TypeError):
        gather.sample_rows_bilinear_cuda(flat, x.double(), y, 6, 5)
    with pytest.raises(ValueError):        # a strided table
        gather.sample_rows_bilinear_cuda(
            torch.randn(2, 4, 30).transpose(1, 2), x, y, 6, 5)
    with pytest.raises(ValueError):        # strided coordinates
        gather.sample_rows_bilinear_cuda(flat, torch.rand(9, 2).t(), y, 6, 5)
    with pytest.raises(ValueError):        # H * W is not the table's rows
        gather.sample_rows_bilinear_cuda(flat, x, y, 6, 6)
    with pytest.raises(ValueError):        # not on a card
        gather.sample_rows_bilinear_cuda(flat, x, y, 6, 5)
    with pytest.raises(ValueError):
        gather.sample_rows_bilinear(flat.to('meta'), x.to('meta'),
                                    y.to('meta'), 6, 5)
    before = gather.sampler_launches
    out = gather.sample_rows_bilinear(flat, x, y, 6, 5)
    assert out.shape == (2, 9, 4)
    assert gather.sampler_launches == before    # the plain version


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'strided'])
def test_fused_sampler_wrapper_refuses_a_mask_it_does_not_take(bad):
    """The masked kernel takes a contiguous (N, P) mask of the image's
    type; anything else raises before any launch."""
    flat = torch.randn(2, 6 * 5, 4)
    x = torch.rand(2, 9) * 4
    y = torch.rand(2, 9) * 5
    mask = {'dtype': torch.rand(2, 9).double(),
            'shape': torch.rand(2, 10),
            'strided': torch.rand(9, 2).t()}[bad]
    with pytest.raises(ValueError, match='mask'):
        gather.sample_rows_bilinear_cuda(flat, x, y, 6, 5, mask)
