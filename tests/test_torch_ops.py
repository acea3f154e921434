"""Parity of the port's ops (das_tpu_torch.ops) with the JAX package's.

The same inputs, made from a seed with numpy, go through the JAX function
and its port counterpart in fp32 on the CPU (TF32 off); the Pallas DCN
kernel runs in interpret mode, as the JAX package's own tests run it. On
the CPU every port wrapper runs its plain version. Tolerances are stated
per test.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.ops import deform_conv as jdc  # noqa: E402
from das_tpu.ops import interp as jinterp  # noqa: E402
from das_tpu.ops import oks_nms as jnms  # noqa: E402
from das_tpu.ops.pallas_dcn import deform_conv_shift_pallas  # noqa: E402
from das_tpu_torch.ops import deform_conv as tdc  # noqa: E402
from das_tpu_torch.ops import dcn_shift, interp, oks_nms  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# DCN shapes of tests/test_ops.py:225 and :264 as (n, cin, cout, h, w)
DCN_SHAPES = [(2, 3, 5, 8, 6), (2, 4, 6, 8, 11)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dcn_inputs(n, cin, cout, h, w, seed=7, far=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    offset = (rng.rand(n, h, w, 18).astype(np.float32) * 2 - 1) * 1.4
    if far:
        # the recipe of tests/test_ops.py:243-251: some taps 5x further
        off = offset.reshape(n, h, w, 9, 2).copy()
        off[rng.rand(n, h, w, 9) < 0.15] *= 5.0
        offset = off.reshape(n, h, w, 18)
    mask = 1 / (1 + np.exp(-rng.randn(n, h, w, 9).astype(np.float32)))
    weight = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.2
    bias = rng.randn(cout).astype(np.float32)
    return x, offset, mask.astype(np.float32), weight, bias


@pytest.mark.parametrize('shape', DCN_SHAPES)
@pytest.mark.parametrize('radius', [1, 2])
@pytest.mark.parametrize('with_bias', [True, False])
def test_dcn_shift_plain_matches_pallas_and_xla_shift(shape, radius,
                                                      with_bias):
    """K1's plain version == deform_conv_shift_pallas(interpret=True) and
    == the XLA _deform_conv_shift, atol 3e-5 (fp32; the kernel's f32 tap
    accumulation and the XLA one agree in fp32 up to summation order)."""
    x, off, mask, w, b = _dcn_inputs(*shape)
    b = b if with_bias else None
    jargs = [jnp.asarray(a) for a in (x, off, mask, w)] + \
        [None if b is None else jnp.asarray(b)]
    pallas = deform_conv_shift_pallas(*jargs, radius=radius, interpret=True)
    xla = jdc._deform_conv_shift(*jargs, 3, 1, radius)
    got = dcn_shift.deform_conv_shift(
        *[_t(a) for a in (x, off, mask, w)],
        None if b is None else _t(b), radius=radius)
    assert got.shape == pallas.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=3e-5)


@pytest.mark.parametrize('mode', ['patch', 'hybrid_pallas', 'hybrid',
                                  'shift_pallas', 'shift'])
def test_modulated_deform_conv_modes_match_jax(mode):
    """The port's modes == the same mode in JAX, and the exact and repaired
    modes == JAX 'patch', on far offsets (atol 3e-5, fp32)."""
    n, cin, cout, h, w = DCN_SHAPES[0]
    x, off, mask, wt, b = _dcn_inputs(n, cin, cout, h, w, far=True)
    kw = dict(shift_radius=1, shift_budget=h * w)
    want = jdc.modulated_deform_conv(
        *[jnp.asarray(a) for a in (x, off, mask, wt, b)], gather_mode=mode,
        **kw)
    got = tdc.modulated_deform_conv(
        *[_t(a) for a in (x, off, mask, wt, b)], gather_mode=mode, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    if mode in ('patch', 'hybrid_pallas', 'hybrid'):
        exact = jdc.modulated_deform_conv(
            *[jnp.asarray(a) for a in (x, off, mask, wt, b)],
            gather_mode='patch')
        np.testing.assert_allclose(got.numpy(), np.asarray(exact),
                                   atol=3e-5)


def test_hybrid_repair_skipped_in_radius_and_overflow_count():
    """In-radius offsets: 'hybrid_pallas' is bitwise the kernel base (the
    repair does not run). deform_offset_overflow == JAX's, exactly."""
    n, cin, cout, h, w = DCN_SHAPES[1]
    x, off, mask, wt, b = _dcn_inputs(n, cin, cout, h, w, seed=3)
    small = np.clip(off, -0.9, 0.9)
    args = [_t(a) for a in (x, small, mask, wt, b)]
    got = tdc.modulated_deform_conv(*args, gather_mode='hybrid_pallas',
                                    shift_radius=1, shift_budget=4)
    base = tdc.modulated_deform_conv(*args, gather_mode='shift_pallas',
                                     shift_radius=1)
    assert torch.equal(got, base)
    _, far, _, _, _ = _dcn_inputs(n, cin, cout, h, w, seed=3, far=True)
    for budget in (0, 2, 40):
        want = jdc.deform_offset_overflow(jnp.asarray(far), 1, budget)
        got = tdc.deform_offset_overflow(_t(far), 1, budget)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_bilinear_abs_matches_jax():
    """Out-of-bounds and integer border coordinates, and coordinates
    >= 128 on a wide image (atol 1e-6, fp32)."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 9, 200, 5).astype(np.float32)
    coords = [
        (rng.uniform(-3, 203, (2, 64)), rng.uniform(-3, 12, (2, 64))),
        (rng.randint(-2, 202, (2, 32)).astype(np.float64),
         rng.randint(-2, 11, (2, 32)).astype(np.float64)),
        (rng.uniform(128, 199, (2, 4, 8)), rng.uniform(0, 8, (2, 4, 8))),
    ]
    for x, y in coords:
        x = x.astype(np.float32)
        y = y.astype(np.float32)
        want = jinterp.sample_bilinear_abs(jnp.asarray(img), jnp.asarray(x),
                                           jnp.asarray(y))
        got = interp.sample_bilinear_abs(_t(img), _t(x), _t(y))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize('hw', [(10, 14), (5, 7), (3, 20)])
def test_resizes_match_jax(hw):
    """interpolate_bilinear_ac and upsample_nearest (atol 1e-6)."""
    x = np.random.RandomState(1).randn(2, 5, 7, 4).astype(np.float32)
    want = jinterp.interpolate_bilinear_ac(jnp.asarray(x), *hw)
    got = interp.interpolate_bilinear_ac(_t(x), *hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jinterp.upsample_nearest(jnp.asarray(x), *hw)
    got = interp.upsample_nearest(_t(x), *hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _nms_case(M=48, J=15, seed=11):
    rng = np.random.RandomState(seed)
    kpts = rng.rand(M, J, 2).astype(np.float32) * 60
    kpts[1::3] = kpts[0::3][:len(kpts[1::3])] + \
        rng.randn(*kpts[1::3].shape).astype(np.float32)
    scores = rng.rand(M).astype(np.float32)
    areas = (kpts[..., 0].max(1) - kpts[..., 0].min(1)) * \
        (kpts[..., 1].max(1) - kpts[..., 1].min(1))
    return kpts, scores, areas


@pytest.mark.parametrize('max_dets', [None, 10])
def test_oks_nms_fixed_matches_jax_and_numpy(max_dets):
    """Hard OKS-NMS: the same picks in the same order as JAX's
    oks_nms_fixed and the numpy reference oks_nms_np; the valid mask is
    respected; a batch of images gives each image's own result."""
    kpts, scores, areas = _nms_case()
    M, J = kpts.shape[:2]
    sig = oks_nms.default_sigmas(J)
    valid = np.ones(M, bool)
    valid[5] = False
    want_idx, want_ok = jnms.oks_nms_fixed(
        jnp.asarray(kpts), jnp.asarray(scores), jnp.asarray(areas),
        jnp.asarray(valid), 0.9, sig, max_dets=max_dets)
    got_idx, got_ok = oks_nms.oks_nms_fixed(
        _t(kpts), _t(scores), _t(areas), _t(valid), 0.9, sig,
        max_dets=max_dets)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))

    keep = got_idx.numpy()[got_ok.numpy()]
    db = [dict(score=scores[i], area=areas[i], keypoints=np.concatenate(
        [kpts[i], np.ones((J, 1), np.float32)], -1))
        for i in range(M) if valid[i]]
    ids = np.flatnonzero(valid)
    ref = ids[jnms.oks_nms_np(db, thr=0.9)]
    np.testing.assert_array_equal(keep, ref[:len(keep)])

    k2, s2, a2 = _nms_case(seed=12)
    b_idx, b_ok = oks_nms.oks_nms_fixed(
        _t(np.stack([kpts, k2])), _t(np.stack([scores, s2])),
        _t(np.stack([areas, a2])), _t(np.stack([valid, np.ones(M, bool)])),
        0.9, sig, max_dets=max_dets)
    np.testing.assert_array_equal(b_idx[0].numpy(), got_idx.numpy())
    one_idx, _ = oks_nms.oks_nms_fixed(_t(k2), _t(s2), _t(a2),
                                       torch.ones(M, dtype=torch.bool), 0.9,
                                       sig, max_dets=max_dets)
    np.testing.assert_array_equal(b_idx[1].numpy(), one_idx.numpy())


def test_soft_oks_nms_fixed_matches_jax():
    """Soft OKS-NMS: identical selection order to JAX's."""
    kpts, scores, areas = _nms_case(seed=5)
    sig = oks_nms.default_sigmas(kpts.shape[1])
    valid = np.ones(len(scores), bool)
    want = jnms.soft_oks_nms_fixed(jnp.asarray(kpts), jnp.asarray(scores),
                                   jnp.asarray(areas), jnp.asarray(valid),
                                   0.3, 20, sig)
    got = oks_nms.soft_oks_nms_fixed(_t(kpts), _t(scores), _t(areas),
                                     _t(valid), 0.3, 20, sig)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dcn_shift_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches or raises; it never falls back.
    Here (no card) a CUDA-typed call cannot launch, and a device the kernel
    does not serve raises."""
    x, off, mask, w, b = _dcn_inputs(*DCN_SHAPES[0])
    with pytest.raises(ValueError):
        dcn_shift.deform_conv_shift(_t(x).to('meta'), _t(off), _t(mask),
                                    _t(w), _t(b))
    before = dcn_shift.launches
    dcn_shift.deform_conv_shift(_t(x), _t(off), _t(mask), _t(w), _t(b))
    assert dcn_shift.launches == before     # the plain version is no launch
