"""Parity of the port's fused conv+GN+relu (K2) and OKS-NMS keep mask (K3)
with the JAX package, and of the bias-free fused-GN head end to end.

The same inputs, made from a seed with numpy, go through the JAX function
and its port counterpart on the CPU (TF32 off); the Pallas kernels run in
interpret mode, as the JAX package's own tests run them. On the CPU the
port's wrappers run their plain versions. Tolerances are stated per test.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu.ops import oks_nms as jnms  # noqa: E402
from das_tpu.ops.pallas_convgn import conv_gn_relu as jconv_gn_relu  # noqa
from das_tpu.ops.pallas_nms import oks_nms_pallas  # noqa: E402
from das_tpu.core import decode as jdecode  # noqa: E402
from das_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from das_tpu_torch.core.decode import decode_batch  # noqa: E402
from das_tpu_torch.models import build_model  # noqa: E402
from das_tpu_torch.models.layers import ConvModule  # noqa: E402
from das_tpu_torch.ops import conv_gn, oks_nms  # noqa: E402
from test_torch_model import (HW, J, STRIDES, TEST_CFG,  # noqa: E402
                              TINY_MODEL, _img, _seeded_tree, _tree_shapes)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_ops.py:474-475 as (h, w, cin, cout, groups)
CONVGN_SHAPES = [(8, 16, 8, 8, 4), (10, 18, 32, 64, 8), (20, 36, 64, 64, 32)]
FUSED_MODEL = dict(TINY_MODEL, bbox_head=dict(
    TINY_MODEL['bbox_head'], conv_bias='auto', fused_gn=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _convgn_inputs(h, w, cin, cout, seed=3):
    """The recipe of tests/test_ops.py::test_conv_gn_relu_matches_xla."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    gamma = (rng.rand(cout) + 0.5).astype(np.float32)
    beta = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, wt, gamma, beta


@pytest.mark.parametrize('shape', CONVGN_SHAPES)
def test_conv_gn_relu_plain_matches_pallas(shape):
    """K2's plain version == conv_gn_relu(interpret=True), fp32, atol 2e-5
    (the JAX test's tolerance; the sums run in another order)."""
    h, w, cin, cout, g = shape
    args = _convgn_inputs(h, w, cin, cout)
    want = jconv_gn_relu(*[jnp.asarray(a) for a in args], groups=g,
                         interpret=True)
    got = conv_gn.conv_gn_relu(*[_t(a) for a in args], groups=g)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize('shape', CONVGN_SHAPES)
def test_conv_gn_relu_plain_matches_pallas_bf16(shape):
    """bf16 x and weight: the output is bf16 in both, from f32 sums of exact
    bf16 products; the f32 results differ by summation order only, so the
    rounded outputs differ by at most one bf16 step (2^-8 relative):
    rtol 2^-7, atol 1e-5 for values that round to zero."""
    h, w, cin, cout, g = shape
    x, wt, gamma, beta = _convgn_inputs(h, w, cin, cout, seed=4)
    want = jconv_gn_relu(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(wt, jnp.bfloat16), jnp.asarray(gamma),
                         jnp.asarray(beta), groups=g, interpret=True)
    got = conv_gn.conv_gn_relu(_t(x).bfloat16(), _t(wt).bfloat16(),
                               _t(gamma), _t(beta), groups=g)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)


def test_conv_gn_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches or raises; it never falls back. A
    device the kernel does not serve raises; the plain version is no
    launch."""
    x, wt, gamma, beta = _convgn_inputs(*CONVGN_SHAPES[0][:4])
    with pytest.raises(ValueError):
        conv_gn.conv_gn_relu(_t(x).to('meta'), _t(wt), _t(gamma), _t(beta),
                             groups=4)
    before = conv_gn.launches
    conv_gn.conv_gn_relu(_t(x), _t(wt), _t(gamma), _t(beta), groups=4)
    assert conv_gn.launches == before


def _module_pair(cin, cout, groups, seed=0, **kw):
    """A ConvModule(3x3, GN, relu) with fused_gn and the same module
    unfused, holding the same seeded weights."""
    cfg = dict(norm_cfg=dict(type='GN', num_groups=groups), **kw)
    fused = ConvModule(cin, cout, 3, 1, 1, fused_gn=True, **cfg).eval()
    plain = ConvModule(cin, cout, 3, 1, 1, **cfg).eval()
    rng = np.random.RandomState(seed)
    sd = {k: _t((rng.randn(*v.shape) * (0.1 if v.dim() == 4 else 1.0)
                 + (1.0 if k == 'gn.weight' else 0.0)).astype(np.float32))
          for k, v in fused.state_dict().items()}
    fused.load_state_dict(sd, strict=True)
    plain.load_state_dict(sd, strict=True)
    return fused, plain


@pytest.mark.parametrize('cin,cout,groups', [(16, 32, 8), (32, 64, 32)])
def test_fused_conv_module_matches_unfused(cin, cout, groups, monkeypatch):
    """Fused against unfused ConvModule on the same weights, fp32, NCHW in
    and out: atol 1e-5 (the unfused GN rounds nothing more in fp32; the
    statistics are summed in another order and torch's group_norm takes a
    two-pass variance). The gate opened once; the state dict keys are the
    unfused module's."""
    calls = []
    real = conv_gn.conv_gn_relu
    monkeypatch.setattr(conv_gn, 'conv_gn_relu',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fused, plain = _module_pair(cin, cout, groups)
    assert sorted(fused.state_dict()) == ['conv.weight', 'gn.bias',
                                          'gn.weight']
    x = _t(np.random.RandomState(1).randn(2, cin, 9, 13).astype(np.float32))
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert len(calls) == 1
    assert got.shape == want.shape == (2, cout, 9, 13)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_fused_gate_stays_closed_off_its_conditions():
    """The gate is the JAX ``_use_fused_gn``'s: closed with a conv bias,
    in training mode, for the DCN conv, for another kernel size or stride
    or padding, without relu, and for BN."""
    fused, _ = _module_pair(8, 8, 4)
    assert fused.use_fused_gn()
    assert not fused.train().use_fused_gn()
    gn = dict(norm_cfg=dict(type='GN', num_groups=4), fused_gn=True)
    closed = [
        ConvModule(8, 8, 3, 1, 1, bias=True, **gn),
        ConvModule(8, 8, 3, 1, 1, dcn=True, **gn),
        ConvModule(8, 8, 1, 1, 0, **gn),
        ConvModule(8, 8, 3, 2, 1, **gn),
        ConvModule(8, 8, 3, 1, 2, **gn),
        ConvModule(8, 8, 3, 1, 1, act=None, **gn),
        ConvModule(8, 8, 3, 1, 1, norm_cfg=dict(type='BN'), fused_gn=True),
        ConvModule(8, 8, 3, 1, 1, norm_cfg=dict(type='GN', num_groups=4)),
    ]
    for m in closed:
        assert not m.eval().use_fused_gn(), m


def _nms_cases():
    """The cases of tests/test_pallas_nms.py: M=48, J=15 with near
    duplicates, all valid; M=16, J=4 with the valid mask."""
    rng = np.random.RandomState(11)
    M, J = 48, 15
    kpts = rng.rand(M, J, 2).astype(np.float32) * 60
    kpts[1::3] = kpts[0::3][:len(kpts[1::3])] + \
        rng.randn(*kpts[1::3].shape).astype(np.float32)
    scores = np.sort(rng.rand(M).astype(np.float32))[::-1].copy()
    areas = ((kpts[..., 0].max(1) - kpts[..., 0].min(1)) *
             (kpts[..., 1].max(1) - kpts[..., 1].min(1))).astype(np.float32)
    yield kpts, scores, areas, np.ones(M, bool)
    M, J = 16, 4
    kpts = rng.rand(M, J, 2).astype(np.float32) * 50
    kpts[1::2] = kpts[0::2] + rng.randn(M // 2, J, 2).astype(np.float32)
    valid = np.zeros(M, bool)
    valid[:5] = True
    yield (kpts, np.linspace(1, 0.1, M).astype(np.float32),
           np.full(M, 100.0, np.float32), valid)


@pytest.mark.parametrize('case', [0, 1])
def test_oks_nms_keep_plain_matches_pallas_numpy_and_fixed(case):
    """K3's plain version: the keep mask equals oks_nms_pallas
    (interpret=True) and oks_nms_np exactly; its kept indices are the first
    picks of the port's oks_nms_fixed; a batch gives each image's mask."""
    kpts, scores, areas, valid = list(_nms_cases())[case]
    M, J = kpts.shape[:2]
    sig = oks_nms.default_sigmas(J)
    want = np.asarray(oks_nms_pallas(jnp.asarray(kpts), jnp.asarray(areas),
                                     jnp.asarray(valid), 0.9, sig,
                                     interpret=True))
    got = oks_nms.oks_nms_keep(_t(kpts), _t(areas), _t(valid), 0.9, sig)
    assert got.dtype == torch.bool and got.shape == (M,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.sum() < M

    ids = np.flatnonzero(valid)
    db = [dict(score=scores[i], area=areas[i], keypoints=np.concatenate(
        [kpts[i], np.ones((J, 1), np.float32)], -1)) for i in ids]
    ref = np.zeros(M, bool)
    ref[ids[jnms.oks_nms_np(db, thr=0.9)]] = True
    np.testing.assert_array_equal(got.numpy(), ref)

    idx, ok = oks_nms.oks_nms_fixed(_t(kpts), _t(scores), _t(areas),
                                    _t(valid), 0.9, sig, max_dets=10)
    kept = np.flatnonzero(got.numpy())
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()],
                                  kept[:int(ok.sum())])

    batch = oks_nms.oks_nms_keep(_t(np.stack([kpts, kpts[::-1].copy()])),
                                 _t(np.stack([areas, areas[::-1].copy()])),
                                 _t(np.stack([valid, valid])), 0.9, sig)
    np.testing.assert_array_equal(batch[0].numpy(), got.numpy())
    one = oks_nms.oks_nms_keep(_t(kpts[::-1].copy()),
                               _t(areas[::-1].copy()), _t(valid), 0.9, sig)
    np.testing.assert_array_equal(batch[1].numpy(), one.numpy())


def test_oks_nms_keep_wrapper_refuses_what_the_kernel_does_not_take():
    kpts, _, areas, valid = next(_nms_cases())
    sig = oks_nms.default_sigmas(kpts.shape[1])
    with pytest.raises(ValueError):
        oks_nms.oks_nms_keep(_t(kpts).to('meta'), _t(areas), _t(valid), 0.9,
                             sig)
    before = oks_nms.launches
    oks_nms.oks_nms_keep(_t(kpts), _t(areas), _t(valid), 0.9, sig)
    assert oks_nms.launches == before


def test_fused_gn_head_matches_jax_fused_model(monkeypatch):
    """The tiny model with ``conv_bias='auto', fused_gn=True`` in JAX (its
    fused path runs conv_gn_relu in interpret mode) and in the port, on the
    same seeded tree converted by state_dict_from_flax (strict): head
    outputs and decode_batch at rtol 1e-3 (tests/test_model.py:270) and
    atol 1e-4 x max(1, max|ref|) of the level or decoded array, as in
    tests/test_torch_model.py: pose channels are uv x stride and reach
    ~200 px, and the DCN and GN sums run in another order, so the absolute
    error scales with them (~1e-6 of the scale here). The port's fused gate
    opened 9 times per level: 3 tower convs, conv_cls_prev, 4 reg/pose
    prevs, conv_centerness_prev."""
    jmodel = jbuild_model(FUSED_MODEL)
    tree = _seeded_tree(_tree_shapes(jmodel), seed=6, offset_std=0.8)
    jvars = {c: jax.tree_util.tree_map(jnp.asarray, t)
             for c, t in tree.items()}
    model = build_model(FUSED_MODEL, device='cpu')
    model.load_state_dict(
        state_dict_from_flax(tree['params'], tree['batch_stats']),
        strict=True)
    assert not any(k.startswith('bbox_head.') and 'convs' in k
                   and k.endswith('conv.bias') for k in model.state_dict())

    calls = []
    real = conv_gn.conv_gn_relu
    monkeypatch.setattr(conv_gn, 'conv_gn_relu',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    img = _img(8, hw=HW)
    with torch.no_grad():
        outs = model(torch.from_numpy(img))
    assert len(calls) == 9 * len(STRIDES)
    jouts = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jvars, jnp.asarray(img))
    for name, got_l, want_l in zip(('cls', 'pose', 'ctr', 'ref_uvd'), outs,
                                   jouts):
        for lvl, (got, want) in enumerate(zip(got_l, want_l)):
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                       atol=1e-4 * scale,
                                       err_msg=f'{name} level {lvl}')

    sf = np.array([[1.0, 1.0], [0.8, 1.25]], np.float32)
    want = jdecode.decode_batch(*[list(o) for o in jouts[:3]], STRIDES,
                                jnp.asarray(sf), J, TEST_CFG)
    got = decode_batch(*outs[:3], STRIDES, torch.from_numpy(sf), J,
                       TEST_CFG)
    valid = np.asarray(want['valid'])
    assert valid.any()
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    for k in ('scores', 'poses', 'centers'):
        ref = np.asarray(want[k])[valid]
        np.testing.assert_allclose(
            got[k].numpy()[valid], ref, rtol=1e-3,
            atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=k)
