"""The port's hand kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (sm_90) and nvcc; without them they skip.
They import neither JAX nor ``das_tpu``, so they also run where JAX is not
installed; there, skip the JAX test harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from das_tpu_torch.ops import conv_gn, dcn_shift, oks_nms
from das_tpu_torch.ops.deform_conv import modulated_deform_conv

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
    (the tap tiles are the plain version's bit for bit; the f32 sums run
    in another order, so the bf16 rounding of a sum can differ)."""
    a = list(_inputs(1, 160, 288, 256, 256, torch.bfloat16, cuda,
                     spread=0.8))
    a[3] = a[3] * 0.25
    got = dcn_shift.deform_conv_shift(*a, radius=1).float()
    want = dcn_shift.deform_conv_shift_plain(*a, radius=1).float()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


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


def _convgn_inputs(n, h, w, cin, cout, dt, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=g)
    wt = torch.randn(3, 3, cin, cout, generator=g) * 0.05
    gamma = torch.rand(cout, generator=g) + 0.5
    beta = torch.randn(cout, generator=g) * 0.1
    return x.to(dev, dt), wt.to(dev, dt), gamma.to(dev), beta.to(dev)


# tests/test_ops.py:474-475 as (n, h, w, cin, cout, groups), and element-path
# shapes: Cin or Cout not a multiple of 8, a ragged last pixel tile
CONVGN_SHAPES = [(2, 8, 16, 8, 8, 4), (2, 10, 18, 32, 64, 8),
                 (2, 20, 36, 64, 64, 32), (1, 9, 7, 3, 6, 3),
                 (2, 5, 11, 12, 130, 13)]


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


@pytest.mark.parametrize('cout', [256, 64])
def test_conv_gn_kernel_matches_plain_bf16_serving_width(cuda, cout):
    """bf16 at the head's widths (256 -> 256 and 256 -> 64, 32 groups) on the
    stride-16 level of a B=4 request: max error <= 1e-2 x max|ref|."""
    a = _convgn_inputs(4, 80, 144, 256, cout, torch.bfloat16, cuda, seed=1)
    got = conv_gn.conv_gn_relu(*a, groups=32).float()
    want = conv_gn.conv_gn_relu_plain(*a, groups=32).float()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


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
                                   (4, 3720, 15)])
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
