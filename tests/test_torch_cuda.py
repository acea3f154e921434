"""The port's hand kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (sm_90) and nvcc; without them they skip.
They import neither JAX nor ``das_tpu``, so they also run where JAX is not
installed; there, skip the JAX test harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from das_tpu_torch.ops import dcn_shift
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
