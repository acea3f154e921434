"""The port's loss gradients at exact ties against ``jax.grad`` of the JAX
package's losses (``das_tpu/losses/{common,rle_loss}.py``).

At a logit of exactly 0, ``jnp.maximum(x, 0)`` passes half of the gradient
and ``jnp.abs``' is +1; at ``gt_uvd == uvd`` the residual's ``jnp.abs``' is
+1. The port writes the same functions with ``torch.maximum`` and the
``where`` form of ``|x|`` so that autograd gives those values, and keeps the
forward values bit for bit. Inputs are made with numpy; f32 on the CPU.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.losses import common as jcommon  # noqa: E402
from das_tpu.losses.rle_loss import rle_loss as jrle_loss  # noqa: E402
from das_tpu_torch.losses import (binary_cross_entropy,  # noqa: E402
                                  rle_loss, sigmoid_focal_loss)
from das_tpu_torch.losses.common import _bce_with_logits  # noqa: E402

# logits at and near the kink, with their targets
LOGITS = np.array([0.0, 0.0, 1e-3, -1e-3, 1e-3, -1e-3, -2.0, -2.0, 0.0],
                  np.float32)
TARGETS = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.5],
                   np.float32)


def _grad_torch(fn, *arrays):
    """fn's value and its gradient in the first argument, by autograd."""
    ts = [torch.tensor(a) for a in arrays]
    ts[0].requires_grad_(True)
    out = fn(*ts)
    (g,) = torch.autograd.grad(out, ts[0])
    return out.detach().numpy(), g.numpy()


def _grad_jax(fn, *arrays):
    value, g = jax.value_and_grad(fn)(*[jnp.asarray(a) for a in arrays])
    return np.asarray(value), np.asarray(g)


def _old_bce(logits, targets):
    """The port's formula before the repair, for the forward's bits."""
    return logits.clamp_min(0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))


def test_bce_gradient_at_zero_is_jax():
    """The acceptance case: logits [0, 0], targets [1, 0] -> [-1, 0]."""
    _, g = _grad_torch(lambda x, t: _bce_with_logits(x, t).sum(),
                       np.zeros(2, np.float32),
                       np.array([1.0, 0.0], np.float32))
    np.testing.assert_array_equal(g, np.array([-1.0, 0.0], np.float32))
    _, gj = _grad_jax(lambda x, t: jcommon._bce_with_logits(x, t).sum(),
                      np.zeros(2, np.float32),
                      np.array([1.0, 0.0], np.float32))
    np.testing.assert_array_equal(g, gj)


@pytest.mark.parametrize('i', range(len(LOGITS)))
def test_bce_elementwise_matches_jax(i):
    """Each (logit, target): gradient equal to jax.grad's, value within an
    ulp of JAX's and bit-equal to the formula before the repair."""
    x, t = LOGITS[i:i + 1], TARGETS[i:i + 1]
    v, g = _grad_torch(lambda a, b: _bce_with_logits(a, b).sum(), x, t)
    vj, gj = _grad_jax(lambda a, b: jcommon._bce_with_logits(a, b).sum(),
                       x, t)
    np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v, vj, rtol=1e-6, atol=0)
    old = _old_bce(torch.tensor(x), torch.tensor(t)).sum().numpy()
    assert v.tobytes() == old.tobytes()


@pytest.mark.parametrize('weighted', [False, True])
def test_binary_cross_entropy_grad_matches_jax(weighted):
    """mmdet's BCE (the centerness loss), with and without a weight."""
    w = np.linspace(0.5, 1.5, LOGITS.size).astype(np.float32)
    kw = dict(weight=w) if weighted else {}
    v, g = _grad_torch(
        lambda a, b: binary_cross_entropy(
            a, b, **{k: torch.tensor(x) for k, x in kw.items()}),
        LOGITS, TARGETS)
    vj, gj = _grad_jax(
        lambda a, b: jcommon.binary_cross_entropy(
            a, b, **{k: jnp.asarray(x) for k, x in kw.items()}),
        LOGITS, TARGETS)
    np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(v, vj, rtol=1e-6)


def test_focal_loss_grad_at_zero_matches_jax():
    """The focal cls loss over logits that hold exact zeros, with the
    foreground and the background labels."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    logits[::2, 1] = 0.0
    logits[1, :] = 0.0
    logits[3, 2] = 1e-3
    logits[5, 3] = -2.0
    labels = np.array([1, 4, 0, 2, 1, 3], np.int32)   # 4 is background
    v, g = _grad_torch(lambda a: sigmoid_focal_loss(
        a, torch.from_numpy(labels), avg_factor=5.0), logits)
    vj, gj = _grad_jax(lambda a: jcommon.sigmoid_focal_loss(
        a, labels, avg_factor=5.0), logits)
    np.testing.assert_allclose(g, gj, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v, vj, rtol=1e-6)
    old_bce = _bce_with_logits
    # the forward through the old formula is the same float
    import das_tpu_torch.losses.common as common
    common._bce_with_logits = _old_bce
    try:
        with torch.no_grad():
            old = sigmoid_focal_loss(torch.tensor(logits),
                                     torch.from_numpy(labels),
                                     avg_factor=5.0).numpy()
    finally:
        common._bce_with_logits = old_bce
    assert v.tobytes() == old.tobytes()


def _rle_inputs(tie: str):
    rng = np.random.default_rng(1)
    shape = (3, 5, 3)
    uvd = rng.normal(size=shape).astype(np.float32)
    gt = rng.normal(size=shape).astype(np.float32)
    if tie == 'all':
        gt = uvd.copy()
    elif tie == 'some':
        gt[0] = uvd[0]
        gt[2, 1:3] = uvd[2, 1:3]
    nf = rng.normal(size=shape).astype(np.float32)
    sigma = rng.uniform(0.05, 1.0, size=shape).astype(np.float32)
    vis = (rng.uniform(size=shape[:2]) > 0.3).astype(np.float32)
    vis = np.repeat(vis[..., None], 3, -1)
    return uvd, nf, sigma, gt, vis


@pytest.mark.parametrize('tie', ['all', 'some', 'none'])
@pytest.mark.parametrize('wrt', ['uvd', 'gt_uvd'])
def test_rle_residual_grad_at_ties_matches_jax(tie, wrt):
    """The RLE loss's gradient in uvd and in gt_uvd where gt_uvd == uvd
    (all, some or no elements) equals jax.grad's; the value is bit-equal
    to the formula before the repair."""
    uvd, nf, sigma, gt, vis = _rle_inputs(tie)

    def port(a, b):
        u, t = (a, b) if wrt == 'uvd' else (b, a)
        return rle_loss(torch.tensor(nf), u, torch.tensor(sigma), t,
                        torch.tensor(vis), weight=2.0)

    def ref(a, b):
        u, t = (a, b) if wrt == 'uvd' else (b, a)
        return jrle_loss(jnp.asarray(nf), u, jnp.asarray(sigma), t,
                         jnp.asarray(vis), weight=2.0)

    first, second = (uvd, gt) if wrt == 'uvd' else (gt, uvd)
    v, g = _grad_torch(port, first, second)
    vj, gj = _grad_jax(ref, first, second)
    np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v, vj, rtol=1e-6)
    # the residual's forward as it was written before the repair
    t = {k: torch.tensor(a) for k, a in
         dict(nf=nf, uvd=uvd, sigma=sigma, gt=gt, vis=vis).items()}
    amp = 1.0 / np.sqrt(2.0 * np.pi)
    nfl = t['nf'] * t['vis']
    log_q = torch.log(t['sigma'] / amp) + (t['gt'] - t['uvd']).abs() \
        / (np.sqrt(2.0) * t['sigma'] + 1e-9)
    old = ((nfl + log_q * t['vis']) * 2.0).sum() \
        / t['vis'][..., 0].sum().clamp_min(1e-9)
    assert v.tobytes() == old.numpy().tobytes()
