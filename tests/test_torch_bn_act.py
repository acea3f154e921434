"""The served BatchNorm's one pass (``das_tpu_torch.ops.bn_act``) on the
CPU, where the wrapper runs its plain version: the plain version against
the chain of PyTorch calls it replaces, the eval BatchNorm against flax's,
the route that ``models.layers.BatchNorm`` takes, and the number of calls a
served forward of each shipped backbone makes. The kernel itself runs only
on the card (``tests/test_torch_cuda.py``)."""

import os

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from das_tpu_torch.apis import init_model  # noqa: E402
from das_tpu_torch.models.layers import (BatchNorm, GroupNorm,  # noqa: E402
                                         norm_act)
from das_tpu_torch.ops import bn_act  # noqa: E402

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'das')
# BatchNorms of each shipped configuration, the backbone's and the FPN's
# (SyncBN on its 4 lateral and 4 output convs)
BATCHNORMS = {'exp_panoptic': (128, 8), 'exp_mupots': (196, 8),
              'exp_panoptic_hrnet48': (305, 8)}


def _inputs(dt, C=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, C, 9, 11, generator=g) * 3 + 1
    w, b, m = (torch.randn(C, generator=g) for _ in range(3))
    v = torch.rand(C, generator=g) + 0.1
    r = torch.randn(3, C, 9, 11, generator=g) * 2
    return x.to(dt), w, b, m, v, r.to(dt)


def _ulp(t, dt):
    """The spacing of ``dt`` at each value of ``t`` (at the smallest
    normal for zeros)."""
    bits = 8 if dt == torch.bfloat16 else 24
    tiny = torch.finfo(dt).tiny
    _, e = torch.frexp(t.abs().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(t), e - bits)


def _chain(x, w, b, m, v, residual, relu):
    """The chain the one pass replaces: f32 cast, PyTorch's eval batch
    norm, the cast back, the add, the ReLU."""
    y = F.batch_norm(x.float(), m, v, w, b, False, 0.0, 1e-5).to(x.dtype)
    bn = y
    if residual is not None:
        y = y + residual
    return (F.relu(y) if relu else y), bn


@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('residual', [False, True],
                         ids=['bn', 'bn+residual'])
@pytest.mark.parametrize('relu', [False, True], ids=['', 'relu'])
def test_plain_version_is_the_chain_within_an_ulp(dt, residual, relu):
    """``bn_act_plain`` against the chain: bf16 within one bf16 ulp of the
    larger of the norm's output and the result (the affine's f32 order is
    the plain version's own, so a rounding to bf16 can fall the other
    way); f32 within 4 f32 ulps of the largest of the affine's terms, the
    norm's output and the result."""
    x, w, b, m, v, r = _inputs(dt)
    res = r if residual else None
    got = bn_act.bn_act_plain(x, w, b, m, v, residual=res, relu=relu)
    want, bn = _chain(x, w, b, m, v, res, relu)
    assert got.dtype == dt and got.shape == x.shape
    err = (got.float() - want.float()).abs()
    if dt == torch.bfloat16:
        tol = _ulp(torch.maximum(bn.float().abs(), want.float().abs()), dt)
    else:
        scale, shift = bn_act.affine(w, b, m, v, 1e-5)
        terms = torch.maximum((x * scale[:, None, None]).abs(),
                              shift.abs()[:, None, None])
        tol = 4 * _ulp(torch.maximum(terms, torch.maximum(
            bn.abs(), want.abs())), dt)
    assert bool((err <= tol).all()), (err - tol).max().item()


@pytest.mark.parametrize('route', ['fused', 'chain'])
def test_eval_batchnorm_matches_flax(route):
    """The eval BatchNorm, by the one pass (no autograd) and by the chain
    (autograd records), against flax's BatchNorm with the running average,
    rtol 1e-5 and atol 1e-5 (the train-mode test's tolerance,
    tests/test_torch_train.py)."""
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 6, 5, 8) * 2 + 1).astype(np.float32)     # NHWC
    g, b, rm = (rng.randn(3, 8) * 0.3).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5).apply(
        dict(params=dict(scale=g, bias=b),
             batch_stats=dict(mean=rm, var=rv)), jnp.asarray(x))
    port = BatchNorm(8).eval()
    port.load_state_dict(dict(weight=torch.from_numpy(g),
                              bias=torch.from_numpy(b),
                              running_mean=torch.from_numpy(rm),
                              running_var=torch.from_numpy(rv)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.set_grad_enabled(route == 'chain'):
        assert port.fused(xt) == (route == 'fused')
        got = port(xt).detach().permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


ROUTES = {'eval, no grad': (False, False, False, False, True),
          'eval, inference mode': (False, False, False, True, True),
          'train mode': (True, False, False, False, False),
          'x requires grad': (False, True, False, False, False),
          'weight requires grad': (False, False, True, False, False)}


@pytest.mark.parametrize('case', list(ROUTES))
@pytest.mark.parametrize('dt', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_route_keeps_the_chain_where_autograd_records(monkeypatch, case,
                                                      dt):
    """``BatchNorm.act`` (with a residual and ReLU) takes the one pass only
    in eval where autograd does not record: train mode, an ``x`` that
    requires grad under grad mode and a weight that does each keep the
    chain, bit for bit, and never call ``ops.bn_act``; the one pass is
    within the plain version's ulp of the chain. On the CPU no kernel
    launches either way."""
    train, x_grad, w_grad, inference, fused = ROUTES[case]
    x, w, b, m, v, r = _inputs(dt)
    bn = BatchNorm(x.shape[1]).train(train)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(m)
        bn.running_var.copy_(v)
    bn.weight.requires_grad_(w_grad)
    bn.bias.requires_grad_(False)
    x.requires_grad_(x_grad)
    calls = []
    real = bn_act.bn_act

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(bn_act, 'bn_act', spy)
    launches = bn_act.launches
    mode = torch.inference_mode() if inference \
        else torch.set_grad_enabled(x_grad or w_grad)
    with mode:
        got = bn.act(x, r, relu=True)
    assert len(calls) == int(fused) and bn_act.launches == launches
    if fused:
        want, _ = _chain(x, w, b, m, v, r, True)
        tol = _ulp(want.float().abs(), torch.bfloat16)
        assert bool(((got.float() - want.float()).abs() <= tol).all())
        return
    ref = BatchNorm(x.shape[1]).train(train)
    ref.load_state_dict(dict(weight=w, bias=b, running_mean=m,
                             running_var=v))
    with torch.no_grad():
        want = F.relu(ref._chain(x.detach()) + r)
    assert torch.equal(got.detach(), want)
    assert got.requires_grad == (x_grad or w_grad)


@pytest.mark.parametrize('leaf', ['x', 'weight', 'residual'])
def test_bn_act_raises_where_autograd_records(leaf):
    """The one pass has no backward: where an input asks for a gradient
    under grad mode it raises, and it runs under ``no_grad``."""
    x, w, b, m, v, r = _inputs(torch.float32)
    t = dict(x=x, weight=w, residual=r)[leaf]
    t.requires_grad_(True)
    with pytest.raises(RuntimeError, match='no backward'):
        bn_act.bn_act(x, w, b, m, v, residual=r, relu=True)
    with torch.no_grad():
        assert bn_act.bn_act(x, w, b, m, v, residual=r).shape == x.shape


@pytest.mark.parametrize('norm', ['identity', 'gn'])
def test_norm_act_composes_other_norms(norm):
    """``norm_act`` on a norm that is not a BatchNorm (the ``nn.Identity``
    that ``fuse_conv_bn`` leaves, a GroupNorm): the norm, the add and the
    ReLU in turn."""
    x, *_, r = _inputs(torch.float32, C=32)
    mod = nn.Identity() if norm == 'identity' else GroupNorm(8, 32)
    with torch.no_grad():
        got = norm_act(mod, x, r, relu=True)
        assert torch.equal(got, F.relu(mod(x) + r))
        assert torch.equal(norm_act(mod, x), mod(x))


@pytest.mark.parametrize('name', list(BATCHNORMS))
def test_served_forward_takes_one_pass_a_batchnorm(monkeypatch, name):
    """A served bf16 forward of each shipped configuration (B=1 64x128)
    calls the one pass once for each of its BatchNorms (the backbone's and
    the FPN's), and a forward where autograd records (train mode, as a
    train step's) calls it for none of them, the frozen eval-mode stem's
    included."""
    model, _ = init_model(os.path.join(CFG_DIR, f'{name}.py'),
                          dtype=torch.bfloat16, device='cpu')
    backbone = sum(isinstance(m, BatchNorm)
                   for m in model.backbone.modules())
    neck = sum(isinstance(m, BatchNorm) for m in model.neck.modules())
    assert (backbone, neck) == BATCHNORMS[name]
    calls = []
    real = bn_act.bn_act_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(bn_act, 'bn_act_plain', counted)
    img = torch.randn(1, 64, 128, 3)
    with torch.inference_mode():
        model(img)
    assert len(calls) == backbone + neck
    calls.clear()
    model.train()
    assert any(not m.training for m in model.backbone.modules()
               if isinstance(m, BatchNorm))
    with torch.enable_grad():
        model.backbone(img.permute(0, 3, 1, 2))
    assert not calls
