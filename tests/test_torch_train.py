"""Parity of the port's training path (das_tpu_torch) with the JAX package.

On the CPU in fp32 (TF32 off), on inputs made from seeds with numpy: the
row gather K4's plain version and its gradient, the losses, the target
assignment, BatchNorm in train mode, the DCN gradients, the learning rate,
the parameter groups, frozen mask and optimizer update, and one whole step
of ``make_train_step`` on both sides from the same weights. The JAX variable
tree comes from ``jax.eval_shape`` of ``init_all`` (no eager init) and the
JAX step is compiled once per module (~85 s of XLA-CPU compile).
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.core.targets import get_targets as jget_targets  # noqa: E402
from das_tpu.losses import common as jcommon  # noqa: E402
from das_tpu.losses.rle_loss import rle_loss as jrle_loss  # noqa: E402
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu.ops.deform_conv import \
    modulated_deform_conv as jdeform  # noqa: E402
from das_tpu.parallel import train_step as jts  # noqa: E402
from das_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from das_tpu_torch.core.targets import get_targets  # noqa: E402
from das_tpu_torch.losses import (binary_cross_entropy,  # noqa: E402
                                  rle_loss, sigmoid_focal_loss,
                                  smooth_l1_loss)
from das_tpu_torch.models import build_trainable_model  # noqa: E402
from das_tpu_torch.models.layers import BatchNorm  # noqa: E402
from das_tpu_torch.ops import gather  # noqa: E402
from das_tpu_torch.ops.deform_conv import modulated_deform_conv  # noqa
from das_tpu_torch.parallel import (TrainState, frozen_mask,  # noqa: E402
                                    make_lr_fn, make_optimizer,
                                    make_train_step, mspn_frozen_prefixes,
                                    param_groups)
from test_torch_model import _seeded_tree, _tree_shapes  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

J = 4
HW = (64, 96)
FEATMAPS = [(HW[0] // (4 * 2 ** i), HW[1] // (4 * 2 ** i)) for i in range(4)]
MAX_POS = 64          # levels 0-1 (384, 96 points) sparse, 2-3 (24, 6) dense
# tests/test_model.py:19 with train_cfg.sparse_refine; test_cfg asks for the
# eval sparse selection at every level, which training must not take
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
                   sparse_refine=True),
    test_cfg=dict(nms_pre=4, nms_post=10, nms_thr=0.9, score_thr=0.05,
                  sparse_refine=True),
)
HEAD = TRAIN_MODEL['bbox_head']
UPDATE_RTOL = 5e-3    # see test_train_step_matches_jax


def _fake_batch(B=2, G=3):
    """tests/test_model.py's ``_fake_batch``, in numpy."""
    rng = np.random.RandomState(0)
    poses = np.zeros((B, G, 3 + 4 * J), np.float32)
    centers = rng.uniform(10, 80, (B, G, 2)).astype(np.float32)
    depths = rng.uniform(1, 3, (B, G)).astype(np.float32)
    poses[..., :2] = centers
    poses[..., 2] = depths
    joints = centers[..., None, :] + rng.uniform(-20, 20, (B, G, J, 2))
    uvd = np.concatenate([joints, rng.uniform(-0.5, 0.5, (B, G, J, 1))], -1)
    poses[..., 3:3 + 3 * J] = uvd.reshape(B, G, -1)
    poses[..., 3 + 3 * J:] = 1.0
    return dict(img=rng.randn(B, *HW, 3).astype(np.float32),
                gt_poses_3d=poses, gt_centers2d=centers, gt_depths=depths,
                gt_valid=np.ones((B, G), bool))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------------------------- K4, plain

@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('idx_dtype', [torch.int32, torch.int64])
def test_gather_rows_matches_take_along_axis_clip(dtype, idx_dtype):
    """gather_rows == take_along_axis(mode='clip') bit for bit, indices
    past the last row included. A negative index clamps to row 0 (jnp wraps
    negatives Python-style first; the model never passes one)."""
    rng = np.random.RandomState(0)
    table = rng.randn(3, 50, 6).astype(dtype)
    idx = rng.randint(0, 60, (3, 40))
    want = jnp.take_along_axis(jnp.asarray(table.astype(np.float32)),
                               jnp.asarray(idx)[..., None], axis=1,
                               mode='clip')
    got = gather.gather_rows(torch.from_numpy(table),
                             torch.from_numpy(idx).to(idx_dtype))
    assert got.shape == (3, 40, 6)
    np.testing.assert_array_equal(_np(got).astype(np.float32),
                                  np.asarray(want))
    neg = gather.gather_rows(torch.from_numpy(table),
                             torch.full((3, 2), -4, dtype=idx_dtype))
    np.testing.assert_array_equal(_np(neg), table[:, [0, 0]])


def test_gather_rows_gradcheck_and_jax_vjp():
    """The autograd Function with the plain forward and backward passes
    gradcheck in float64, and its gradient equals jax's adjoint of the
    clipped gather (f32, repeated and clamped indices)."""
    rng = np.random.RandomState(1)
    table = torch.from_numpy(rng.randn(2, 7, 3)).requires_grad_()
    idx = torch.from_numpy(rng.randint(0, 10, (2, 11)))
    assert torch.autograd.gradcheck(
        lambda t: gather.GatherRows.apply(t, idx, gather.gather_rows_plain,
                                          gather.scatter_rows_plain),
        (table,))
    t32 = table.detach().float().requires_grad_()
    ct = rng.randn(2, 11, 3).astype(np.float32)
    (gather.gather_rows(t32, idx) * torch.from_numpy(ct)).sum().backward()
    want = jax.grad(lambda t: (jnp.take_along_axis(
        t, jnp.asarray(idx.numpy())[..., None], axis=1, mode='clip')
        * ct).sum())(jnp.asarray(t32.detach().numpy()))
    np.testing.assert_allclose(_np(t32.grad), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ----------------------------------------------------------------- losses

def test_common_losses_match_jax():
    """Focal, BCE (weighted, averaged, mean) and smooth-L1, values and
    gradients, rtol 1e-5."""
    rng = np.random.RandomState(2)
    logits = rng.randn(200, 1).astype(np.float32) * 3
    labels = (rng.rand(200) < 0.2).astype(np.int32)   # 0 = fg, 1 = bg
    tgt = rng.rand(200).astype(np.float32)
    w = (rng.rand(200) < 0.5).astype(np.float32)
    pred, targ = (rng.randn(2, 200) * 0.3).astype(np.float32)
    cases = [
        (lambda a: sigmoid_focal_loss(a, torch.from_numpy(labels),
                                      avg_factor=17),
         lambda a: jcommon.sigmoid_focal_loss(a, labels, avg_factor=17),
         logits),
        (lambda a: binary_cross_entropy(a[:, 0], torch.from_numpy(tgt),
                                        weight=torch.from_numpy(w)),
         lambda a: jcommon.binary_cross_entropy(a[:, 0], tgt, weight=w),
         logits),
        (lambda a: binary_cross_entropy(a[:, 0], torch.from_numpy(tgt),
                                        avg_factor=9.0),
         lambda a: jcommon.binary_cross_entropy(a[:, 0], tgt,
                                                avg_factor=9.0), logits),
        (lambda a: binary_cross_entropy(a[:, 0], torch.from_numpy(tgt)),
         lambda a: jcommon.binary_cross_entropy(a[:, 0], tgt), logits),
        (lambda a: smooth_l1_loss(a, torch.from_numpy(targ),
                                  weight=torch.from_numpy(w),
                                  avg_factor=torch.tensor(w.sum())),
         lambda a: jcommon.smooth_l1_loss(a, targ, weight=w,
                                          avg_factor=w.sum()), pred),
    ]
    for port, ref, x in cases:
        t = torch.from_numpy(x).requires_grad_()
        got = port(t)
        got.backward()
        want, gwant = jax.value_and_grad(ref)(jnp.asarray(x))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(_np(t.grad), np.asarray(gwant),
                                   rtol=1e-5, atol=1e-7)


def test_rle_loss_matches_jax():
    """rle_loss with a code weight, and 0 with no visible joint."""
    rng = np.random.RandomState(3)
    P = 12
    nf, uvd, gt = (rng.randn(3, P, J, 3) * 0.5).astype(np.float32)
    sigma = (1 / (1 + np.exp(-rng.randn(P, J, 3))) + 1e-9).astype(np.float32)
    vis = np.repeat((rng.rand(P, J, 1) < 0.7).astype(np.float32), 3, -1)
    for w in (vis, np.zeros_like(vis)):
        args = (nf, uvd, sigma, gt, w)
        got = rle_loss(*[torch.from_numpy(a) for a in args], weight=2.0)
        want = jrle_loss(*[jnp.asarray(a) for a in args], weight=2.0)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_get_targets_matches_jax():
    """Labels exactly; pose and centerness targets and strides at rtol
    1e-6, with an invalid GT, two GTs at the same root center (a tie in the
    nearest root: the first wins) and GTs in every regress range."""
    rng = np.random.RandomState(4)
    B, G = 2, 6
    centers = rng.uniform(8, 88, (B, G, 2)).astype(np.float32)
    centers[:, 1] = centers[:, 0]
    spread = np.array([30, 50, 100, 200, 400, 60], np.float32)
    joints = centers[..., None, :] + rng.uniform(-1, 1, (B, G, J, 2)) \
        * spread[None, :, None, None]
    poses = np.zeros((B, G, 3 + 4 * J), np.float32)
    poses[..., :2] = centers
    poses[..., 2] = rng.uniform(1, 3, (B, G))
    poses[..., 3:3 + 3 * J] = np.concatenate(
        [joints, rng.uniform(-0.5, 0.5, (B, G, J, 1))], -1).reshape(B, G, -1)
    poses[..., 3 + 3 * J:] = (rng.rand(B, G, J) < 0.8)
    valid = np.ones((B, G), bool)
    valid[1, 3] = False
    args = (poses, centers, poses[..., 2].copy(), valid)
    want = jget_targets(FEATMAPS, HEAD['strides'], HEAD['regress_ranges'],
                        *[jnp.asarray(a) for a in args], J)
    got = get_targets(FEATMAPS, HEAD['strides'], HEAD['regress_ranges'],
                      *[torch.from_numpy(a) for a in args], J)
    np.testing.assert_array_equal(_np(got['labels']),
                                  np.asarray(want['labels']))
    assert 0 < int((_np(got['labels']) == 0).sum()) < len(got['labels'])
    for k in ('pose_targets', 'centerness_targets', 'strides'):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ train norms

def test_batchnorm_train_matches_flax():
    """Train-mode BatchNorm: output and the new running statistics against
    a flax BatchNorm applied with mutable=['batch_stats'], rtol 1e-5."""
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 6, 5, 8) * 2 + 1).astype(np.float32)     # NHWC
    g, b, rm = (rng.randn(3, 8) * 0.3).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    want, mut = bn.apply(dict(params=dict(scale=g, bias=b),
                              batch_stats=dict(mean=rm, var=rv)),
                         jnp.asarray(x), mutable=['batch_stats'])
    port = BatchNorm(8).train()
    port.load_state_dict(dict(weight=torch.from_numpy(g),
                              bias=torch.from_numpy(b),
                              running_mean=torch.from_numpy(rm),
                              running_var=torch.from_numpy(rv)))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    stats = mut['batch_stats']
    np.testing.assert_allclose(_np(port.running_mean),
                               np.asarray(stats['mean']), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(port.running_var),
                               np.asarray(stats['var']), rtol=1e-5)


# ------------------------------------------------------------ DCN grads

@pytest.mark.parametrize('mode,radius', [('shift', 1), ('shift', 2),
                                         ('clip', 1)])
def test_deform_conv_gradients_match_jax(mode, radius):
    """d(sum(out * ct))/d{x, offset, mask, weight, bias} of
    modulated_deform_conv against jax.grad, fp32, atol 1e-5 x the largest
    gradient. Offsets spread past radius 1, off the hat-weight kinks."""
    rng = np.random.RandomState(6)
    n, h, w, cin, cout = 2, 6, 7, 3, 4
    args = [rng.randn(n, h, w, cin),
            (rng.rand(n, h, w, 18) * 3.0 - 1.5) * 0.9 + 0.05,
            1 / (1 + np.exp(-rng.randn(n, h, w, 9))),
            rng.randn(3, 3, cin, cout) * 0.2, rng.randn(cout) * 0.1]
    args = [a.astype(np.float32) for a in args]
    ct = rng.randn(n, h, w, cout).astype(np.float32)
    kw = dict(gather_mode=mode, shift_radius=radius)
    want = jax.grad(lambda *a: (jdeform(*a, **kw) * ct).sum(),
                    argnums=tuple(range(5)))(*[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = modulated_deform_conv(*ts, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ts)
    for name, g, r in zip(('x', 'offset', 'mask', 'weight', 'bias'), got,
                          want):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=f'{mode} d/d{name}')


# -------------------------------------------------------- optimizer units

def test_train_pad_hw_matches_loader():
    """The train bucket of profile_train equals the JAX loader's on the
    shipped pipeline and on tests/test_loader.py's, and a pipeline with no
    resize scale raises where the loader would guess 640x1344."""
    import os

    from das_tpu.datasets.loader import train_pad_hw_from_cfg
    from das_tpu_torch.config import Config
    from das_tpu_torch.tools.profile_train import train_pad_hw
    shipped = Config.fromfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'configs', 'das', 'exp_panoptic_tpu.py')).train_pipeline
    small = [dict(type='LoadImageFromFile'),
             dict(type='ResizePose', img_scale=(500, 300), keep_ratio=True)]
    for pipe in (shipped, small):
        assert train_pad_hw(pipe) == train_pad_hw_from_cfg(pipe)
    assert train_pad_hw(shipped) == (640, 1344)
    assert train_pad_hw(small) == (320, 512)
    with pytest.raises(ValueError, match='no train bucket'):
        train_pad_hw([dict(type='LoadImageFromFile')])


def test_lr_schedule_matches_jax():
    """make_lr_fn at tests/test_train_step.py's points, rtol 1e-6, against
    the numbers and the JAX function."""
    lr = make_lr_fn(2e-3, warmup_iters=250, warmup_ratio=1 / 3,
                    step_epochs=(16, 20), steps_per_epoch=100)
    jlr = jts.make_lr_fn(2e-3, warmup_iters=250, warmup_ratio=1 / 3,
                         step_epochs=(16, 20), steps_per_epoch=100)
    expect = {0: 2e-3 / 3, 125: 2e-3 * (1 - (1 - 125 / 250) * (1 - 1 / 3)),
              1000: 2e-3, 1650: 2e-4, 2050: 2e-5}
    for t, v in expect.items():
        np.testing.assert_allclose(lr(t), v, rtol=1e-6)
        np.testing.assert_allclose(lr(t), float(jlr(jnp.asarray(t))),
                                   rtol=1e-6)


def _as_leaves(mults, params):
    """A JAX tree of per-leaf scalars as arrays of each leaf's shape, so
    that state_dict_from_flax maps their names."""
    return jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), mults, params)


@pytest.fixture(scope='module')
def trees():
    jmodel = jbuild_model(TRAIN_MODEL)
    tree = _seeded_tree(_tree_shapes(jmodel), seed=0)
    # some seeded leaves come out f64; both sides train f32 weights
    return jmodel, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree)


def test_param_groups_and_frozen_mask_match_jax(trees):
    """Per parameter, (lr_mult, wd_mult, trainable) equal the JAX per-leaf
    triple, key for key through the converter's mapping, at TINY_MODEL."""
    _, tree = trees
    params = tree['params']
    jlr, jwd = jts.param_groups(params)
    jmask = jts.frozen_mask(params, jts.mspn_frozen_prefixes(1))
    model = build_trainable_model(TRAIN_MODEL, device='cpu')
    lr, wd = param_groups(model)
    mask = frozen_mask(model, mspn_frozen_prefixes(1))
    for name, mine, ref in (('lr_mult', lr, jlr), ('wd_mult', wd, jwd),
                            ('trainable', mask, jmask)):
        ref = state_dict_from_flax(_as_leaves(ref, params))
        assert sorted(mine) == sorted(ref), name
        for k, v in ref.items():
            assert np.all(v.numpy() == mine[k]), (name, k)
    assert 0 < sum(v == 0.0 for v in mask.values()) < len(mask)
    assert {v for v in lr.values()} == {1.0, 2.0}


# ------------------------------------------------------------- whole step

def test_optimizer_updates_match_jax(trees):
    """Two optimizer updates on the same seeded gradients (the second
    carries momentum): global norm, clip, coupled decay, momentum, lr and
    the per-leaf mults and mask, against the JAX tx_update, rtol 1e-5 and
    atol 1e-6 x the leaf's largest update."""
    _, tree = trees
    params = tree['params']
    rng = np.random.RandomState(7)
    grads = [jax.tree_util.tree_map(
        lambda p: np.asarray(rng.randn(*np.shape(p)) * 3, np.float32), params)
        for _ in range(2)]
    tx_init, tx_update = jts.make_optimizer(
        params, jts.make_lr_fn(2e-3),
        frozen_prefixes=jts.mspn_frozen_prefixes(1))
    model = build_trainable_model(TRAIN_MODEL, device='cpu')
    model.load_state_dict(state_dict_from_flax(params, tree['batch_stats']))
    named = dict(model.named_parameters())
    ptx_init, ptx_update = make_optimizer(
        model, make_lr_fn(2e-3), frozen_prefixes=mspn_frozen_prefixes(1))
    jstate, pstate = tx_init(params), ptx_init(named)
    for g in grads:
        jupd, jstate, jnorm = tx_update(g, jstate, params)
        pg = state_dict_from_flax(g)
        with torch.no_grad():
            pupd, pstate, pnorm = ptx_update(pg, pstate, named)
        np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=1e-5)
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jupd))
        assert sorted(want) == sorted(pupd)
        for k, v in want.items():
            # atol: g + wd * p can cancel to near 0 in an element
            np.testing.assert_allclose(
                pupd[k].numpy(), v.numpy(), rtol=1e-5,
                atol=1e-6 * np.abs(v.numpy()).max(), err_msg=k)
    assert pstate['count'] == 2


@pytest.fixture(scope='module')
def jax_step(trees):
    """One JAX make_train_step from the seeded tree: the metrics, and the
    params, batch stats and momentum after it as the port's keys."""
    return run_jax_step(*trees)


def run_jax_step(jmodel, tree):
    """``jax_step`` for any model and tree of TRAIN_MODEL's shapes."""
    params = jax.tree_util.tree_map(jnp.asarray, tree['params'])
    stats = jax.tree_util.tree_map(jnp.asarray, tree['batch_stats'])
    tx_init, tx_update = jts.make_optimizer(
        params, jts.make_lr_fn(2e-3),
        frozen_prefixes=jts.mspn_frozen_prefixes(1))
    state = jts.TrainState(jnp.zeros((), jnp.int32), params, stats,
                           tx_init(params))
    step = jts.make_train_step(jmodel, tx_update, FEATMAPS, HEAD['strides'],
                               HEAD['regress_ranges'], J, max_pos=MAX_POS,
                               donate=False)
    state, metrics = step(state, {k: jnp.asarray(v)
                                  for k, v in _fake_batch().items()})
    host = jax.tree_util.tree_map(np.asarray, state)
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_flax(host.params, host.batch_stats),
            state_dict_from_flax(host.opt_state['momentum']))


def test_train_step_matches_jax(trees, jax_step):
    """One whole step from the same weights: every loss term (rtol 1e-4),
    grad_norm (rtol 1e-3; large, so the clip is live), each parameter's
    update -lr * lr_mult * trainable * momentum, the new batch statistics
    (rtol 1e-4), and frozen parameters unchanged on both sides.

    An update agrees within UPDATE_RTOL x max|JAX update| of its leaf. A
    leaf whose JAX update is zero to rounding (below 1e-6 of the largest
    update of all leaves: a conv bias before a norm) must be so in the port
    too, within 1e-6 of that largest. UPDATE_RTOL is 5e-3, not 1e-3: this
    random-init step is ill-conditioned (loss_pose ~2175, grad_norm ~2e5),
    and flax's norms take the one-pass variance E[x^2] - E[x]^2 where the
    port takes two passes, so loss_pose differs from JAX's by ~1e-5 of
    itself and the worst leaf (the RU reduction conv) by 2.65e-3 of its
    largest update. A fault moves a leaf by the order of the leaf. The
    parameters then agree to the update's tolerance plus one f32
    rounding."""
    step_matches_jax(TRAIN_MODEL, trees[1], jax_step)


def step_matches_jax(model_cfg, tree, jax_step, prepare=None):
    """The body of ``test_train_step_matches_jax`` for ``model_cfg`` (of
    TRAIN_MODEL's shapes) from ``tree``, against ``run_jax_step``'s
    result; ``prepare(model)``, where given, runs once the weights are
    loaded."""
    jm, jsd, jmom = jax_step
    model = build_trainable_model(model_cfg, device='cpu')
    model.load_state_dict(state_dict_from_flax(tree['params'],
                                               tree['batch_stats']),
                          strict=True)
    if prepare is not None:
        prepare(model)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    tx_init, tx_update = make_optimizer(
        model, make_lr_fn(2e-3), frozen_prefixes=mspn_frozen_prefixes(1))
    state = TrainState(0, model, tx_init(dict(model.named_parameters())))
    step = make_train_step(tx_update, FEATMAPS, HEAD['strides'],
                           HEAD['regress_ranges'], J, max_pos=MAX_POS)
    state, metrics = step(state, _fake_batch())
    assert state.step == 1 and state.opt_state['count'] == 1
    pm = {k: float(v) for k, v in metrics.items()}
    assert sorted(jm) == sorted(pm)
    assert jm['grad_norm'] > 35.0 and jm['pos_overflow'] == 0.0
    for k, v in jm.items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        np.testing.assert_allclose(pm[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    lr_mult, _ = param_groups(model)
    trainable = frozen_mask(model, mspn_frozen_prefixes(1))
    lr = make_lr_fn(2e-3)(0)
    pmom = state.opt_state['momentum']
    upd = {k: (-lr * lr_mult[k] * trainable[k] * jmom[k].numpy(),
               -lr * lr_mult[k] * trainable[k] * pmom[k].numpy())
           for k in trainable}
    top = max(np.abs(w).max() for w, _ in upd.values())
    psd = model.state_dict()
    for k, (want, got) in upd.items():
        own = np.abs(want).max()
        tol = UPDATE_RTOL * own if own >= 1e-6 * top else 1e-6 * top
        assert np.abs(got - want).max() <= tol, k
        p = jsd[k].numpy()
        assert np.all(np.abs(psd[k].numpy() - p)
                      <= tol + np.spacing(np.abs(p))), k
        if trainable[k] == 0.0:
            assert torch.equal(psd[k], first[k]), k
            assert np.array_equal(p, first[k].numpy()), k
    assert 0 < sum(v == 0.0 for v in trainable.values()) < len(trainable)
    for k in psd:
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(psd[k].numpy(), jsd[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            if k.startswith(mspn_frozen_prefixes(1)):
                assert torch.equal(psd[k], first[k]), k


def test_sparse_refine_train_equals_dense():
    """train_cfg.sparse_refine changes where the RU samples, not the
    result: the same losses and gradients with it off (fp32, rtol 1e-5)."""
    def losses_and_grads(sparse):
        cfg = dict(TRAIN_MODEL, train_cfg=dict(TRAIN_MODEL['train_cfg'],
                                               sparse_refine=sparse))
        model = build_trainable_model(cfg, device='cpu', seed=2)
        b = _fake_batch()
        targets = get_targets(FEATMAPS, HEAD['strides'],
                              HEAD['regress_ranges'],
                              *[torch.from_numpy(b[k]) for k in (
                                  'gt_poses_3d', 'gt_centers2d',
                                  'gt_depths', 'gt_valid')], J)
        losses = model.loss(torch.from_numpy(b['img']), targets, MAX_POS)
        sum(v for k, v in losses.items() if 'loss' in k).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None})
    (ls, gs), (ld, gd) = losses_and_grads(True), losses_and_grads(False)
    for k in ld:
        np.testing.assert_allclose(ls[k], ld[k], rtol=1e-5, err_msg=k)
    assert sorted(gs) == sorted(gd)
    # a conv bias before a GroupNorm has a zero gradient up to rounding
    # noise; the scale is the largest gradient of all
    scale = max(float(g.abs().max()) for g in gd.values())
    for k in gd:
        np.testing.assert_allclose(gs[k].numpy(), gd[k].numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=k)
