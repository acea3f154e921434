"""The reference's recipes in the port, held against the JAX package on the
CPU in fp32 (TF32 off), and ``remat`` held against no remat.

``configs/das/exp_mupots.py`` has a shape none of the other tiny models
has: a 3-stage MSPN2, 21 joints with the root at 14, and two recursive
update layers of which only the last one sparsifies under
``sparse_refine``; its DCNs serve by ``'patch'`` and train by ``'clip'``.
MUPOTS_MODEL is that shape at tiny widths. Its eval forward and
``decode_batch``, and one whole ``make_train_step``, equal JAX's at
tests/test_torch_model.py's and tests/test_torch_train.py's tolerances.

``remat`` (the backbone's stages, each head ``ConvModule``, each RU layer)
recomputes its regions in the backward and changes no bit: the losses,
every gradient and every BatchNorm running statistic equal the plain
step's, for MUPOTS_MODEL and for a 15-joint ``'clip'`` model with two RU
layers.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.core import decode as jdecode  # noqa: E402
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from das_tpu_torch.core.decode import decode_batch  # noqa: E402
from das_tpu_torch.core.targets import get_targets  # noqa: E402
from das_tpu_torch.models import build_model, build_trainable_model  # noqa
from das_tpu_torch.models.das_head import DASHead  # noqa: E402
from das_tpu_torch.models.layers import BatchNorm, ConvModule  # noqa: E402
from das_tpu_torch.models.mspn import SingleStageNetwork  # noqa: E402
from das_tpu_torch.models.recursive_update import \
    RecursiveUpdateLayer  # noqa: E402
from test_torch_model import _seeded_tree, _tree_shapes  # noqa: E402
from test_torch_train import (FEATMAPS, HEAD, MAX_POS,  # noqa: E402
                              TRAIN_MODEL, _fake_batch, run_jax_step,
                              step_matches_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

J = 21
STRIDES = (8, 16, 32, 64)
TEST_CFG = dict(nms_pre=50, nms_post=10, nms_thr=0.9, score_thr=0.05,
                sparse_refine=True)
# exp_mupots.py at tiny widths: 3 stages, J=21 with root 14, depth_factor
# 1, two RU layers, the 'patch' DCN (train: 'clip'), sparse_refine on both
# paths
MUPOTS_MODEL = copy.deepcopy(TRAIN_MODEL)
MUPOTS_MODEL['backbone'].update(num_stages=3)
MUPOTS_MODEL['bbox_head'].update(num_joints=J, root_idx=14, depth_factor=1)
MUPOTS_MODEL['bbox_head']['recursive_update'].update(num_joints=J,
                                                     num_layers=2)
MUPOTS_MODEL['train_cfg'] = dict(code_weight=[1.0, 1.0, 1] + [2] * J * 6,
                                 sparse_refine=True)
MUPOTS_MODEL['test_cfg'] = TEST_CFG
# exp_panoptic's joints on the 'clip' training path, two RU layers
CLIP15_MODEL = copy.deepcopy(TRAIN_MODEL)
CLIP15_MODEL['backbone'].update(num_stages=2)
CLIP15_MODEL['bbox_head'].update(num_joints=15)
CLIP15_MODEL['bbox_head']['recursive_update'].update(num_joints=15,
                                                     num_layers=2)
CLIP15_MODEL['train_cfg'] = dict(code_weight=[1.0, 1.0, 1] + [2] * 15 * 6,
                                 sparse_refine=True)
HW = (64, 96)
TRAIN_HW = (128, 192)


@pytest.fixture(scope='module')
def mupots():
    """MUPOTS_MODEL's JAX model and its variable tree's shapes."""
    jmodel = jbuild_model(MUPOTS_MODEL)
    return jmodel, _tree_shapes(jmodel)


def _f32_tree(shapes, offset_std):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        _seeded_tree(shapes, seed=0, offset_std=offset_std))


def test_mupots_head_outputs_and_decode_match_jax(mupots):
    """Eval forward and decode_batch of the exp_mupots shape, at
    test_head_outputs_and_decode_match_jax's tolerances: head outputs rtol
    1e-4 and atol 1e-4 x the level's max |value|; the same valid set,
    scores within 1e-5, poses and centers within 1e-3 px plus rtol 1e-4:
    the head outputs' own relative tolerance, which the poses carry (three
    stages put 4 of 1260 pose values 1.25e-3 px, 3.4e-5 of their 185 px,
    from JAX's). The decode alone, on JAX's head outputs, is held within
    1e-4 px. The head's select_idx goes to the last RU layer only: the first
    stays dense. The conv_offset kernels move the 'patch' taps off the
    grid."""
    jmodel, shapes = mupots
    tree = _f32_tree(shapes, offset_std=0.8)
    model = build_model(MUPOTS_MODEL, device='cpu')
    model.load_state_dict(state_dict_from_flax(tree['params'],
                                               tree['batch_stats']),
                          strict=True)
    ru = model.bbox_head.recursive_update_branch
    seen = []
    hooks = [getattr(ru, f'layer_{i}').register_forward_pre_hook(
        lambda m, a, i=i: seen.append((i, a[2] is not None)))
        for i in range(2)]
    img = np.random.RandomState(1).randn(2, *HW, 3).astype(np.float32)
    with torch.no_grad():
        outs = model(torch.from_numpy(img))
    for h in hooks:
        h.remove()
    # levels 0-1 (384, 96 points) exceed nms_pre=50: the last layer sparse
    assert seen == [(0, False), (1, True)] * 2 + [(0, False), (1, False)] * 2
    jouts = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(img))
    for name, got_l, want_l in zip(('cls', 'pose', 'ctr', 'ref_uvd'), outs,
                                   jouts):
        for lvl, (got, want) in enumerate(zip(got_l, want_l)):
            want = np.asarray(want)
            assert got.shape == want.shape, (name, lvl)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=f'{name} level {lvl}')
    sf = np.array([[1.0, 1.0], [0.8, 1.25]], np.float32)
    want = jdecode.decode_batch(*[list(o) for o in jouts[:3]], STRIDES,
                                jnp.asarray(sf), J, TEST_CFG)
    got = decode_batch(*outs[:3], STRIDES, torch.from_numpy(sf), J,
                       TEST_CFG)
    valid = np.asarray(want['valid'])
    assert valid.any()
    assert got['poses'].shape[-2] == J
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), atol=1e-5)
    for k in ('poses', 'centers'):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=1e-4,
                                   atol=1e-3)
    same = decode_batch(*[[torch.from_numpy(np.array(a)) for a in o]
                          for o in jouts[:3]], STRIDES, torch.from_numpy(sf),
                        J, TEST_CFG)
    np.testing.assert_array_equal(same['valid'].numpy(), valid)
    np.testing.assert_allclose(same['scores'].numpy(),
                               np.asarray(want['scores']), atol=1e-6)
    np.testing.assert_allclose(same['poses'].numpy(),
                               np.asarray(want['poses']), atol=1e-4)


def test_mupots_train_step_matches_jax(mupots):
    """One make_train_step of the exp_mupots shape ('clip' DCNs, two RU
    layers, J=21) from the same weights on the same batch, at
    test_train_step_matches_jax's tolerances: losses rtol 1e-4, grad_norm
    rtol 1e-3, frozen parameters unchanged; each update within UPDATE_RTOL
    of its leaf's largest and each batch statistic within rtol 1e-4 and
    atol 1e-6 or, where a leaf is more sensitive, within ULP_FACTOR (10)
    times what one ulp moves it (the difference between two JAX steps whose
    weights differ by one ulp), an update also within ULP_FLOOR (1e-5) of
    the largest update of all leaves (``step_matches_jax``). The weights
    are made as test_train_step_matches_jax makes them (zero conv_offset
    kernels).

    The images are 128x192, not that test's 64x96: with three stages of
    train-mode BatchNorm over B=2, the deepest maps (2x3 at 64x96) give a
    step that rounding moves more than that test's tolerances allow. A
    weight change of one ulp moves the port's grad_norm by 4.6e-4 of itself
    at 64x96 (the port against JAX: 3.5e-3) and by 6.7e-5 at 128x192, where
    the losses and grad_norm meet that test's tolerances. Stage 0's
    layer2, behind all three stages, keeps updates up to 1.02e-2 of their
    leaf's largest away from JAX's (flax's norms take the one-pass
    variance, the port two passes), where one ulp moves them by 0.6e-2 to
    1.65e-2; the last RU layer's sampling_conf bias, whose terms cancel,
    3.2e-2 of its largest, 2e-6 of the largest of all; stage 2's last
    BatchNorm (48 values a channel) has a running mean 1.1e-6 off. A fault
    moves a leaf by the order of the leaf."""
    jmodel, shapes = mupots
    tree = _f32_tree(shapes, offset_std=0.0)
    ref, ulp = run_jax_step(jmodel, tree, J, TRAIN_HW, ulp=True)
    step_matches_jax(MUPOTS_MODEL, tree, ref, joints=J, hw=TRAIN_HW,
                     ulp_step=ulp)


def _remat(cfg, on):
    cfg = copy.deepcopy(cfg)
    cfg['backbone']['remat'] = on
    cfg['bbox_head']['remat'] = on           # the RU's default too
    return cfg


REGIONS = (SingleStageNetwork, ConvModule, RecursiveUpdateLayer)


def _loss_step(cfg, seed=2):
    """Losses, gradients, state after one forward and backward of
    ``model.loss`` on _fake_batch; the calls of each kind of remat region
    (SingleStageNetwork, head ConvModule, RU layer) and the bytes autograd
    saved outside the regions."""
    joints = cfg['bbox_head']['num_joints']
    model = build_trainable_model(cfg, device='cpu', seed=seed)
    b = _fake_batch(J=joints)
    targets = get_targets(FEATMAPS, HEAD['strides'], HEAD['regress_ranges'],
                          *[torch.from_numpy(b[k]) for k in (
                              'gt_poses_3d', 'gt_centers2d', 'gt_depths',
                              'gt_valid')], joints)
    head_convs = {id(m) for n, m in model.bbox_head.named_modules()
                  if isinstance(m, ConvModule)
                  and not n.startswith('recursive_update_branch')}
    calls = {c.__name__: 0 for c in REGIONS}
    # the regions' bodies (a ConvModule's remat region is its _forward)
    bodies = [(SingleStageNetwork, 'forward'), (ConvModule, '_forward'),
              (RecursiveUpdateLayer, 'forward')]
    originals = [getattr(c, f) for c, f in bodies]

    def counted(cls, fn):
        def body(self, *a):
            if cls is not ConvModule or id(self) in head_convs:
                calls[cls.__name__] += 1
            return fn(self, *a)
        return body
    for (cls, f), fn in zip(bodies, originals):
        setattr(cls, f, counted(cls, fn))
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            losses = model.loss(torch.from_numpy(b['img']), targets,
                                MAX_POS)
        sum(v for k, v in losses.items() if 'loss' in k).backward()
    finally:
        for (cls, f), fn in zip(bodies, originals):
            setattr(cls, f, fn)
    return (losses, {k: p.grad for k, p in model.named_parameters()
                     if p.grad is not None}, model.state_dict(), calls,
            saved[0], len(head_convs))


@pytest.mark.parametrize('name', ['mupots', 'clip15'])
def test_remat_step_is_bit_equal_and_recomputes(name):
    """remat=True in backbone, head and RU against remat=False, same
    weights, same batch: every loss term, every gradient and every state
    tensor (BatchNorm running statistics included: the recompute must not
    update them a second time) equal bit for bit. With remat every region
    runs twice (forward and recompute) and autograd keeps under half the
    activation bytes outside them; without it each runs once."""
    cfg = dict(mupots=MUPOTS_MODEL, clip15=CLIP15_MODEL)[name]
    plain = _loss_step(_remat(cfg, False))
    rem = _loss_step(_remat(cfg, True))
    for got, want in zip(rem[:3], plain[:3]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # the running statistics moved (from their init, var 1), so their
    # equality shows one update each
    assert any(not torch.equal(v, torch.ones_like(v))
               for k, v in plain[2].items() if k.endswith('running_var'))
    stages = cfg['backbone']['num_stages']
    layers = cfg['bbox_head']['recursive_update']['num_layers']
    levels, convs = len(STRIDES), plain[5]
    assert plain[3] == dict(SingleStageNetwork=stages,
                            ConvModule=convs * levels,
                            RecursiveUpdateLayer=layers * levels)
    assert rem[3] == {k: 2 * v for k, v in plain[3].items()}
    assert rem[4] < 0.5 * plain[4], (rem[4], plain[4])


def test_remat_recompute_leaves_running_stats_alone():
    """A recompute (``BatchNorm.recomputing``) normalises with the batch's
    moments as the forward does and leaves the running statistics as they
    are; the plain train-mode call takes one 0.9/0.1 update."""
    bn = BatchNorm(4).train()
    x = torch.randn(2, 4, 3, 5)
    y = bn(x)
    once = bn.running_mean.clone(), bn.running_var.clone()
    bn.recomputing = True
    assert torch.equal(bn(x), y)
    assert torch.equal(bn.running_mean, once[0])
    assert torch.equal(bn.running_var, once[1])
    bn.recomputing = False
    bn(x)
    assert not torch.equal(bn.running_mean, once[0])


def test_head_passes_remat_to_its_convs_and_ru():
    """DASHead(remat=True) sets it on every tower and branch ConvModule and,
    as JAX's ru.setdefault('remat', ...), on the RU; an RU config's own
    remat wins."""
    head_cfg = {k: v for k, v in MUPOTS_MODEL['bbox_head'].items()
                if k != 'type'}
    head = DASHead(**head_cfg, remat=True)
    convs = [m for n, m in head.named_modules() if isinstance(m, ConvModule)
             and not n.startswith('recursive_update_branch')]
    assert convs and all(m.remat for m in convs)
    assert head.recursive_update_branch.remat
    ru = dict(head_cfg['recursive_update'], remat=False)
    head = DASHead(**dict(head_cfg, recursive_update=ru), remat=True)
    assert not head.recursive_update_branch.remat
