"""Parity of the port's serving path (das_tpu_torch) with the JAX package.

A TINY_MODEL-sized config (tests/test_model.py:19-39) in the serving
modes — ``dcn_gather_mode='hybrid_pallas'``, ``dcn_shift_radius=1``,
``test_cfg.sparse_refine=True`` — gets one set of weights made from a seed
with numpy. They go into the JAX model as its variable tree and into the
port through ``state_dict_from_flax``; the same images then go through
both, in fp32 on the CPU (TF32 off). The JAX side runs the Pallas DCN
kernel in interpret mode, as ``das_tpu/ops/deform_conv.py`` does off the
TPU. Seeded conv_offset kernels push some offsets out of radius 1, so the
exact repair runs. The JAX variable tree comes from ``jax.eval_shape`` of
``init_all`` (no eager init), and the model is built once per module.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.checkpoint.torch_bridge import export_torch_state_dict  # noqa
from das_tpu.config import Config as JConfig  # noqa: E402
from das_tpu.core import decode as jdecode  # noqa: E402
from das_tpu.core.targets import make_points as jmake_points  # noqa: E402
from das_tpu.models import build_model as jbuild_model  # noqa: E402
from das_tpu.models.real_nvp import RealNVP as JRealNVP  # noqa: E402
from das_tpu_torch.apis import (init_model, make_predict_fn,  # noqa: E402
                                results_to_host)
from das_tpu_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                      state_dict_from_flax)
from das_tpu_torch.config import Config  # noqa: E402
from das_tpu_torch.core.decode import (decode_batch,  # noqa: E402
                                       decode_single_image)
from das_tpu_torch.core.targets import make_points  # noqa: E402
from das_tpu_torch.models import build_model  # noqa: E402
from das_tpu_torch.models.layers import DeformConv2d  # noqa: E402
from das_tpu_torch.models.real_nvp import RealNVP  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_CFG = os.path.join(ROOT, 'configs/das/exp_panoptic_tpu.py')
J = 4
STRIDES = (8, 16, 32, 64)
TEST_CFG = dict(nms_pre=50, nms_post=10, nms_thr=0.9, score_thr=0.05,
                sparse_refine=True)
TINY_MODEL = dict(
    type='DAS',
    backbone=dict(
        type='MSPN2', unit_channels=32, num_stages=1, num_units=4,
        num_blocks=[1, 1, 1, 1], norm_cfg=dict(type='BN'),
        res_top_channels=8, frozen_stages=1),
    neck=dict(type='FPN', in_channels=[32, 32, 32, 32], out_channels=32,
              norm_cfg=dict(type='BN'), num_outs=4),
    bbox_head=dict(
        type='DASHead', num_classes=1, in_channels=32, stacked_convs=2,
        feat_channels=32, strides=list(STRIDES),
        regress_ranges=((-1, 80), (80, 160), (160, 320), (320, 1e8)),
        num_joints=J, depth_factor=20, z_norm=50, root_idx=2,
        cls_branch=(32,), reg_branch=((32,), (32,), (32,), (32,)),
        centerness_branch=(32,), conv_bias=True, dcn_on_last_conv=True,
        dcn_gather_mode='hybrid_pallas', dcn_shift_radius=1,
        recursive_update=dict(prev_loss=True, num_heads=2, in_channels=32,
                              feat_channels=32, num_layers=1, dim=3,
                              num_joints=J)),
    train_cfg=dict(code_weight=[1.0, 1.0, 1] + [2] * J * 6),
    test_cfg=TEST_CFG,
)
HW = (64, 96)


def _tree_shapes(jmodel):
    shapes = jax.eval_shape(lambda: jmodel.init_all(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    return {c: jax.tree_util.tree_map(lambda s: tuple(s.shape), dict(t))
            for c, t in dict(shapes).items()}


def _seeded_tree(shapes, seed, offset_std=0.0):
    """Numpy weights for every leaf: LeCun-normal kernels, small biases,
    norms near identity; conv_offset kernels at ``offset_std``/sqrt(fan_in)
    and the cls bias at 0, so that some offsets leave radius 1 and some
    poses pass the score threshold."""
    rng = np.random.RandomState(seed)

    def leaf(path, shape):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        last = name.rsplit('/', 1)[-1]
        if last == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            std = (offset_std if 'conv_offset' in name else 1.0)
            return rng.randn(*shape).astype(np.float32) * std / \
                np.sqrt(fan_in)
        if last == 'var':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if last == 'scale':
            return (1.0 + 0.1 * np.asarray(rng.randn(*shape))) \
                .astype(np.float32)
        if 'conv_cls' in name:
            return np.zeros(shape, np.float32)
        return (0.1 * np.asarray(rng.randn(*shape))).astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(
        leaf, t, is_leaf=lambda s: isinstance(s, tuple))
        for c, t in shapes.items()}


def _img(seed, B=2, hw=HW):
    return np.random.RandomState(seed).randn(B, *hw, 3).astype(np.float32)


@pytest.fixture(scope='module')
def tiny():
    """The JAX tiny model + its jitted forward, and the port model holding
    the same seeded weights."""
    jmodel = jbuild_model(TINY_MODEL)
    tree = _seeded_tree(_tree_shapes(jmodel), seed=0, offset_std=0.8)
    jvars = {c: jax.tree_util.tree_map(jnp.asarray, t)
             for c, t in tree.items()}
    jfwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    model = build_model(TINY_MODEL, device='cpu')
    model.load_state_dict(
        state_dict_from_flax(tree['params'], tree['batch_stats']),
        strict=True)
    return jfwd, jvars, model


def _flagged_offsets(model, img):
    """Per DCN call, the count of pixels with a tap beyond radius 1."""
    counts = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda mod, inp, out: counts.append(
            int((out[:, :18].abs() > 1).any(1).sum())))
        for m in model.modules() if isinstance(m, DeformConv2d)]
    with torch.no_grad():
        outs = model(torch.from_numpy(img))
    for h in hooks:
        h.remove()
    return counts, outs


def test_head_outputs_and_decode_match_jax(tiny):
    """The whole tiny slice: per-level head outputs and decode_batch.

    Head outputs: rtol 1e-4 and atol 1e-4 x the level's max |value| (fp32;
    flax GroupNorm takes the fast E[x^2]-E[x]^2 variance, torch two passes,
    and the DCN sums in another order). Decode: the same valid set and,
    entry by entry, scores within 1e-5 and poses within 1e-3 px."""
    jfwd, jvars, model = tiny
    img = _img(1)
    counts, outs = _flagged_offsets(model, img)
    assert len(counts) == 16                 # 4 DCN convs x 4 levels
    assert sum(counts) > 0, 'no offset left radius 1: the repair never ran'
    assert sum(c == 0 for c in counts) < 16
    jouts = jfwd(jvars, jnp.asarray(img))
    names = ('cls', 'pose', 'ctr', 'ref_uvd')
    for name, got_l, want_l in zip(names, outs, jouts):
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
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), atol=1e-5)
    for k in ('poses', 'centers'):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], atol=1e-3)
    np.testing.assert_array_equal(got['vis'].numpy(), np.asarray(want['vis']))


def test_decode_matches_jax_on_same_head_outputs(tiny):
    """decode_batch on identical inputs (the JAX head's outputs), hard and
    soft NMS: the same picks, scores within 1e-6, poses within 1e-4."""
    jfwd, jvars, _ = tiny
    jouts = jfwd(jvars, jnp.asarray(_img(2)))
    sf = np.array([[1.0, 1.0], [1.5, 0.5]], np.float32)
    for nms_type in ('hard', 'soft'):
        cfg = dict(TEST_CFG, nms_type=nms_type, nms_thr=0.5)
        want = jax.jit(lambda c, p, t, s: jdecode.decode_batch(
            c, p, t, STRIDES, s, J, cfg))(*[list(o) for o in jouts[:3]],
                                          jnp.asarray(sf))
        got = decode_batch(*[[torch.from_numpy(np.array(a)) for a in o]
                             for o in jouts[:3]], STRIDES,
                           torch.from_numpy(sf), J, cfg)
        np.testing.assert_array_equal(got['valid'].numpy(),
                                      np.asarray(want['valid']))
        np.testing.assert_allclose(got['scores'].numpy(),
                                   np.asarray(want['scores']), atol=1e-6)
        np.testing.assert_allclose(got['poses'].numpy(),
                                   np.asarray(want['poses']), atol=1e-4)


def test_decode_single_image_matches_jax(tiny):
    """decode_single_image on one image's head outputs (the JAX head's),
    with a test scale: the same valid set, scores within 1e-6, poses and
    centers within 1e-4."""
    jfwd, jvars, _ = tiny
    jouts = jfwd(jvars, jnp.asarray(_img(4, B=1)))
    sizes = [tuple(c.shape[1:3]) for c in jouts[0]]
    pts, _, _ = jmake_points(sizes, STRIDES)
    points, begin = [], 0
    for h, w in sizes:
        points.append(pts[begin:begin + h * w])
        begin += h * w
    sf = np.array([1.25, 0.8], np.float32)
    kw = dict(nms_pre=TEST_CFG['nms_pre'], nms_post=TEST_CFG['nms_post'],
              nms_thr=0.5, score_thr=TEST_CFG['score_thr'])
    levels = [[np.array(a[0]) for a in o] for o in jouts[:3]]
    want = jdecode.decode_single_image(
        *[[jnp.asarray(a) for a in lv] for lv in levels],
        [jnp.asarray(p) for p in points], jnp.asarray(sf), J, **kw)
    got = decode_single_image(
        *[[torch.from_numpy(a) for a in lv] for lv in levels],
        [torch.from_numpy(p) for p in points], torch.from_numpy(sf), J, **kw)
    valid = np.asarray(want['valid'])
    assert valid.any()
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), atol=1e-6)
    for k in ('poses', 'centers'):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], atol=1e-4)


def test_predict_fn_and_results_to_host(tiny):
    """make_predict_fn(device='cpu') == model + decode_batch, and
    results_to_host keeps exactly the valid entries."""
    _, _, model = tiny
    img = _img(3)
    sf = np.ones((2, 2), np.float32)
    predict = make_predict_fn(model, TEST_CFG, J, STRIDES, device='cpu')
    got = predict(img, sf)
    with torch.no_grad():
        outs = model(torch.from_numpy(img))
    want = decode_batch(*outs[:3], STRIDES, torch.from_numpy(sf), J,
                        TEST_CFG)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    res = results_to_host(got, ['a.jpg', 'b.jpg'])
    for i, r in enumerate(res):
        n = int(got['valid'][i].sum())
        assert r['poses'].shape == (n, J, 3) and len(r['scores']) == n
        assert r['image_paths'] == [['a.jpg', 'b.jpg'][i]]


def test_make_points_matches_jax():
    """make_points, stride quirk included: maps at strides 4..32 carry the
    head's strides 8..64."""
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    for got, want in zip(make_points(sizes, STRIDES),
                         jmake_points(sizes, STRIDES)):
        np.testing.assert_array_equal(got, want)


def test_real_nvp_log_prob_matches_jax():
    """RealNVP log_prob (loss-only, kept for a whole state dict), dims 3
    and 2, rtol 1e-5 and atol 1e-5 (fp32; log_probs reach ~1e2)."""
    rng = np.random.RandomState(4)
    for dim in (3, 2):
        jflow = JRealNVP(dim=dim)
        x = rng.randn(32, dim).astype(np.float32)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a))
            .astype(np.float32),
            jflow.init(jax.random.PRNGKey(dim), jnp.asarray(x))['params'])
        want = jflow.apply({'params': params}, jnp.asarray(x))
        prefix = f'bbox_head.flow{dim}d.'
        sd = state_dict_from_flax({'bbox_head': {f'flow{dim}d': params}})
        flow = RealNVP(dim)
        flow.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                             strict=True)
        with torch.no_grad():
            got = flow(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_state_dict_from_flax_equals_bridge_export_and_loads_strict():
    """At the full width of exp_panoptic_tpu: the port's conversion gives
    export_torch_state_dict's keys and arrays exactly, and the result loads
    into the port's model with strict=True."""
    jmodel = jbuild_model(dict(JConfig.fromfile(SERVING_CFG).model))
    tree = _seeded_tree(_tree_shapes(jmodel), seed=5)
    want = export_torch_state_dict(tree)
    got = state_dict_from_flax(tree['params'], tree['batch_stats'])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model, _ = init_model(SERVING_CFG, device='cpu')
    model.load_state_dict(got, strict=True)
    sd = model.state_dict()
    assert sorted(sd) == sorted(want)
    k = 'bbox_head.cls_convs.1.conv.conv_offset.weight'
    np.testing.assert_array_equal(sd[k].numpy(), want[k])


def test_load_checkpoint_and_dcn_validation_fallback(tmp_path):
    """A reference-style .pth ('module.' prefixes, num_batches_tracked,
    RealNVP masks) loads strictly; offsets far beyond the radius make
    init_model switch every DCN layer to the exact 'patch' gather."""
    cfg = Config(dict(model=TINY_MODEL))
    model = build_model(TINY_MODEL, device='cpu', seed=3)
    # 'module.backbone.' is stripped to '' (MSPN checkpoints), so only the
    # head and neck keys carry the DDP prefix here
    sd = {('' if k.startswith('backbone.') else 'module.') + k: v
          for k, v in model.state_dict().items()}
    sd['backbone.top.top.0.bn.num_batches_tracked'] = torch.tensor(7)
    sd['module.bbox_head.flow3d.mask'] = model.bbox_head.flow3d.mask
    for k in sd:
        if k.endswith('conv_offset.bias'):
            sd[k] = torch.full_like(sd[k], 5.0)
    path = str(tmp_path / 'ckpt.pth')
    torch.save(dict(state_dict=sd, meta={}), path)

    loaded = load_checkpoint(build_model(TINY_MODEL, device='cpu'), path)
    for k, v in loaded.state_dict().items():
        want = sd[k] if k.startswith('backbone.') else sd['module.' + k]
        assert torch.equal(v, want), k

    served, cfg2 = init_model(cfg, checkpoint=path, device='cpu')
    modes = {m.gather_mode for m in served.modules()
             if isinstance(m, DeformConv2d)}
    assert modes == {'patch'}
    assert cfg2.model['bbox_head']['dcn_gather_mode'] == 'patch'


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no card and no device named, every entry point raises; none
    runs on the CPU on its own."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device'):
        build_model(TINY_MODEL)
    with pytest.raises(RuntimeError, match='device'):
        init_model(Config(dict(model=TINY_MODEL)))
    model = build_model(TINY_MODEL, device='cpu')
    with pytest.raises(RuntimeError, match='device'):
        make_predict_fn(model, TEST_CFG, J, STRIDES)


# modules the walk must find (the host runtime, the tools and helpers)
REQUIRED_MODULES = [
    'datasets.native', 'core.visualize', 'utils.profiling',
    'utils.collect_env', 'mytools.vis_3d', 'tools.demo',
    'tools.validate_hybrid', 'tools.print_config', 'tools.fuse_conv_bn',
    'tools.browse_dataset', 'tools.visualize_results', 'tools.export_torch',
    'tools.publish_model']


def test_port_imports_no_jax():
    """Importing every das_tpu_torch module (REQUIRED_MODULES among them)
    leaves jax, flax and das_tpu out of sys.modules (a subprocess: this one
    has jax via conftest)."""
    code = '\n'.join([
        'import importlib, pkgutil, sys',
        'import das_tpu_torch',
        'names = [m.name for m in pkgutil.walk_packages(',
        "    das_tpu_torch.__path__, 'das_tpu_torch.')]",
        'for n in names:',
        '    importlib.import_module(n)',
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'flax', 'das_tpu'))",
        f'missing = sorted(set({REQUIRED_MODULES!r}) - {{',
        "    n[len('das_tpu_torch.'):] for n in names})",
        "print(len(names), 'modules;', 'bad:', bad, 'missing:', missing)",
        'sys.exit(1 if bad or missing or len(names) < 15 else 0)'])
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
