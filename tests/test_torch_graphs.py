"""CUDA graphs over the head's eval forward (``models/graphs.py``).

On the CPU: the gate sends training, grad, CPU tensors, a hook inside a
region (a DCN's ``conv_offset``, a module inside the recursive update), a
global hook and a ``'hybrid*'`` lowering to the eager path, and the
counters show it; a hook on the RU module itself is no reason. The cache's
bookkeeping (first call eager, second captured, later replayed; keys;
the cap; a moved parameter; a profiler; fresh outputs) runs with a
stand-in for the captured graph. The per-level ``uvd_scale`` buffer gives
the bits of the product it replaced and stays out of the state dict.

Tests marked ``cuda`` need a card (they skip without one): on
exp_panoptic at a small bucket, graphed outputs equal the eager ones bit
for bit, two inputs replayed in turn each give their own, outputs
returned earlier outlive the next replay, a hook registered after capture
runs eagerly and sees its call, ``load_state_dict`` and a rebound
parameter are seen, and a replayed call counts the launches an eager one
does; K1's and K2's kernels under capture likewise. On the card:

    python -m pytest --noconftest tests/test_torch_graphs.py -q
"""

import contextlib
import copy
import os
import pickle

import pytest
import torch

from das_tpu_torch.config import Config
from das_tpu_torch.models import graphs
from das_tpu_torch.models.das_head import DASHead
from das_tpu_torch.ops import conv_gn, dcn_shift, gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = 4
TEST_CFG = dict(nms_pre=40, nms_post=10, nms_thr=0.9, score_thr=0.05,
                sparse_refine=True)
LEVEL_HW = ((16, 24), (8, 12), (4, 6), (2, 3))
RU_DCN = 'recursive_update_branch.layer_0.next_level_offset.' \
    'update_feat_conv.conv'


def tiny_head(**kw) -> DASHead:
    cfg = dict(num_classes=1, in_channels=32, stacked_convs=2,
               feat_channels=32, strides=(8, 16, 32, 64), num_joints=J,
               depth_factor=20, z_norm=50, root_idx=2, cls_branch=(32,),
               reg_branch=((32,), (32,), (32,), (32,)),
               centerness_branch=(32,), conv_bias=True,
               recursive_update=dict(prev_loss=True, num_heads=2,
                                     in_channels=32, feat_channels=32,
                                     num_layers=1, dim=3),
               test_cfg=TEST_CFG)
    cfg.update(kw)
    head = DASHead(**cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return head.eval()


def feats(seed=1, batch=2, device='cpu', dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(batch, 32, h, w, generator=gen).to(device, dtype)
            for h, w in LEVEL_HW]


def counts():
    return {k: (graphs.captures[k], graphs.replays[k], graphs.eager[k])
            for k in ('trunk', 'ru')}


def moved(before):
    now = counts()
    return {k: tuple(b - a for a, b in zip(before[k], now[k]))
            for k in now}


def why(head, lvl=0):
    """The gate's reasons for the trunk and the RU body at ``lvl``."""
    x = feats()[lvl]
    ru = head.recursive_update_branch
    return (graphs.gate(head, head._trunk_modules, (x, lvl, 0))[0],
            graphs.gate(ru, ru._body_modules, (x, x, None))[0])


@contextlib.contextmanager
def global_hook():
    h = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: None)
    try:
        yield
    finally:
        h.remove()


def _hook(head, name, calls):
    return head.get_submodule(name).register_forward_hook(
        lambda m, i, o: calls.append(name))


# each case: how the call is made, and the gate's reasons (trunk, RU)
CASES = {
    'training': ('train', ('training', 'training')),
    'grad': ('grad', ('grad', 'grad')),
    'cpu': ('none', ('device', 'device')),
    'hook_conv_offset': ('cls_convs.1.conv.conv_offset', ('hook', 'device')),
    'hook_ru_inside': (RU_DCN + '.conv_offset', ('device', 'hook')),
    'hook_ru_itself': ('recursive_update_branch', ('device', 'device')),
    'global_hook': ('global', ('hook', 'hook')),
    'hybrid': ('hybrid', ('host sync', 'host sync')),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_gate_sends_the_call_to_the_eager_path(case):
    how, reasons = CASES[case]
    head = tiny_head(dcn_gather_mode='hybrid' if how == 'hybrid'
                     else 'patch')
    calls = []
    if '.' in how or how == 'recursive_update_branch':
        _hook(head, how, calls)
    if how == 'train':
        head.train()
    ctx = global_hook() if how == 'global' else contextlib.nullcontext()
    grad = torch.enable_grad() if how in ('grad', 'train') \
        else torch.inference_mode()
    with ctx, grad:
        assert why(head) == reasons
        before = counts()
        for _ in range(3):
            head(feats())
        assert moved(before) == {'trunk': (0, 0, 12), 'ru': (0, 0, 12)}
    if how.endswith('conv_offset'):
        assert len(calls) == 12
    elif how == 'recursive_update_branch':
        assert len(calls) == 12


def test_eval_forward_unchanged_by_the_gate():
    """The eager path (every call on the CPU) equals the same module's
    forward with the gate bypassed by a global hook, bit for bit."""
    head = tiny_head()
    with torch.inference_mode():
        a = head(feats())
        with global_hook():
            b = head(feats())
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)


@pytest.mark.parametrize('lvl', range(4))
def test_uvd_scale_buffer_gives_the_old_product(lvl):
    head = tiny_head()
    stride = head.strides[lvl]
    old = torch.tensor([stride, stride, head.z_norm], dtype=torch.float32)
    assert head.uvd_scale[lvl].dtype == torch.float32
    assert torch.equal(head.uvd_scale[lvl], old)
    ref = torch.randn(2, 5, 7, J, 3, generator=torch.Generator()
                      .manual_seed(lvl)) * 30
    a, b = ref * old, ref * head.uvd_scale[lvl]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_uvd_scale_stays_out_of_the_state_dict():
    head = tiny_head()
    sd = head.state_dict()
    assert not any('uvd_scale' in k for k in sd)
    other = tiny_head()
    other.load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError, match='Unexpected key'):
        other.load_state_dict({**sd, 'uvd_scale': head.uvd_scale},
                              strict=True)
    with pytest.raises(RuntimeError, match='Missing key'):
        other.load_state_dict({k: v for k, v in sd.items()
                               if k != 'conv_cls.bias'}, strict=True)


def test_a_copy_or_pickle_starts_with_no_graphs():
    head = tiny_head()
    head._graphs.seen.add('k')
    for other in (copy.deepcopy(head), pickle.loads(pickle.dumps(head))):
        assert other._graphs is not head._graphs
        assert other._graphs.kind == 'trunk' and not other._graphs.seen
        assert not other.recursive_update_branch._graphs.entries


class FakeEntry:
    """A stand-in for ``graphs._Entry`` on the CPU: the region's outputs
    in static tensors, rewritten at each replay."""

    def __init__(self, fn, args, pool):
        self.fn, self.first, self.out = fn, fn(*args), fn(*args)
        self.graph = self

    def pool(self):
        return 'pool'

    def replay(self, args):
        for s, o in zip(self.out, self.fn(*args)):
            s.copy_(o)


@pytest.fixture
def fake_graphs(monkeypatch):
    state = dict(state=(1,))
    monkeypatch.setattr(graphs, 'gate',
                        lambda owner, mods, args: (None, state['state']))
    monkeypatch.setattr(graphs, '_Entry', FakeEntry)
    return state


def region(x, k):
    return (x * k, x + k)


def calls(g, *xs, k=2.0, fresh=()):
    owner = torch.nn.Identity().eval()
    return [g.run(region, (x, k), owner, [], fresh=fresh) for x in xs]


@pytest.mark.parametrize('step', ['first', 'second', 'third'])
def test_first_call_eager_second_captures_then_replays(fake_graphs, step):
    g = graphs.Graphs('test')
    n = dict(first=1, second=2, third=3)[step]
    before = (graphs.captures['test'], graphs.replays['test'],
              graphs.eager['test'])
    outs = calls(g, *[torch.full((3,), float(i)) for i in range(n)])
    got = (graphs.captures['test'] - before[0],
           graphs.replays['test'] - before[1],
           graphs.eager['test'] - before[2])
    assert got == {1: (0, 0, 1), 2: (1, 0, 1), 3: (1, 1, 1)}[n]
    assert torch.equal(outs[-1][0], torch.full((3,), 2.0 * (n - 1)))


@pytest.mark.parametrize('change', ['shape', 'dtype', 'value', 'inference'])
def test_key_tells_calls_apart(fake_graphs, change):
    g = graphs.Graphs('test')
    x = torch.ones(3)
    other = dict(shape=(torch.ones(4), 2.0), dtype=(x.double(), 2.0),
                 value=(x, 3.0), inference=(x, 2.0))[change]
    calls(g, x, x)
    assert len(g.entries) == 1
    ctx = torch.inference_mode() if change == 'inference' \
        else contextlib.nullcontext()
    with ctx:
        g.run(region, other, torch.nn.Identity().eval(), [])
    assert len(g.entries) == 1 and len(g.seen) == 2


def test_cap_keeps_further_keys_eager(fake_graphs, monkeypatch):
    monkeypatch.setattr(graphs, 'LIMIT', 2)
    g = graphs.Graphs('test')
    for n in (1, 2, 3):
        calls(g, torch.ones(n), torch.ones(n))
    assert len(g.entries) == 2
    before = graphs.eager['test']
    calls(g, torch.ones(3))
    assert graphs.eager['test'] == before + 1


def test_moved_state_drops_the_cache(fake_graphs):
    g = graphs.Graphs('test')
    calls(g, torch.ones(3), torch.ones(3))
    assert len(g.entries) == 1
    fake_graphs['state'] = (2,)
    before = graphs.eager['test']
    calls(g, torch.ones(3))
    assert not g.entries and graphs.eager['test'] == before + 1


def test_no_capture_while_a_profiler_records(fake_graphs):
    g = graphs.Graphs('test')
    calls(g, torch.ones(3))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        calls(g, torch.ones(3))
    assert not g.entries
    calls(g, torch.ones(3))
    assert len(g.entries) == 1


def test_fresh_outputs_outlive_the_next_replay(fake_graphs):
    g = graphs.Graphs('test')
    a, b, c, d = calls(g, *[torch.full((3,), float(i)) for i in (1, 2, 3,
                                                                   4)],
                       fresh=(0,))
    assert torch.equal(c[0], torch.full((3,), 6.0))
    assert torch.equal(d[0], torch.full((3,), 8.0))
    assert c[1] is d[1]           # not asked for: the static tensor
    assert torch.equal(b[0], torch.full((3,), 4.0))   # the capture's own


# --- on the card ---------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def card_model(cuda, config='exp_panoptic.py', **head):
    from das_tpu_torch.apis.inference import init_model
    cfg = Config.fromfile(os.path.join(ROOT, 'configs/das', config))
    cfg.model.bbox_head.update(head)
    model, _ = init_model(cfg, dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, 'conv_offset'):      # offsets of ~1 px
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen, device=cuda)
                        .to(w.dtype) * 0.02)
    return model


def card_feats(cuda, seed, hw=(256, 384)):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(2, 256, hw[0] // s, hw[1] // s, generator=gen,
                        device=cuda).to(torch.bfloat16)
            .contiguous(memory_format=torch.channels_last)
            for s in (4, 8, 16, 32)]


def run_head(head, x, eager=False):
    ctx = global_hook() if eager else contextlib.nullcontext()
    with torch.inference_mode(), ctx:
        out = head(x)
    torch.cuda.synchronize()
    return out


def same(a, b):
    return all(torch.equal(x, y) for xs, ys in zip(a, b)
               for x, y in zip(xs, ys))


@pytest.fixture(scope='module')
def panoptic(cuda):
    model = card_model(cuda)
    head = model.bbox_head
    xa, xb = card_feats(cuda, 1), card_feats(cuda, 2)
    ref = dict(a=run_head(head, xa, eager=True),
               b=run_head(head, xb, eager=True))
    before = counts()
    k4 = [gather.launches, gather.sampler_launches]
    first = run_head(head, xa)        # eager: the first call at its key
    k4 += [gather.launches, gather.sampler_launches]
    second = run_head(head, xa)       # the warm-up, then the capture
    k4 += [gather.launches, gather.sampler_launches]
    assert moved(before) == {'trunk': (4, 0, 4), 'ru': (4, 0, 4)}
    per_call = [[b - a for a, b in zip(k4[i:i + 2], k4[i + 2:i + 4])]
                for i in (0, 2)]
    return dict(model=model, head=head, xa=xa, xb=xb, ref=ref,
                first=first, second=second, per_call=per_call)


@pytest.mark.cuda
def test_card_graphed_head_equals_eager_bit_for_bit(panoptic):
    p = panoptic
    assert same(p['first'], p['ref']['a'])
    assert same(p['second'], p['ref']['a'])
    before = counts()
    third = run_head(p['head'], p['xa'])
    assert moved(before) == {'trunk': (0, 4, 0), 'ru': (0, 4, 0)}
    assert same(third, p['ref']['a'])


@pytest.mark.cuda
def test_card_inputs_in_turn_keep_their_own_outputs(panoptic):
    p = panoptic
    outs = [run_head(p['head'], p[k]) for k in ('xa', 'xb', 'xa', 'xb')]
    for out, k in zip(outs, 'abab'):
        assert same(out, p['ref'][k]), k
    assert not same(p['ref']['a'], p['ref']['b'])


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['cls_convs.1.conv.conv_offset',
                                   RU_DCN + '.conv_offset'])
def test_card_hook_after_capture_runs_eagerly(panoptic, where):
    p = panoptic
    run_head(p['head'], p['xa'])
    seen = []
    h = _hook(p['head'], where, seen)
    try:
        before = counts()
        out = run_head(p['head'], p['xa'])
    finally:
        h.remove()
    kind = 'ru' if where.startswith('recursive') else 'trunk'
    other = 'trunk' if kind == 'ru' else 'ru'
    assert len(seen) == 4
    assert moved(before) == {kind: (0, 0, 4), other: (0, 4, 0)}
    assert same(out, p['ref']['a'])


@pytest.mark.cuda
@pytest.mark.parametrize('how', ['load_state_dict', 'rebind'])
def test_card_new_weights_are_seen(cuda, how):
    model = card_model(cuda)
    head = model.bbox_head
    x = card_feats(cuda, 3)
    run_head(head, x)
    run_head(head, x)
    sd = {k: v.clone() for k, v in head.state_dict().items()}
    with torch.no_grad():
        w = head.conv_cls.weight
        if how == 'load_state_dict':
            sd['conv_cls.weight'] = w * 1.5
            head.load_state_dict(sd, strict=True)
        else:
            w.data = w.data * 1.5
    before = counts()
    got = run_head(head, x)
    want = run_head(head, x, eager=True)
    assert same(got, want)
    replays = moved(before)['trunk'][1]
    assert replays == (4 if how == 'load_state_dict' else 0)


@pytest.mark.cuda
def test_card_replay_counts_the_launches_eager_makes(panoptic):
    p = panoptic
    names = [(gather, 'launches'), (gather, 'sampler_launches')]

    def launched(eager):
        a = [getattr(m, n) for m, n in names]
        run_head(p['head'], p['xa'], eager=eager)
        return [getattr(m, n) - b for (m, n), b in zip(names, a)]
    before = counts()
    graphed = launched(False)
    assert moved(before)['trunk'][1] == 4
    assert graphed == launched(True) and graphed[1] > 0
    # the eager call and the capturing one count a run each
    assert p['per_call'] == [graphed, graphed]


@pytest.mark.cuda
def test_card_k1_and_k2_under_capture(cuda):
    """``'shift_pallas'`` (K1) and the fused conv+GN (K2) in the trunk:
    graphed == eager bit for bit, and their counters advance on replay."""
    model = card_model(cuda, 'exp_panoptic_tpu_fused_gn.py',
                       dcn_gather_mode='shift_pallas')
    head = model.bbox_head
    x = card_feats(cuda, 4)
    want = run_head(head, x, eager=True)
    run_head(head, x)
    run_head(head, x)
    names = [(dcn_shift, 'launches'), (conv_gn, 'launches')]
    a = [getattr(m, n) for m, n in names]
    before = counts()
    got = run_head(head, x)
    assert moved(before)['trunk'] == (0, 4, 0)
    per = [getattr(m, n) - b for (m, n), b in zip(names, a)]
    assert per[0] > 0 and per[1] > 0
    assert same(got, want)
