"""Data parallelism of the port (``das_tpu_torch/parallel/mesh.py``) on the
CPU: two ranks over gloo, against the JAX package and against one process.

Global-batch BatchNorm against flax's BatchNorm over the whole batch; one
whole train step of two ranks on the halves of a batch against the JAX
package's own data-parallel step (``make_mesh(2)``, ``replicate``,
``shard_batch`` around ``make_train_step``, on the conftest's 8-device CPU
mesh), with the ranks' states bit-equal; a rank whose half holds no
positive; the loader's shards; ``train_model`` and ``run_test`` at two
ranks against one process; the CLI under ``torch.distributed.run``; and
``init_distributed``'s refusal of two NCCL ranks on one card.

The ranks are spawned processes that import this module for their entry
points, so it imports torch and the port only: the JAX side is imported
inside the fixtures and tests, in the test process. The ranks are spawned
once for the module (``ranks``): each runs every job in order, on one torch
thread, and hands back its results through a file under ``tmp_path``; a
FileStore under ``tmp_path`` joins them (no TCP port, so parallel test
workers cannot collide). fp32, TF32 off.
"""

import glob
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from das_tpu_torch.apis import run_test, train_model
from das_tpu_torch.config import Config
from das_tpu_torch.core.targets import get_targets
from das_tpu_torch.datasets import build_dataset
from das_tpu_torch.datasets.loader import TrainLoader
from das_tpu_torch.models import build_model, build_trainable_model
from das_tpu_torch.models.layers import BatchNorm
from das_tpu_torch.parallel import (TrainState, init_distributed,
                                    make_lr_fn, make_optimizer,
                                    make_train_step, mspn_frozen_prefixes,
                                    rank, replicate, shard_args, sum_over,
                                    world_size)
from das_tpu_torch.parallel import mesh

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 2
RANK_TIMEOUT = 400


# ------------------------------------------------------------ the ranks

def _rank_main(rank_, world, store, jobs, out):
    """One rank: join the group through the FileStore, run every job
    ``(name, fn, kwargs)`` as ``fn(rank, group, **kwargs)``, save the
    results; on an error save the traceback and exit nonzero."""
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank_), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    try:
        init_distributed('pytorch', 'gloo', 'cpu',
                         init_method=f'file://{store}')
        results = {name: fn(rank_, dist.group.WORLD, **kw)
                   for name, fn, kw in jobs}
        torch.save(results, f'{out}.{rank_}')
    except BaseException:
        with open(f'{out}.{rank_}.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(tmp_path, jobs, world=W, timeout=RANK_TIMEOUT):
    """Spawn ``world`` ranks that run ``jobs``; their results by rank. A
    rank that fails ends the others."""
    ctx = mp.get_context('spawn')
    out = str(tmp_path / 'result')
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, str(tmp_path / 'store'), jobs, out)) for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and time.monotonic() < end:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    errs = [open(f).read() for f in sorted(glob.glob(out + '.*.err'))]
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, (codes, errs)
    return [torch.load(f'{out}.{r}', weights_only=False)
            for r in range(world)]


def _bn_job(rank_, group, x, g, b, rm, rv, ct):
    """BatchNorm on this rank's half of NCHW ``x`` with the group's
    moments: its output, running statistics and the gradients of
    sum(y * ct) by the half, the weight and the bias (this rank's sums)."""
    half = x.shape[0] // world_size(group)
    xs = torch.from_numpy(x[rank_ * half:(rank_ + 1) * half]) \
        .requires_grad_()
    bn = BatchNorm(x.shape[1]).train()
    bn.load_state_dict(dict(weight=torch.from_numpy(g),
                            bias=torch.from_numpy(b),
                            running_mean=torch.from_numpy(rm),
                            running_var=torch.from_numpy(rv)))
    bn.group = group
    y = bn(xs)
    (y * torch.from_numpy(ct[rank_ * half:(rank_ + 1) * half])).sum() \
        .backward()
    return dict(y=y.detach(), running_mean=bn.running_mean,
                running_var=bn.running_var, dx=xs.grad,
                dg=bn.weight.grad, db=bn.bias.grad)


def _one_step(model_cfg, sd, batch, step_kw, group):
    """One make_train_step from ``sd`` on ``batch`` (this rank's shard
    with a group): the metrics, the state dict and the momentum."""
    model = build_trainable_model(model_cfg, device='cpu')
    model.load_state_dict(sd, strict=True)
    if group is not None:
        replicate(model, group)
    tx_init, tx_update = make_optimizer(
        model, make_lr_fn(2e-3), frozen_prefixes=mspn_frozen_prefixes(1))
    state = TrainState(0, model, tx_init(dict(model.named_parameters())))
    step = make_train_step(tx_update, group=group, **step_kw)
    state, metrics = step(state, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                sd=model.state_dict(), momentum=state.opt_state['momentum'])


def _step_job(rank_, group, model_cfg, sd, batches, step_kw):
    return _one_step(model_cfg, sd, batches[rank_], step_kw, group)


def _train_job(rank_, group, cfg, work_dir):
    """train_model for 2 steps at samples_per_gpu=1 a rank, then resumed
    from the latest save for a third."""
    run = dict(work_dir=work_dir, log_interval=1, dtype=torch.float32,
               device='cpu', group=group)
    first = train_model(Config(cfg), max_steps=2, **run)
    again = train_model(Config(cfg), max_steps=3, resume_from='latest',
                        **run)
    return dict(steps=(first.step, again.step), sd=again.model.state_dict(),
                momentum=again.opt_state['momentum'])


def _eval_job(rank_, group, model_cfg, sd, cfg):
    """run_test over the group, through both sweeps."""
    model = build_model(model_cfg, device='cpu')
    model.load_state_dict(sd, strict=True)
    cfg = Config(cfg)
    ds = build_dataset(cfg.data['test'])
    return {pre: run_test(model, ds, cfg, batch_size=2, progress=False,
                          device_preprocess=pre, group=group)
            for pre in (False, True)}


# ------------------------------------------------------------- the inputs

@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """As tests/test_torch_train_api.py: the tiny steps' small ops on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def step_inputs():
    """tests/test_torch_train.py's TRAIN_MODEL, its seeded tree (as numpy)
    and the port's state dict of it, _fake_batch and the step's
    arguments."""
    import jax
    from das_tpu.models import build_model as jbuild_model
    from das_tpu_torch.checkpoint import state_dict_from_flax
    from test_torch_model import _seeded_tree, _tree_shapes
    from test_torch_train import (FEATMAPS, HEAD, MAX_POS, TRAIN_MODEL,
                                  J, _fake_batch)
    jmodel = jbuild_model(TRAIN_MODEL)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  _seeded_tree(_tree_shapes(jmodel), seed=0))
    step_kw = dict(featmap_sizes=FEATMAPS, strides=HEAD['strides'],
                   regress_ranges=HEAD['regress_ranges'], num_joints=J,
                   max_pos=MAX_POS)
    return dict(jmodel=jmodel, tree=tree, model_cfg=TRAIN_MODEL,
                sd=state_dict_from_flax(tree['params'], tree['batch_stats']),
                batch=_fake_batch(), step_kw=step_kw)


def _halves(batch):
    return [{k: v[r::W] for k, v in batch.items()} for r in range(W)]


def _num_pos(batch, step_kw):
    t = get_targets(step_kw['featmap_sizes'], step_kw['strides'],
                    step_kw['regress_ranges'],
                    *[torch.from_numpy(batch[k]) for k in (
                        'gt_poses_3d', 'gt_centers2d', 'gt_depths',
                        'gt_valid')], step_kw['num_joints'])
    return int((t['labels'] < 1).sum())


def _no_positives(batch):
    """``batch`` with image 1's people all invalid."""
    out = {k: v.copy() for k, v in batch.items()}
    out['gt_valid'][1] = False
    return out


@pytest.fixture(scope='module')
def bn_inputs():
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 8, 6, 5) * 2 + 1).astype(np.float32)       # NCHW
    g, b, rm = (rng.randn(3, 8) * 0.3).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    ct = rng.randn(*x.shape).astype(np.float32)
    return dict(x=x, g=g, b=b, rm=rm, rv=rv, ct=ct)


@pytest.fixture(scope='module')
def train_inputs(tmp_path_factory):
    """tests/test_torch_train_api.py's train_cfg on its on-disk frames, at
    samples_per_gpu 1 (a rank's) and 2 (one process)."""
    from test_torch_train_api import train_cfg
    from test_torch_train_data import write_panoptic
    root = str(tmp_path_factory.mktemp('dist_frames'))
    ann = write_panoptic(root, n=6, edge=())
    cfgs = {}
    for spb in (1, 2):
        d = train_cfg(root, ann)
        d['data']['samples_per_gpu'] = spb
        cfgs[spb] = d
    return cfgs, str(tmp_path_factory.mktemp('dist_work'))


@pytest.fixture(scope='module')
def eval_inputs(tmp_path_factory):
    """tests/test_torch_eval.py's tiny model, seeded weights with the cls
    bias at 0 (people pass score_thr), and its 3 PNG frames (90x120)."""
    import cv2
    from test_e2e import make_dataset_on_disk
    from test_torch_eval import TINY15, _cfg_dict
    root = str(tmp_path_factory.mktemp('dist_eval'))
    ann = make_dataset_on_disk(root, n_images=3)
    with open(ann) as f:
        d = json.load(f)
    rng = np.random.RandomState(4)
    for im in d['images']:
        im['file_name'] = im['file_name'].replace('.jpg', '.png')
        im['height'], im['width'] = 90, 120
        small = rng.randint(0, 255, (12, 16, 3)).astype(np.float32)
        cv2.imwrite(os.path.join(root, im['file_name']), cv2.resize(
            small, (120, 90), interpolation=cv2.INTER_LINEAR)
            .astype(np.uint8))
    with open(ann, 'w') as f:
        json.dump(d, f)
    model = build_model(TINY15, device='cpu', seed=1)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    return dict(model_cfg=TINY15, sd=model.state_dict(),
                cfg=_cfg_dict(root, ann))


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, step_inputs, bn_inputs, train_inputs,
          eval_inputs):
    """Every job on two ranks, spawned once: rank r's results."""
    s = step_inputs
    cfgs, work = train_inputs
    jobs = [
        ('bn', _bn_job, bn_inputs),
        ('step', _step_job, dict(model_cfg=s['model_cfg'], sd=s['sd'],
                                 batches=_halves(s['batch']),
                                 step_kw=s['step_kw'])),
        ('no_pos', _step_job, dict(
            model_cfg=s['model_cfg'], sd=s['sd'],
            batches=_halves(_no_positives(s['batch'])),
            step_kw=s['step_kw'])),
        ('train', _train_job, dict(cfg=cfgs[1],
                                   work_dir=os.path.join(work, 'w2'))),
        ('eval', _eval_job, eval_inputs),
    ]
    return run_ranks(tmp_path_factory.mktemp('ranks'), jobs)


def _assert_replicas_equal(results, what):
    """The ranks' state dicts and momenta equal bit for bit."""
    for key in ('sd', 'momentum'):
        a = results[0][what][key]
        for other in results[1:]:
            b = other[what][key]
            assert sorted(a) == sorted(b), (what, key)
            for k in a:
                assert torch.equal(a[k], b[k]), (what, key, k)


# ------------------------------------------------------------------ tests

def test_no_group_is_one_process():
    """Without a process group: rank 0 of 1, the loader unsharded, the
    sums the values themselves; init_distributed('none') joins nothing;
    the flat buffers break at a dtype and at BUCKET_ELEMS."""
    assert (rank(), world_size(), shard_args()) == (0, 1, (0, 1))
    v = (torch.tensor(3), torch.tensor(2.5))
    assert all(a is b for a, b in zip(sum_over(None, *v), v))
    assert init_distributed('none', device='cpu') == 'cpu'
    assert not dist.is_initialized()
    n = mesh.BUCKET_ELEMS
    ts = [torch.zeros(n // 2), torch.zeros(n // 2), torch.zeros(1),
          torch.zeros(3, dtype=torch.int64), torch.zeros(n + 1)]
    assert [[t.numel() for t in b] for b in mesh._buckets(ts)] == [
        [n // 2, n // 2], [1], [3], [n + 1]]


@pytest.mark.parametrize('env,args,match', [
    (dict(RANK='0', WORLD_SIZE='2', LOCAL_RANK='0', LOCAL_WORLD_SIZE='2'),
     ('pytorch', 'nccl', 'cuda:0'), 'share a card over gloo'),
    (dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', LOCAL_WORLD_SIZE='1'),
     ('pytorch', 'nccl', 'cpu'), 'nccl needs a CUDA device'),
    (dict(), ('pytorch', 'gloo', 'cpu'), 'torchrun'),
    (dict(), ('slurm', None, 'cpu'), "'none' or 'pytorch'"),
])
def test_init_distributed_refuses(monkeypatch, env, args, match):
    """Two NCCL ranks pinned to one card raise before any CUDA call (no
    card needed), as do NCCL on the CPU, a missing torchrun variable and an
    unknown launcher; no group is joined."""
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, 'set_device', None)
    with pytest.raises((ValueError, RuntimeError), match=match):
        init_distributed(*args)
    assert not dist.is_initialized()


def test_batchnorm_two_ranks_match_flax(ranks, bn_inputs):
    """BatchNorm on two ranks, half the batch each, against flax BatchNorm
    over the whole batch: the output, the running statistics (equal on
    both ranks, bit for bit), and the gradients of sum(y * ct) by the
    input, and by the weight and bias summed over the ranks, against
    jax.grad; rtol 1e-5 as test_batchnorm_train_matches_flax."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    d = bn_inputs
    x = jnp.asarray(d['x'].transpose(0, 2, 3, 1))
    ct = jnp.asarray(d['ct'].transpose(0, 2, 3, 1))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)

    def f(x, g, b):
        y, mut = bn.apply(dict(params=dict(scale=g, bias=b),
                               batch_stats=dict(mean=d['rm'], var=d['rv'])),
                          x, mutable=['batch_stats'])
        return (y * ct).sum(), (y, mut['batch_stats'])

    (_, (want, stats)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(x, d['g'], d['b'])
    res = [r['bn'] for r in ranks]
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)    # noqa: E731
    got_y = np.concatenate([r['y'].numpy() for r in res])
    np.testing.assert_allclose(got_y, nchw(want), rtol=1e-5, atol=1e-5)
    got_dx = np.concatenate([r['dx'].numpy() for r in res])
    np.testing.assert_allclose(got_dx, nchw(grads[0]), rtol=1e-5,
                               atol=1e-5 * np.abs(grads[0]).max())
    for key, want_g in (('dg', grads[1]), ('db', grads[2])):
        got = sum(r[key] for r in res).numpy()
        np.testing.assert_allclose(got, np.asarray(want_g), rtol=1e-5,
                                   atol=1e-5 * np.abs(want_g).max())
    for key, ref in (('running_mean', stats['mean']),
                     ('running_var', stats['var'])):
        assert torch.equal(res[0][key], res[1][key]), key
        np.testing.assert_allclose(res[0][key].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module')
def jax_mesh_step(step_inputs):
    """The JAX package's data-parallel step from the seeded tree: the
    state replicated and _fake_batch sharded over a 2-device mesh. Its
    metrics, and the parameters, batch statistics and momentum after it as
    the port's keys."""
    import jax
    import jax.numpy as jnp
    from das_tpu.parallel import train_step as jts
    from das_tpu.parallel.mesh import make_mesh
    from das_tpu.parallel.mesh import replicate as jreplicate
    from das_tpu.parallel.mesh import shard_batch
    from das_tpu_torch.checkpoint import state_dict_from_flax
    s = step_inputs
    tree, kw = s['tree'], s['step_kw']
    params = jax.tree_util.tree_map(jnp.asarray, tree['params'])
    stats = jax.tree_util.tree_map(jnp.asarray, tree['batch_stats'])
    tx_init, tx_update = jts.make_optimizer(
        params, jts.make_lr_fn(2e-3),
        frozen_prefixes=jts.mspn_frozen_prefixes(1))
    mesh_ = make_mesh(W)
    state = jreplicate(jts.TrainState(jnp.zeros((), jnp.int32), params,
                                      stats, tx_init(params)), mesh_)
    step = jts.make_train_step(s['jmodel'], tx_update, kw['featmap_sizes'],
                               kw['strides'], kw['regress_ranges'],
                               kw['num_joints'], max_pos=kw['max_pos'],
                               donate=False)
    state, metrics = step(state, shard_batch(
        {k: jnp.asarray(v) for k, v in s['batch'].items()}, mesh_))
    host = jax.tree_util.tree_map(np.asarray, state)
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_flax(host.params, host.batch_stats),
            state_dict_from_flax(host.opt_state['momentum']))


def _assert_step_close(got, want_metrics, want_sd, want_mom, model_cfg):
    """A rank's step against a reference step from the same weights, at
    test_train_step_matches_jax's tolerances: metrics rtol 1e-4 (grad_norm
    1e-3); each update (-lr * lr_mult * trainable * momentum) within
    UPDATE_RTOL of its leaf's largest, a leaf that is zero to rounding
    (below 1e-6 of the largest update of all) within 1e-6 of that largest;
    the parameters within that plus one f32 rounding; batch statistics
    rtol 1e-4."""
    from das_tpu_torch.parallel import frozen_mask, param_groups
    from test_torch_train import UPDATE_RTOL
    pm = got['metrics']
    assert sorted(pm) == sorted(want_metrics)
    for k, v in want_metrics.items():
        rtol = 1e-3 if k == 'grad_norm' else 1e-4
        np.testing.assert_allclose(pm[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    model = build_trainable_model(model_cfg, device='cpu')
    lr_mult, _ = param_groups(model)
    trainable = frozen_mask(model, mspn_frozen_prefixes(1))
    lr = make_lr_fn(2e-3)(0)
    upd = {k: (-lr * lr_mult[k] * trainable[k] * want_mom[k].numpy(),
               -lr * lr_mult[k] * trainable[k] * got['momentum'][k].numpy())
           for k in trainable}
    top = max(np.abs(w).max() for w, _ in upd.values())
    for k, (want, mine) in upd.items():
        own = np.abs(want).max()
        tol = UPDATE_RTOL * own if own >= 1e-6 * top else 1e-6 * top
        assert np.abs(mine - want).max() <= tol, k
        p = want_sd[k].numpy()
        assert np.all(np.abs(got['sd'][k].numpy() - p)
                      <= tol + np.spacing(np.abs(p))), k
    for k, v in got['sd'].items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_two_rank_step_matches_jax_mesh_step(ranks, step_inputs,
                                             jax_mesh_step):
    """One step of two ranks, each on its half of _fake_batch (whose
    positive counts differ), against the JAX step over a 2-device mesh from
    the same weights (_assert_step_close; grad_norm above the clip). The
    two ranks' parameters, batch statistics, momenta and metrics are equal
    bit for bit."""
    s = step_inputs
    counts = [_num_pos(h, s['step_kw']) for h in _halves(s['batch'])]
    assert counts[0] != counts[1] and min(counts) > 0, counts
    _assert_replicas_equal(ranks, 'step')
    res = [r['step'] for r in ranks]
    assert res[0]['metrics'] == res[1]['metrics']
    assert jax_mesh_step[0]['grad_norm'] > 35.0
    _assert_step_close(res[0], *jax_mesh_step, s['model_cfg'])


def test_rank_without_positives(ranks, step_inputs):
    """Image 1 holds no valid person: rank 1's half has no positive, yet
    the global batch has some (has_pos 1). The two ranks' step, their loss
    terms summed, equals one process's step on the whole batch
    (_assert_step_close), every metric finite (no 0/0 on rank 1)."""
    s = step_inputs
    batch = _no_positives(s['batch'])
    counts = [_num_pos(h, s['step_kw']) for h in _halves(batch)]
    assert counts[0] > 0 and counts[1] == 0, counts
    one = _one_step(s['model_cfg'], s['sd'], batch, s['step_kw'], None)
    _assert_replicas_equal(ranks, 'no_pos')
    got = ranks[0]['no_pos']
    assert all(np.isfinite(v) for v in got['metrics'].values())
    assert one['metrics']['loss_pose'] > 0.0
    _assert_step_close(got, one['metrics'], one['sd'], one['momentum'],
                       s['model_cfg'])


def test_loader_shards_are_the_one_loader_batch(train_inputs):
    """The TrainLoader under W=2 (shard r of 2, batch 1) against one loader
    of batch 2, same dataset and seed: at each step the ranks' samples are
    the one loader's, bit for bit (each sample's generator is seeded from
    its global position), and every rank has the same steps_per_epoch."""
    cfgs, _ = train_inputs
    ds = build_dataset(Config(cfgs[2]).data['train'])
    one = TrainLoader(ds, 2, (128, 160), 15, num_workers=2, seed=0)
    shards = [TrainLoader(ds, 1, (128, 160), 15, num_workers=1, seed=0,
                          shard_id=r, num_shards=W) for r in range(W)]
    assert {s.steps_per_epoch for s in shards} == {one.steps_per_epoch} \
        == {3}
    its = [iter(x) for x in (one, *shards)]
    try:
        for _ in range(4):                  # across an epoch end
            whole, *parts = [next(it) for it in its]
            for k, v in whole.items():
                for r, part in enumerate(parts):
                    np.testing.assert_array_equal(part[k], v[r::W], k)
    finally:
        for it in its:
            it.close()


def test_train_model_two_ranks_match_one_process(ranks, train_inputs,
                                                 tmp_path):
    """train_model at W=2 with samples_per_gpu=1 against W=1 with
    samples_per_gpu=2 on the on-disk frames, 2 steps and then a resume from
    the latest save for a third: each step's losses within 1e-4 and
    grad_norm within 1e-3 (test_train_step_matches_jax's tolerances; the
    random-init steps are ill-conditioned and the two runs' parameters
    part by rounding from step 1 on), the ranks' final states equal bit
    for bit. Rank 0 alone writes: one metrics line a step, the checkpoints
    (max_keep 2) and meta.json."""
    cfgs, work = train_inputs
    w2 = os.path.join(work, 'w2')
    w1 = str(tmp_path / 'w1')
    run = dict(work_dir=w1, log_interval=1, dtype=torch.float32,
               device='cpu')
    train_model(Config(cfgs[2]), max_steps=2, **run)
    train_model(Config(cfgs[2]), max_steps=3, resume_from='latest', **run)
    assert [r['train']['steps'] for r in ranks] == [(2, 3)] * W
    _assert_replicas_equal(ranks, 'train')

    def metrics(d):
        lines = []
        for f in sorted(glob.glob(os.path.join(d, '*.metrics.jsonl'))):
            lines += [json.loads(x) for x in open(f).read().splitlines()]
        return lines
    got, want = metrics(w2), metrics(w1)
    assert [m['step'] for m in got] == [m['step'] for m in want] \
        == [1, 2, 3]
    for g, w in zip(got, want):
        assert g['img_per_s'] > 0
        for k, v in w.items():
            if k in ('step', 'img_per_s'):
                continue
            np.testing.assert_allclose(
                g[k], v, rtol=1e-3 if k == 'grad_norm' else 1e-4, atol=1e-7,
                err_msg=f"step {w['step']} {k}")
    assert sorted(os.listdir(os.path.join(w2, 'ckpts'))) == [
        'meta.json', 'step_00000002.pt', 'step_00000003.pt']
    assert len(glob.glob(os.path.join(w2, 'tf_logs', '*'))) >= 1


def test_run_test_two_ranks_match_one_process(ranks, eval_inputs):
    """run_test over two ranks (rank r sweeps images r, r + 2, ...) against
    one process, through the host pipeline and device preprocessing, on
    tests/test_torch_eval.py's frames: every rank returns the whole list in
    dataset order, the ranks' lists equal, and the people agree with one
    process's (_assert_people_agree)."""
    from test_torch_eval import _assert_people_agree
    model = build_model(eval_inputs['model_cfg'], device='cpu')
    model.load_state_dict(eval_inputs['sd'], strict=True)
    cfg = Config(eval_inputs['cfg'])
    ds = build_dataset(cfg.data['test'])
    for pre in (False, True):
        want = run_test(model, ds, cfg, batch_size=2, progress=False,
                        device_preprocess=pre)
        got = [r['eval'][pre] for r in ranks]
        assert len(got[0]) == len(ds) == 3
        assert sum(len(g['poses']) for g in want) > 0
        for a, b in zip(*got):
            assert a['image_paths'] == b['image_paths']
            for k in ('poses', 'scores', 'centers'):
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
        _assert_people_agree(got[0], want, f'device_preprocess={pre}')


def test_train_cli_under_torchrun(train_inputs, tmp_path):
    """python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    das_tpu_torch.tools.train CONFIG --launcher pytorch --device cpu
    --max-steps 1 --autoscale-lr: exit 0, one step on 2 ranks, rank 0's
    checkpoint and the learning rate scaled by 2/8 in the saved config."""
    cfgs, _ = train_inputs
    cfg_path = str(tmp_path / 'tiny_train.py')
    with open(cfg_path, 'w') as f:
        for k, v in cfgs[1].items():
            f.write(f'{k} = {v!r}\n')
    work = str(tmp_path / 'work')
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc-per-node', '2', '-m', 'das_tpu_torch.tools.train',
         cfg_path, '--work-dir', work, '--launcher', 'pytorch', '--device',
         'cpu', '--max-steps', '1', '--autoscale-lr', '--cfg-options',
         'data.workers_per_gpu=1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '[das_tpu_torch] trained to step 1 on 2 rank(s)' in proc.stdout
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == [
        'meta.json', 'step_00000001.pt']
    meta = json.load(open(os.path.join(work, 'ckpts', 'meta.json')))
    assert "'lr': 0.00025" in meta['config']
