"""Data parallelism over processes, the port's counterpart of
``das_tpu/parallel/mesh.py`` (``make_mesh``, ``replicate``,
``shard_batch``).

The JAX package runs one SPMD program over a device mesh: XLA shards the
batch, takes every BatchNorm moment and loss normaliser over the global
batch and inserts the gradient all-reduce. Here each card has a process
(``torchrun`` starts them) and the program says the same in
``torch.distributed`` calls: ``replicate`` broadcasts rank 0's weights,
``shard_args`` shards the loader, ``models/layers.py::BatchNorm`` and
``DASHead.loss`` sum their moments and counts over the group, and
``all_reduce_grads`` sums the gradients before the optimizer's global-norm
clip.

Only ``all_reduce``, ``broadcast``, ``barrier`` and ``all_gather_object``
are called, on f32 or int64 tensors: gloo runs each of them on CUDA tensors
too, so two ranks can share one card over gloo (NCCL refuses that). The
backend is the caller's choice; nothing falls back to another. Without a
group every function here is a no-op or the one-process answer.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

# elements of one flat all-reduce or broadcast buffer (128 MiB of f32): the
# shipped model's 794 parameter tensors (66.4 M f32 values) go in 2 calls
BUCKET_ELEMS = 1 << 25


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(f'{name} is not set: launch with python -m '
                           'torch.distributed.run (torchrun)')
    return int(os.environ[name])


def init_distributed(launcher: str = 'none', backend: Optional[str] = None,
                     device=None, init_method: str = 'env://'):
    """Join the process group the launcher describes and return this rank's
    device.

    ``launcher='none'`` joins nothing and returns ``device`` as given.
    ``'pytorch'`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets them (and, through
    ``init_method='env://'``, ``MASTER_ADDR`` / ``MASTER_PORT``; a
    ``file://`` path works too). The device is ``cuda:LOCAL_RANK``, or
    ``device`` on every rank where given; it becomes the current CUDA
    device before any other CUDA work. The backend defaults to ``nccl`` on
    a card and ``gloo`` on the CPU. Only gloo lets several ranks share a
    card: ``nccl`` with a pinned card and more than one local rank raises
    here, before NCCL's own "Duplicate GPU" error.
    """
    if launcher == 'none':
        return device
    if launcher != 'pytorch':
        raise ValueError(f"launcher must be 'none' or 'pytorch', not "
                         f'{launcher!r}')
    rank_, world = _env_int('RANK'), _env_int('WORLD_SIZE')
    local_rank = _env_int('LOCAL_RANK')
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks there")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f'LOCAL_RANK {local_rank} but {torch.cuda.device_count()} '
                'cards: start one rank a card, or pin a device (gloo)')
        dev = torch.device('cuda', local_rank)
    else:
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', 0)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend == 'nccl':
        if dev.type != 'cuda':
            raise ValueError(f'nccl needs a CUDA device, not {dev}')
        if device is not None and local_world > 1:
            raise ValueError(
                f'{local_world} ranks pinned to {dev} over nccl: NCCL takes '
                'one rank a card; share a card over gloo '
                "(backend='gloo') or give each rank its own card")
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world)
    return dev


def rank(group=None) -> int:
    """This process's rank in ``group`` (the default group where None); 0
    with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def world_size(group=None) -> int:
    """The number of ranks in ``group``; 1 with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def shard_args(group=None) -> Tuple[int, int]:
    """``(shard_id, num_shards)`` for the ``TrainLoader``: each rank takes
    its interleaved shard of every epoch's order (the counterpart of
    ``shard_batch``)."""
    return rank(group), world_size(group)


def _buckets(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors in runs of one dtype and at most BUCKET_ELEMS elements
    (a larger tensor is a run of its own)."""
    out, n = [], 0
    for t in tensors:
        if not out or out[-1][0].dtype != t.dtype or \
                n + t.numel() > BUCKET_ELEMS:
            out.append([])
            n = 0
        out[-1].append(t)
        n += t.numel()
    return out


def _flat_collective(tensors: Iterable[torch.Tensor], op):
    """Run ``op`` on one flat buffer per bucket and copy the result back
    into each tensor in place."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def all_reduce_grads(grads: Iterable[torch.Tensor], group) -> None:
    """Sum each gradient over the group's ranks, in place, through a few
    flat f32 buffers (not one call per tensor)."""
    _flat_collective(grads, lambda t: dist.all_reduce(t, group=group))


def replicate(model: nn.Module, group) -> nn.Module:
    """Rank 0's parameters and buffers on every rank of ``group`` (a
    broadcast through flat buffers), the counterpart of
    ``replicate(tree, mesh)``; every ``BatchNorm`` then takes its training
    moments over the group. Returns the model."""
    # imported here: the models import this module (the loss's sum_over)
    from ..models.layers import BatchNorm
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        _flat_collective(
            [t for t in (*model.parameters(), *model.buffers())],
            lambda t: dist.broadcast(t, src=src, group=group))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model


def barrier(group) -> None:
    """Wait for every rank of ``group``; nothing without a group. On NCCL
    the barrier runs on this rank's current card."""
    if group is None:
        return
    if dist.get_backend(group) == 'nccl':
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def sum_over(group, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 0-d ``values`` each summed over the group's ranks in one
    all-reduce of an f32 vector; the values as they are without a group."""
    if group is None:
        return values
    t = torch.stack([v.float() for v in values])
    dist.all_reduce(t, group=group)
    return tuple(t.unbind())
