"""Training: the optimizer and the train step, on one card or data-parallel
over a process group."""

from .mesh import (all_reduce_grads, barrier, init_distributed, rank,
                   replicate, shard_args, sum_over, world_size)
from .train_step import (TrainState, frozen_mask, make_lr_fn, make_optimizer,
                         make_train_step, mspn_frozen_prefixes, param_groups)

__all__ = ['TrainState', 'all_reduce_grads', 'barrier', 'frozen_mask',
           'init_distributed', 'make_lr_fn', 'make_optimizer',
           'make_train_step', 'mspn_frozen_prefixes', 'param_groups', 'rank',
           'replicate', 'shard_args', 'sum_over', 'world_size']
