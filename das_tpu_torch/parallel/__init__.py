"""Training on one card: the optimizer and the train step."""

from .train_step import (TrainState, frozen_mask, make_lr_fn, make_optimizer,
                         make_train_step, mspn_frozen_prefixes, param_groups)

__all__ = ['TrainState', 'frozen_mask', 'make_lr_fn', 'make_optimizer',
           'make_train_step', 'mspn_frozen_prefixes', 'param_groups']
