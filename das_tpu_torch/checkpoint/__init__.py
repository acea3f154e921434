from .convert import (export_state_dict, load_checkpoint,
                      load_checkpoint_report, load_mspn_pretrained,
                      save_torch_checkpoint, state_dict_from_flax,
                      strip_prefixes)
from .manager import CheckpointManager

__all__ = ['CheckpointManager', 'export_state_dict', 'load_checkpoint',
           'load_checkpoint_report', 'load_mspn_pretrained',
           'save_torch_checkpoint', 'state_dict_from_flax', 'strip_prefixes']
