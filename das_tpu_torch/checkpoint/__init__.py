from .convert import (load_checkpoint, load_checkpoint_report,
                      state_dict_from_flax, strip_prefixes)

__all__ = ['load_checkpoint', 'load_checkpoint_report',
           'state_dict_from_flax', 'strip_prefixes']
