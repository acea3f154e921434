from .convert import load_checkpoint, state_dict_from_flax, strip_prefixes

__all__ = ['load_checkpoint', 'state_dict_from_flax', 'strip_prefixes']
