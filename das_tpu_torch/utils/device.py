"""Where the port runs: the card unless the caller asks for another."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; with ``None``, the first CUDA card.

    Raises when no device is given and there is no card: the port never
    falls back to the CPU on its own. Pass ``device='cpu'`` to run there.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           'to run the port on the CPU')
    return torch.device('cuda', torch.cuda.current_device())
