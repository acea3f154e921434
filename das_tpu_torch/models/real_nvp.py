"""RealNVP normalizing flows for the RLE loss, port of
``das_tpu/models/real_nvp.py``.

The serving path never runs them; the head holds them so that its state
dict is whole and a checkpoint loads with ``strict=True``. Key layout is the
reference's: ``s.{i}`` / ``t.{i}`` are Sequentials of Linear(dim,64),
LeakyReLU, Linear(64,64), LeakyReLU, Linear(64,dim)[, Tanh]. The coupling
masks are constant and not part of the state dict.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn


def _mlp(dim: int, tanh_out: bool) -> nn.Sequential:
    layers = [nn.Linear(dim, 64), nn.LeakyReLU(0.01), nn.Linear(64, 64),
              nn.LeakyReLU(0.01), nn.Linear(64, dim)]
    if tanh_out:
        layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class RealNVP(nn.Module):
    """dim-D RealNVP with 6 coupling layers; ``forward`` is log_prob.

    ``dim=3`` uses masks [[0,0,1],[1,1,0]]*3 (ref real_nvp.py:35);
    ``dim=2`` uses [[0,1],[1,0]]*3 (ref real_nvp.py:97).
    """

    def __init__(self, dim: int = 3):
        super().__init__()
        self.dim = dim
        masks = np.array([[0, 0, 1], [1, 1, 0]] * 3 if dim == 3
                         else [[0, 1], [1, 0]] * 3, np.float32)
        self.register_buffer('mask', torch.from_numpy(masks),
                             persistent=False)
        self.s = nn.ModuleList([_mlp(dim, True) for _ in range(len(masks))])
        self.t = nn.ModuleList([_mlp(dim, False) for _ in range(len(masks))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """log_prob of x, shape (N, dim) -> (N,)."""
        x = x.float()
        log_det = torch.zeros(x.shape[0], dtype=torch.float32,
                              device=x.device)
        z = x
        for i in reversed(range(len(self.mask))):
            m = self.mask[i]
            z_ = m * z
            s = self.s[i](z_) * (1 - m)
            t = self.t[i](z_) * (1 - m)
            z = (1 - m) * (z - t) * torch.exp(-s) + z_
            log_det = log_det - s.sum(dim=1)
        prior = -0.5 * (z ** 2).sum(dim=1) \
            - 0.5 * self.dim * math.log(2.0 * math.pi)
        return prior + log_det
