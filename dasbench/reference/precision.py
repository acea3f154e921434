"""The arithmetic the reference computes in.

The reference runs in float32 with TF32 off (``exact``). Its control, the
reference put in the program's place one precision lower, runs every
convolution and matrix product on inputs, weights and (in training)
incoming gradients rounded to float8 e4m3 with one scale a tensor, as an
fp8 GEMM takes them, and accumulates in float32; the stages that the
program computes in float32 (preprocessing, the decode) run in bfloat16.
The exact reference preprocesses in float64.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class Precision:
    """Which rounding each stage applies: ``matmul`` is None or 'fp8';
    ``preprocess`` and ``decode`` are the dtypes of those two stages, which
    the program computes in float32."""

    def __init__(self, matmul=None, preprocess=torch.float64,
                 decode=torch.float32):
        self.matmul = matmul
        self.preprocess = preprocess
        self.decode = decode


EXACT = Precision()
CONTROL = Precision('fp8', torch.bfloat16, torch.bfloat16)
_current = [EXACT]


def current() -> Precision:
    return _current[0]


@contextlib.contextmanager
def use(p: Precision):
    """Run the reference under ``p``; TF32 stays off either way."""
    prev = _current[0]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _current[0] = p
    try:
        yield
    finally:
        _current[0] = prev
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), returned in t's dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(t.dtype)


class _RoundFp8(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the incoming gradient to
    e4m3 (the fp8 GEMM's gradient operand)."""

    @staticmethod
    def forward(ctx, t):
        return round_e4m3(t)

    @staticmethod
    def backward(ctx, g):
        return round_e4m3(g)


def mm_operand(t: torch.Tensor) -> torch.Tensor:
    """An operand of a convolution or matrix product, as the current
    precision hands it over."""
    if current().matmul == 'fp8':
        return _RoundFp8.apply(t)
    return t
