"""Row gather kernel (CUDA, sm_90a), its adjoint, and their plain versions.

Counterpart of ``tools/analysis_tools/pallas_gather_probe.py::gather_pl``,
the in-kernel row gather that the JAX package runs as
``take_along_axis(..., mode='clip')`` in every bilinear sample and in the
recursive update's ``take_at``. ``gather_rows(table, idx)`` computes

    out[n, p] = table[n, clamp(idx[n, p], 0, R - 1)]

for table (N, R, C) and idx (N, P) int32 or int64. Its gradient is the
scatter-add of the output gradient into a zero table, accumulated in f32
(f64 for an f64 table) and cast to the table's type, as XLA's adjoint of
the gather.

On a CUDA tensor the wrapper launches the hand-written kernels
(``das_tpu_torch/csrc/gather_rows.cu``) or raises; on a CPU tensor it runs
the plain versions. Both go through one ``torch.autograd.Function``, which
takes its forward and backward as arguments. The kernels are built with
``nvcc`` at first use into ``build/das_tpu_torch/`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import torch

from .cuda_build import INT, LONG, PTR, CudaLibrary, check_launch, \
    check_tensor

LIB = CudaLibrary('gather_rows.cu', {
    'gather_rows_forward': [PTR, PTR, PTR, LONG, LONG, LONG, INT, INT, PTR],
    'gather_rows_backward': [PTR, PTR, PTR, LONG, LONG, LONG, INT, INT, INT,
                             PTR]})

# Kernel launches since the last reset, forward and backward; the main
# path's run reads them.
launches = 0
backward_launches = 0

_IDX_TYPES = (torch.int32, torch.int64)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of the forward: clamp, then index."""
    N, R, _ = table.shape
    nidx = torch.arange(N, device=table.device)[:, None]
    return table[nidx, idx.long().clamp(0, R - 1)]


def scatter_rows_plain(grad: torch.Tensor, idx: torch.Tensor, rows: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the backward: ``index_add_`` of ``grad`` (N, P, C)
    into a zero (N, rows, C) buffer in f32 (f64 for f64), cast to
    ``dtype``."""
    N, P, C = grad.shape
    acc = torch.promote_types(dtype, torch.float32)
    flat = idx.long().clamp(0, rows - 1) \
        + torch.arange(N, device=grad.device)[:, None] * rows
    buf = torch.zeros((N * rows, C), dtype=acc, device=grad.device)
    buf.index_add_(0, flat.reshape(-1), grad.reshape(N * P, C).to(acc))
    return buf.reshape(N, rows, C).to(dtype)


def _check_cuda(table: torch.Tensor, idx: torch.Tensor):
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes f32 or bf16 tables '
                        f'(got {table.dtype})')
    if idx.dtype not in _IDX_TYPES:
        raise TypeError(f'idx must be int32 or int64 (got {idx.dtype})')
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f'table must be (N,R,C) and idx (N,P), got '
                         f'{tuple(table.shape)} and {tuple(idx.shape)}')
    check_tensor('table', table, table.shape, table.dtype, table.device)
    check_tensor('idx', idx, idx.shape, idx.dtype, table.device)


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch the forward kernel."""
    global launches
    _check_cuda(table, idx)
    N, R, C = table.shape
    P = idx.shape[1]
    out = torch.empty((N, P, C), dtype=table.dtype, device=table.device)
    lib = LIB.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.gather_rows_forward(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, R, P,
            C * table.element_size(), int(idx.dtype == torch.int64), stream)
    check_launch('gather_rows', err)
    launches += 1
    return out


def scatter_rows_cuda(grad: torch.Tensor, idx: torch.Tensor, rows: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Launch the backward kernel into a zero f32 buffer; cast to
    ``dtype``."""
    global backward_launches
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes f32 or bf16 gradients '
                        f'(got {grad.dtype})')
    if idx.dtype not in _IDX_TYPES:
        raise TypeError(f'idx must be int32 or int64 (got {idx.dtype})')
    N, P, C = grad.shape
    check_tensor('grad', grad, (N, P, C), grad.dtype, grad.device)
    check_tensor('idx', idx, (N, P), idx.dtype, grad.device)
    buf = torch.zeros((N, rows, C), dtype=torch.float32, device=grad.device)
    lib = LIB.load()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = lib.gather_rows_backward(
            grad.data_ptr(), idx.data_ptr(), buf.data_ptr(), N, rows, P, C,
            int(grad.dtype == torch.bfloat16),
            int(idx.dtype == torch.int64), stream)
    check_launch('gather_rows backward', err)
    backward_launches += 1
    return buf.to(dtype)


class GatherRows(torch.autograd.Function):
    """``forward(table, idx)`` with the gradient
    ``backward(grad, idx, rows, dtype)``; both are arguments, so the plain
    pair can be checked with ``gradcheck`` in f64."""

    @staticmethod
    def forward(ctx, table, idx, forward, backward):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype, ctx.scatter = table.shape[1], table.dtype, \
            backward
        return forward(table, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        g = ctx.scatter(grad.contiguous(), idx, ctx.rows, ctx.dtype) \
            if ctx.needs_input_grad[0] else None
        return g, None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[n, p] = table[n, clamp(idx[n, p], 0, R - 1)]``.

    table (N, R, C), idx (N, P) int32 or int64 -> (N, P, C). CPU tensors
    run the plain versions; CUDA tensors launch the kernels, which take f32
    or bf16 contiguous tables. Differentiable in ``table``.
    """
    if table.device.type == 'cpu':
        fwd, bwd = gather_rows_plain, scatter_rows_plain
    elif table.device.type == 'cuda':
        fwd, bwd = gather_rows_cuda, scatter_rows_cuda
        idx = idx.contiguous()
    else:
        raise ValueError(f'no row gather kernel for device {table.device}')
    if torch.is_grad_enabled() and table.requires_grad:
        return GatherRows.apply(table, idx, fwd, bwd)
    return fwd(table, idx)
