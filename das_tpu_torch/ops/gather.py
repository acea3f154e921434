"""Row gather kernel (CUDA, sm_90a), its adjoint, the fused bilinear
sampler and its backward, and their plain versions.

Counterpart of ``tools/analysis_tools/pallas_gather_probe.py::gather_pl``,
the in-kernel row gather that the JAX package runs as
``take_along_axis(..., mode='clip')`` in every bilinear sample and in the
recursive update's ``take_at``. ``gather_rows(table, idx)`` computes

    out[n, p] = table[n, clamp(idx[n, p], 0, R - 1)]

for table (N, R, C) and idx (N, P) int32 or int64. Its gradient is the
scatter-add of the output gradient into a zero table, accumulated in f32
(f64 for an f64 table) and cast to the table's type, as XLA's adjoint of
the gather. ``gather_rows_grouped`` does up to ``MAX_SEGMENTS`` such
gathers that share N in one launch, and their adjoints in one launch:
gathers of the same table add into one buffer, zeroed once and cast once.
``sample_rows_bilinear`` is a whole zero-padded bilinear sample of the flat
image in one launch; where autograd records it, its backward is one launch
too (``SampleRowsBilinear``), which keeps only the image and the
coordinates: no corner row is saved or scattered. Where autograd does not
record, the same launch can multiply each point's sample by a modulation
value (``mask``): the served DCN's im2col rows.

On a CUDA tensor a wrapper launches the hand-written kernels
(``das_tpu_torch/csrc/gather_rows.cu``) or raises; on a CPU tensor it runs
the plain versions. The gathers and the sampler go through
``torch.autograd.Function``s that take their forward and backward as
arguments. The kernels are built with ``nvcc`` at first use into
``build/das_tpu_torch/`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from .cuda_build import INT, LONG, PTR, CudaLibrary, check_launch, \
    on_device, raw_stream

LIB = CudaLibrary('gather_rows.cu', {
    'gather_rows_grouped': [PTR, INT, LONG, PTR],
    'scatter_rows_grouped': [PTR, INT, LONG, PTR, LONG, PTR],
    'sample_rows_bilinear': [PTR, PTR, PTR, PTR, PTR, LONG, INT, INT, LONG,
                             INT, INT, PTR],
    'sample_rows_bilinear_backward': [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                      LONG, INT, INT, LONG, INT, INT, PTR]})

# Kernel launches since the last reset: the gather, its adjoint, the fused
# sampler (masked or not) and its backward, and of the sampler's launches
# those with a mask; the main path's run reads them.
launches = 0
backward_launches = 0
sampler_launches = 0
sampler_backward_launches = 0
sampler_masked_launches = 0

MAX_SEGMENTS = 8
_IDX_TYPES = (torch.int32, torch.int64)
_TABLE_TYPES = (torch.float32, torch.bfloat16)


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
    return scatter_grouped_plain([grad], [idx], [0], [rows], [dtype])[0]


def gather_grouped_plain(tables: Sequence[torch.Tensor],
                         idxs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of the grouped forward: one plain gather each."""
    return [gather_rows_plain(t, i) for t, i in zip(tables, idxs)]


def scatter_grouped_plain(grads: Sequence[Optional[torch.Tensor]],
                          idxs: Sequence[torch.Tensor],
                          which: Sequence[int], rows: Sequence[int],
                          dtypes: Sequence[torch.dtype]
                          ) -> List[Optional[torch.Tensor]]:
    """Plain version of the grouped backward. Segment ``s`` has the output
    gradient ``grads[s]`` (N, P_s, C) or None and the indices ``idxs[s]``,
    and belongs to table ``which[s]``, which has ``rows[which[s]]`` rows
    and the type ``dtypes[which[s]]``. Each table's segments are added with
    ``index_add_`` into one zero f32 buffer (f64 for f64), cast once.
    Returns one gradient per table, None where no segment has one."""
    out: List[Optional[torch.Tensor]] = [None] * len(rows)
    for u, (R, dtype) in enumerate(zip(rows, dtypes)):
        buf = None
        for g, idx, w in zip(grads, idxs, which):
            if w != u or g is None:
                continue
            N, P, C = g.shape
            acc = torch.promote_types(dtype, torch.float32)
            if buf is None:
                buf = torch.zeros((N * R, C), dtype=acc, device=g.device)
            flat = idx.long().clamp(0, R - 1) \
                + torch.arange(N, device=g.device)[:, None] * R
            buf.index_add_(0, flat.reshape(-1), g.reshape(N * P, C).to(acc))
        if buf is not None:
            out[u] = buf.reshape(-1, R, buf.shape[-1]).to(dtype)
    return out


def _check_segment(what: str, t: torch.Tensor, idx: torch.Tensor, dev):
    """Raise unless the kernel takes ``t`` (N, ., C) with ``idx`` (N, P):
    f32 or bf16, int32 or int64 indices, both contiguous and on ``dev``."""
    if t.dtype not in _TABLE_TYPES:
        raise TypeError(f'the kernel takes f32 or bf16 {what}s '
                        f'(got {t.dtype})')
    if idx.dtype not in _IDX_TYPES:
        raise TypeError(f'idx must be int32 or int64 (got {idx.dtype})')
    if t.dim() != 3 or idx.dim() != 2 or idx.shape[0] != t.shape[0]:
        raise ValueError(f'{what} must be (N,.,C) and idx (N,P), got '
                         f'{tuple(t.shape)} and {tuple(idx.shape)}')
    if t.device != dev or idx.device != dev or dev.type != 'cuda':
        raise ValueError(f'{what} on {t.device} and idx on {idx.device}, '
                         f'expected {dev}, a CUDA device')
    if not (t.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f'{what} and idx must be contiguous')


def _launch_grouped(desc: List[int], n: int, N: int, dev):
    lib = LIB.load()
    arr = (ctypes.c_longlong * len(desc))(*desc)
    with on_device(dev):
        err = lib.gather_rows_grouped(arr, n, N, raw_stream(dev))
    check_launch('gather_rows_grouped', err)


def _launch_scatter(desc: List[int], n: int, N: int, flat: torch.Tensor):
    """One call of the adjoint: zero ``flat`` (every table's f32 buffer),
    add the segments of ``desc``, cast the bf16 tables."""
    lib = LIB.load()
    arr = (ctypes.c_longlong * len(desc))(*desc)
    dev = flat.device
    with on_device(dev):
        err = lib.scatter_rows_grouped(arr, n, N, flat.data_ptr(),
                                       flat.numel() * 4, raw_stream(dev))
    check_launch('scatter_rows_grouped', err)


def gather_grouped_cuda(tables: Sequence[torch.Tensor],
                        idxs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch the gather kernel once for all segments."""
    global launches
    if not 1 <= len(tables) <= MAX_SEGMENTS or len(idxs) != len(tables):
        raise ValueError(f'1 to {MAX_SEGMENTS} segments, one idx each (got '
                         f'{len(tables)} tables, {len(idxs)} idx)')
    dev, N = tables[0].device, tables[0].shape[0]
    outs, desc = [], []
    for table, idx in zip(tables, idxs):
        _check_segment('table', table, idx, dev)
        if table.shape[0] != N:
            raise ValueError('the segments of one launch share N')
        _, R, C = table.shape
        P = idx.shape[1]
        out = table.new_empty((N, P, C))
        outs.append(out)
        desc += [table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, P,
                 C * table.element_size(), int(idx.dtype == torch.int64)]
    _launch_grouped(desc, len(tables), N, dev)
    launches += 1
    return outs


def _scatter_desc(grads: Sequence[Optional[torch.Tensor]],
                  idxs: Sequence[torch.Tensor], which: Sequence[int],
                  rows: Sequence[int], dtypes: Sequence[torch.dtype]):
    """Check the adjoint's segments and lay out its buffers: every table's
    f32 buffer is a slice of one allocation, each starting on 16 bytes,
    which the call zeroes; a bf16 table's gradient is a tensor of its own,
    which the call casts into once. Returns (live segments, N, the
    allocation, the gradient of each table or None, the descriptor). The
    host's time here is part of every adjoint's: few tensor operations."""
    live = [s for s, g in enumerate(grads) if g is not None]
    if not 1 <= len(live) <= MAX_SEGMENTS:
        raise ValueError(f'1 to {MAX_SEGMENTS} segments with a gradient '
                         f'(got {len(live)})')
    dev, N = grads[live[0]].device, grads[live[0]].shape[0]
    width = {}
    for s in live:
        g, idx = grads[s], idxs[s]
        _check_segment('gradient', g, idx, dev)
        n, P, C = g.shape
        if n != N or idx.shape[1] != P:
            raise ValueError(f'gradient {tuple(g.shape)} does not match idx '
                             f'{tuple(idx.shape)}, or the segments of one '
                             f'launch differ in N')
        if width.setdefault(which[s], C) != C:
            raise ValueError('the segments of one table share C')
    at, offset = 0, {}
    for u in sorted(width):
        if dtypes[u] not in _TABLE_TYPES:
            raise TypeError(f'the kernel makes f32 or bf16 gradients (got '
                            f'{dtypes[u]})')
        offset[u] = at
        at += -(-N * rows[u] * width[u] // 4) * 4
    flat = torch.empty(at, dtype=torch.float32, device=dev)
    base = flat.data_ptr()
    outs: List[Optional[torch.Tensor]] = [None] * len(rows)
    for u, o in offset.items():
        shape = (N, rows[u], width[u])
        outs[u] = flat[o:o + N * rows[u] * width[u]].view(shape) \
            if dtypes[u] == torch.float32 else \
            torch.empty(shape, dtype=dtypes[u], device=dev)
    desc, cast = [], set()
    for s in live:
        g, idx, u = grads[s], idxs[s], which[s]
        out = 0
        if dtypes[u] != torch.float32 and u not in cast:
            cast.add(u)
            out = outs[u].data_ptr()
        desc += [g.data_ptr(), idx.data_ptr(), base + 4 * offset[u], rows[u],
                 idx.shape[1], width[u], int(g.dtype == torch.bfloat16)
                 | int(idx.dtype == torch.int64) << 1, out,
                 N * rows[u] * width[u]]
    return live, N, flat, outs, desc


def scatter_grouped_cuda(grads: Sequence[Optional[torch.Tensor]],
                         idxs: Sequence[torch.Tensor], which: Sequence[int],
                         rows: Sequence[int], dtypes: Sequence[torch.dtype]
                         ) -> List[Optional[torch.Tensor]]:
    """Call the adjoint once for all segments (arguments as
    ``scatter_grouped_plain``): every table's f32 buffer is a slice of one
    allocation, zeroed by the call, which adds the segments and casts each
    bf16 table once."""
    global backward_launches
    live, N, flat, outs, desc = _scatter_desc(grads, idxs, which, rows,
                                              dtypes)
    _launch_scatter(desc, len(live), N, flat)
    backward_launches += 1
    return outs


class GatherRowsGrouped(torch.autograd.Function):
    """``forward(tables, idxs)`` over the distinct tables ``*uniq`` with
    the gradient ``backward(grads, idxs, which, rows, dtypes)``; segment
    ``s`` gathers ``uniq[which[s]]`` at ``idxs[s]``."""

    @staticmethod
    def forward(ctx, forward, backward, which, idxs, *uniq):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*idxs)
        ctx.which, ctx.scatter = which, backward
        ctx.rows = [t.shape[1] for t in uniq]
        ctx.dtypes = [t.dtype for t in uniq]
        return tuple(forward([uniq[w] for w in which], idxs))

    @staticmethod
    def backward(ctx, *grads):
        live = [g.contiguous() if g is not None and
                ctx.needs_input_grad[4 + w] else None
                for g, w in zip(grads, ctx.which)]
        if all(g is None for g in live):
            return (None,) * (4 + len(ctx.rows))
        out = ctx.scatter(live, list(ctx.saved_tensors), ctx.which, ctx.rows,
                          ctx.dtypes)
        return (None, None, None, None, *out)


def _launchers(device: torch.device):
    """(grouped forward, grouped backward) for tensors on ``device``."""
    if device.type == 'cpu':
        return gather_grouped_plain, scatter_grouped_plain
    if device.type == 'cuda':
        return gather_grouped_cuda, scatter_grouped_cuda
    raise ValueError(f'no row gather kernel for device {device}')


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[n, p] = table[n, clamp(idx[n, p], 0, R - 1)]``: the grouped
    gather of one segment.

    table (N, R, C), idx (N, P) int32 or int64 -> (N, P, C). CPU tensors
    run the plain versions; CUDA tensors launch the kernels, which take f32
    or bf16 contiguous tables. Differentiable in ``table``.
    """
    return gather_rows_grouped([table], [idx])[0]


def gather_rows_grouped(tables: Sequence[torch.Tensor],
                        idxs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[gather_rows(t, i) for t, i in zip(tables, idxs)]`` in one launch,
    and under autograd one launch for all their gradients.

    1 to ``MAX_SEGMENTS`` segments; the tables (N, R_s, C_s) share N and
    the device, and may differ in R, C and type; idx (N, P_s). A table may
    appear in several segments (the same tensor object): its gradient is
    then the sum over them, accumulated in one f32 buffer.
    """
    fwd, bwd = _launchers(tables[0].device)
    if tables[0].device.type == 'cuda':
        idxs = [i.contiguous() for i in idxs]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        uniq: List[torch.Tensor] = []
        which = []
        for t in tables:
            for u, seen in enumerate(uniq):
                if seen is t:
                    which.append(u)
                    break
            else:
                which.append(len(uniq))
                uniq.append(t)
        return list(GatherRowsGrouped.apply(fwd, bwd, which, list(idxs),
                                            *uniq))
    return list(fwd(tables, idxs))


def _corners(x: torch.Tensor, y: torch.Tensor, H: int, W: int, dtype):
    """The four corners of each point, in the order (x0,y0), (x1,y0),
    (x0,y1), (x1,y1): their clamped rows (N, P) int64, in-bounds masks and
    weights cast to ``dtype`` (zero outside the image), as
    ``sample_rows_bilinear_plain`` forms them; and (wx0, wx1, wy0, wy1)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    rows, inbs, ws = [], [], []
    for xi, yi, wgt in ((x0, y0, wx0 * wy0), (x1, y0, wx1 * wy0),
                        (x0, y1, wx0 * wy1), (x1, y1, wx1 * wy1)):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        rows.append(yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        inbs.append(inb)
        ws.append((wgt * inb).to(dtype))
    return rows, inbs, ws, (wx0, wx1, wy0, wy1)


def sample_rows_bilinear_plain(flat: torch.Tensor, x: torch.Tensor,
                               y: torch.Tensor, H: int, W: int,
                               gather=gather_rows) -> torch.Tensor:
    """Plain version of the fused sampler: bilinear sample of the flat
    image ``flat`` (N, H*W, C) at absolute pixel coordinates ``x``, ``y``
    (N, P) f32, zero outside the image. The corner weights are computed in
    f32 and cast to ``flat.dtype`` before they multiply; the four corners
    are fetched by one ``gather`` (``gather_rows``: the row gather with 4 P
    indices) and summed in ``flat.dtype`` in the order (x0,y0), (x1,y0),
    (x0,y1), (x1,y1). Returns (N, P, C)."""
    P = x.shape[1]
    rows, _, ws, _ = _corners(x, y, H, W, flat.dtype)
    vals = gather(flat, torch.cat(rows, dim=1))
    v = [vals[:, k * P:(k + 1) * P] * ws[k][..., None] for k in range(4)]
    return v[0] + v[1] + v[2] + v[3]


def sample_rows_bilinear_backward_plain(grad: torch.Tensor,
                                        flat: torch.Tensor, x: torch.Tensor,
                                        y: torch.Tensor, H: int, W: int,
                                        needs=(True, True, True)):
    """Plain version of the sampler's backward: the vector-Jacobian product
    of ``sample_rows_bilinear_plain`` at ``grad`` (N, P, C) in the image's
    type T, in closed form and without autograd, with autograd's roundings:

    - d flat: each corner's term ``round_T(grad * w_k)`` added at its
      clamped row into a zero f32 buffer (f64 for f64), cast to T
      (``scatter_rows_plain``, the gather's adjoint);
    - d x, d y (the coordinates' type): ``dw_k = round_T(sum_c
      round_T(grad_c * v_kc))`` over corner k's row ``v_k``, masked by
      its in-bounds test, then through the weights ``wx1 = x - floor(x)``,
      ``wx0 = 1 - wx1`` (and the same in y), ``floor`` having no slope.

    ``needs`` says which of (flat, x, y) to return; the rest are None."""
    P = x.shape[1]
    rows, inbs, ws, (wx0, wx1, wy0, wy1) = _corners(x, y, H, W, flat.dtype)
    idx = torch.cat(rows, dim=1)
    dflat = dx = dy = None
    if needs[0]:
        terms = torch.cat([grad * w[..., None] for w in ws], dim=1)
        dflat = scatter_rows_plain(terms, idx, H * W, flat.dtype)
    if needs[1] or needs[2]:
        vals = gather_rows_plain(flat, idx)
        dw = [(grad * vals[:, k * P:(k + 1) * P]).sum(-1).to(x.dtype)
              * inbs[k] for k in range(4)]
        dx = (dw[1] * wy0 + dw[3] * wy1) - (dw[0] * wy0 + dw[2] * wy1)
        dy = (dw[2] * wx0 + dw[3] * wx1) - (dw[0] * wx0 + dw[1] * wx1)
    return dflat, dx if needs[1] else None, dy if needs[2] else None


def _check_sample(flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  H: int, W: int, mask: Optional[torch.Tensor] = None):
    """Raise unless the sampler's kernels take ``flat`` (N, H*W, C) f32 or
    bf16, ``x``, ``y`` (N, P) f32 and ``mask`` (N, P) in the image's type
    or None, all contiguous on one CUDA device."""
    if flat.dtype not in _TABLE_TYPES:
        raise TypeError(f'the kernel takes f32 or bf16 images '
                        f'(got {flat.dtype})')
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f'x and y must be f32 (got {x.dtype}, {y.dtype})')
    if flat.dim() != 3 or flat.shape[1] != H * W or x.dim() != 2 \
            or x.shape != y.shape or x.shape[0] != flat.shape[0]:
        raise ValueError(f'flat must be (N,{H}*{W},C) and x, y (N,P), got '
                         f'{tuple(flat.shape)}, {tuple(x.shape)} and '
                         f'{tuple(y.shape)}')
    dev = flat.device
    if x.device != dev or y.device != dev:
        raise ValueError(f'x on {x.device} and y on {y.device}, expected '
                         f'{dev}')
    if not (flat.is_contiguous() and x.is_contiguous()
            and y.is_contiguous()):
        raise ValueError('flat, x and y must be contiguous')
    if mask is not None and (
            mask.dtype != flat.dtype or mask.shape != x.shape
            or mask.device != dev or not mask.is_contiguous()):
        raise ValueError(f'mask must be a contiguous {tuple(x.shape)} '
                         f'{flat.dtype} tensor on {dev}, got '
                         f'{tuple(mask.shape)} {mask.dtype} on {mask.device}')
    if dev.type != 'cuda':
        raise ValueError(f'the kernel runs on a CUDA device (got {dev})')


def sample_rows_bilinear_cuda(flat: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor, H: int, W: int,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Launch the fused sampler kernel, with ``mask`` its masked
    instance."""
    global sampler_launches, sampler_masked_launches
    _check_sample(flat, x, y, H, W, mask)
    dev = flat.device
    N, _, C = flat.shape
    P = x.shape[1]
    out = flat.new_empty((N, P, C))
    lib = LIB.load()
    args = (flat.data_ptr(), x.data_ptr(), y.data_ptr(),
            0 if mask is None else mask.data_ptr(), out.data_ptr(), N, H, W,
            P, C, int(flat.dtype == torch.bfloat16))
    with on_device(dev):
        err = lib.sample_rows_bilinear(*args, raw_stream(dev))
    check_launch('sample_rows_bilinear', err)
    sampler_launches += 1
    if mask is not None:
        sampler_masked_launches += 1
    return out


def sample_rows_bilinear_backward_cuda(grad: torch.Tensor,
                                       flat: torch.Tensor, x: torch.Tensor,
                                       y: torch.Tensor, H: int, W: int,
                                       needs=(True, True, True)):
    """Launch the sampler's backward kernel (arguments and results as
    ``sample_rows_bilinear_backward_plain``): the image gradient into an f32
    buffer that the call zeroes and casts once to the image's type; dx and
    dy f32."""
    global sampler_backward_launches
    _check_sample(flat, x, y, H, W)
    dev = flat.device
    N, _, C = flat.shape
    P = x.shape[1]
    if grad.dtype != flat.dtype or tuple(grad.shape) != (N, P, C) \
            or grad.device != dev or not grad.is_contiguous():
        raise ValueError(f'grad must be a contiguous ({N},{P},{C}) '
                         f'{flat.dtype} tensor on {dev}, got '
                         f'{tuple(grad.shape)} {grad.dtype} on {grad.device}')
    want_flat, want_xy = bool(needs[0]), bool(needs[1] or needs[2])
    bf16 = flat.dtype == torch.bfloat16
    dtable = dflat = None
    if want_flat:
        dtable = torch.empty((N, H * W, C), dtype=torch.float32, device=dev)
        dflat = torch.empty_like(flat) if bf16 else dtable
    dxy = torch.empty((2, N, P), dtype=torch.float32, device=dev) \
        if want_xy else None
    ptrs = (dtable.data_ptr() if want_flat else 0,
            dflat.data_ptr() if want_flat and bf16 else 0,
            *((dxy[0].data_ptr(), dxy[1].data_ptr()) if want_xy else (0, 0)))
    lib = LIB.load()
    with on_device(dev):
        err = lib.sample_rows_bilinear_backward(
            flat.data_ptr(), grad.data_ptr(), x.data_ptr(), y.data_ptr(),
            *ptrs, N, H, W, P, C, int(bf16), raw_stream(dev))
    check_launch('sample_rows_bilinear_backward', err)
    sampler_backward_launches += 1
    return (dflat, dxy[0] if needs[1] else None,
            dxy[1] if needs[2] else None)


class SampleRowsBilinear(torch.autograd.Function):
    """``forward(flat, x, y, H, W)`` with the gradient
    ``backward(grad, flat, x, y, H, W, needs)``; both are arguments,
    so the plain pair can be checked with ``gradcheck`` in f64. Saves only
    the image and the coordinates."""

    @staticmethod
    def forward(ctx, flat, x, y, H, W, forward, backward):
        ctx.save_for_backward(flat, x, y)
        ctx.hw, ctx.vjp = (H, W), backward
        return forward(flat, x, y, H, W)

    @staticmethod
    def backward(ctx, grad):
        flat, x, y = ctx.saved_tensors
        dflat, dx, dy = ctx.vjp(grad.contiguous(), flat, x, y, *ctx.hw,
                                tuple(ctx.needs_input_grad[:3]))
        return dflat, dx, dy, None, None, None, None


def _sample_plain(flat, x, y, H, W, mask=None):
    """The plain sampler; with ``mask`` (N, P), then its product."""
    out = sample_rows_bilinear_plain(flat, x, y, H, W,
                                     gather=gather_rows_plain)
    return out if mask is None else out * mask[..., None]


def _sampler_launchers(device: torch.device):
    """(forward, backward) of the sampler for tensors on ``device``."""
    if device.type == 'cpu':
        return _sample_plain, sample_rows_bilinear_backward_plain
    if device.type == 'cuda':
        return sample_rows_bilinear_cuda, sample_rows_bilinear_backward_cuda
    raise ValueError(f'no sampler kernel for device {device}')


def sample_rows_bilinear(flat: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, H: int, W: int,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Zero-padded bilinear sample of the flat image ``flat`` (N, H*W, C),
    contiguous, at ``x``, ``y`` (N, P) f32 -> (N, P, C).

    CUDA tensors launch the fused kernel, which equals the plain
    composition bit for bit; where autograd records (the image or a
    coordinate requires a gradient) the backward is one launch of the
    sampler's backward kernel. CPU tensors run the plain composition and
    the closed-form backward.

    With ``mask`` (N, P) in the image's type, each point's sample times its
    value, equal bit for bit to the sample times ``mask[..., None]``, in
    the same one launch. The masked sample has no backward: it raises
    where autograd would record it."""
    fwd, bwd = _sampler_launchers(flat.device)
    if flat.device.type == 'cuda':
        x, y = x.contiguous(), y.contiguous()
    records = torch.is_grad_enabled() and (
        flat.requires_grad or x.requires_grad or y.requires_grad)
    if mask is not None:
        if records or (torch.is_grad_enabled() and mask.requires_grad):
            raise RuntimeError('the masked sample has no backward: sample '
                               'unmasked and multiply where autograd '
                               'records')
        if flat.device.type == 'cuda':
            mask = mask.contiguous()
        return fwd(flat, x, y, H, W, mask)
    if records:
        return SampleRowsBilinear.apply(flat, x, y, H, W, fwd, bwd)
    return fwd(flat, x, y, H, W)
