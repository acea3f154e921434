"""DCNv2 shift-expansion kernel (CUDA, sm_90a), its backward, and their
plain versions.

Counterpart of ``das_tpu/ops/pallas_dcn.py::deform_conv_shift_pallas``.
``deform_conv_shift`` computes the same function as that kernel: NHWC,
K=3, pad 1, stride 1, one deform group. Each tap's (dy, dx) offset is
clamped to ``[-radius, radius]``, the tap is the hat-weighted sum of the
zero-padded input over the ``(2r+2)^2`` integer window, it is scaled by the
mask and contracted with ``W_k``; the nine contractions accumulate in f32,
the sum is cast to ``x.dtype`` and the bias is added in ``x.dtype``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``das_tpu_torch/csrc/dcn_shift.cu``) or raises. On a CPU tensor it runs
the plain PyTorch version, ``deform_conv_shift_plain``. The kernel is built
with ``nvcc`` at first use into ``build/das_tpu_torch/`` and loaded with
``ctypes`` (``ops/cuda_build.py``).

The source holds three forward passes. bf16 with Cin and Cout multiples of
64 and 16-byte aligned x and weight (the model's layers) takes the
``wgmma`` pass: x's halo'd patch staged in shared memory by TMA, the tap
tile built there, the product on ``wgmma`` with the weight fed by TMA. Other
bf16 shapes take the WMMA pass, f32 true FMAs. Which pass a call takes is
decided by its shapes alone; a pass that fails raises, none gives way to
another. ``launches`` counts every forward launch, ``wgmma_launches`` those
of the ``wgmma`` pass.

Under autograd the wrapper is ``DeformConvShift``, whose backward is
``deform_conv_shift_backward_cuda`` on the card (``backward_launches``
counts its calls) and the closed form ``deform_conv_shift_backward_plain``
on the CPU. The card's backward launches a tap kernel and a dx kernel.
bf16 with Cin a multiple of 64 and 16-byte aligned x, U, tile and dx (the
model's layers) takes the tiled pass, whose tap kernel stages x's patch and
U in shared memory by TMA; other shapes take the lane pass's tap kernel.
Both passes share the dx kernel. As in the forward, the shapes alone
decide and a pass that fails raises; ``backward_tiled_launches`` counts
the calls for which the library reports the tiled tap kernel. The JAX package trains this function through XLA's autodiff of
its shift expansion (``das_tpu/ops/deform_conv.py:111``); both backwards
give that gradient, with JAX's conventions where the hat weights and the
clamp have kinks (``hat``, ``clamp_offset``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .cuda_build import (INT, PTR, CudaLibrary, check_launch, check_tensor,
                         on_device, raw_stream)

LIB = CudaLibrary('dcn_shift.cu', {
    'dcn_shift_takes_wgmma': [INT] * 4,
    'dcn_shift_forward': [PTR] * 6 + [INT] * 7 + [PTR],
    'dcn_shift_forward_pass': [PTR] * 6 + [INT] * 8 + [PTR],
    'dcn_shift_backward': [PTR] * 8 + [INT] * 6 + [PTR] * 2,
    'dcn_shift_backward_pass': [PTR] * 8 + [INT] * 7 + [PTR] * 2})

# Kernel launches since the last reset: forward, those of them that took the
# wgmma pass, backward calls (each launches a tap kernel, the dx kernel or
# both) and those of them that launched the tiled tap kernel; the main
# path's run reads them.
launches = 0
wgmma_launches = 0
backward_launches = 0
backward_tiled_launches = 0


def hat(t: torch.Tensor) -> torch.Tensor:
    """``max(0, 1 - |t|)``, bit for bit, with the derivative JAX's autodiff
    gives it: -1 at t = 0 (JAX's |t|' is +1 there), -0.5 at t = 1 and +0.5
    at t = -1 (JAX's max passes half of the gradient at a tie)."""
    u = 1.0 - torch.where(t >= 0, t, -t)
    return 0.5 * (u + u.abs())


def clamp_offset(off: torch.Tensor, radius: float) -> torch.Tensor:
    """``off`` clamped to ``[-radius, radius]`` with ``jnp.clip``'s
    derivative: 1 inside, 0.5 at exactly +-radius, 0 beyond."""
    r = torch.full((), radius, dtype=off.dtype, device=off.device)
    return torch.minimum(torch.maximum(off, -r), r)


def hat_slope(t: torch.Tensor) -> torch.Tensor:
    """d hat(i - d) / d d at ``t = i - d``, JAX's value at the kinks: +1 for
    0 <= t < 1, -1 for -1 < t < 0, +0.5 at t = 1, -0.5 at t = -1, 0 beyond
    (the derivative of ``hat`` above, negated)."""
    a = t.abs()
    mag = torch.where(a < 1, 1.0, torch.where(a == 1, 0.5, 0.0))
    return torch.where(t >= 0, mag, -mag)


def clamp_slope(off: torch.Tensor, radius: float) -> torch.Tensor:
    """The derivative of ``clamp_offset``."""
    a = off.abs()
    return torch.where(a < radius, 1.0, torch.where(a == radius, 0.5, 0.0))


def deform_conv_shift_plain(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor], K: int = 3,
                            padding: int = 1, radius: int = 1
                            ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the Pallas kernel's semantics).

    Per tap: the window sum accumulates in ``x.dtype``, is scaled by the
    mask in ``x.dtype`` and contracted with f32 accumulation across taps
    (bf16 products are exact in f32). Shapes as ``deform_conv_shift``.
    """
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    P = padding + radius + 1
    dt = x.dtype
    xp = torch.nn.functional.pad(x, (0, 0, P, P, P, P))
    off = offset.float()
    m = mask.to(dt)
    w = weight.to(dt).reshape(K * K, Cin, Cout).float()
    r = float(radius)
    out = torch.zeros((N * H * W, Cout), dtype=torch.float32,
                      device=x.device)
    for k in range(K * K):
        kh, kw = divmod(k, K)
        dy = clamp_offset(off[..., 2 * k], r)[..., None] + (kh - padding)
        dx = clamp_offset(off[..., 2 * k + 1], r)[..., None] + (kw - padding)
        acc = torch.zeros((N, H, W, Cin), dtype=dt, device=x.device)
        for iy in range(kh - padding - radius, kh - padding + radius + 2):
            wy = hat(iy - dy)
            for ix in range(kw - padding - radius,
                            kw - padding + radius + 2):
                wgt = wy * hat(ix - dx)
                acc = acc + xp[:, iy + P:iy + P + H, ix + P:ix + P + W] \
                    * wgt.to(dt)
        acc = acc * m[..., k:k + 1]
        out = out + acc.reshape(-1, Cin).float() @ w[k]
    out = out.reshape(N, H, W, Cout).to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out


Grads = Tuple[Optional[torch.Tensor], ...]
ALL = (True,) * 5


def deform_conv_shift_backward_plain(x: torch.Tensor, offset: torch.Tensor,
                                     mask: torch.Tensor,
                                     weight: torch.Tensor,
                                     grad_out: torch.Tensor, radius: int = 1,
                                     needs: Sequence[bool] = ALL, K: int = 3,
                                     padding: int = 1) -> Grads:
    """The gradient of ``deform_conv_shift_plain`` in closed form (no
    autograd): (dx, doffset, dmask, dweight, dbias), each None where
    ``needs`` (x, offset, mask, weight, bias) says so.

    x (N,H,W,Cin), mask (N,H,W,K*K), weight (K,K,Cin,Cout) and grad_out
    (N,H,W,Cout) share one type; offset is f32. Per tap k, with T_k the tap
    tile (the window sum, rounded as the forward rounds it), A_k = m_k T_k
    and G the output gradient:

    * U_k = G W_k^T, all taps in one product (P x 9 Cin, in x's type);
    * dW_k = A_k^T G, all taps in one product (in x's type);
    * dmask_k = sum_c U_k T_k;
    * doffset_k = m_k clamp'(o) sum_c U_k dT_k/d(dy, dx), where dT_k/ddy
      sums hat_slope(iy - dy) hat(ix - dx) x over the window, and so on;
    * dx collects hat hat m_k U_k from every pixel whose window holds it;
    * dbias = sum of G over the pixels.

    The reductions and dx are taken in f32; dx, dmask, dweight and dbias are
    returned in x's type, doffset in f32.
    """
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    P = padding + radius + 1
    dt = x.dtype
    need_x, need_off, need_mask, need_w, need_b = needs
    g = grad_out.to(dt).reshape(-1, Cout)
    xp = torch.nn.functional.pad(x, (0, 0, P, P, P, P))
    off = offset.float()
    m = mask.to(dt)
    r = float(radius)
    u = (g @ weight.to(dt).reshape(K * K * Cin, Cout).t()).float() \
        .reshape(N, H, W, K * K, Cin)
    tile = torch.empty((N, H, W, K * K, Cin), dtype=dt, device=x.device)
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    doff = torch.zeros((N, H, W, 2 * K * K), device=x.device)
    dmask = torch.zeros((N, H, W, K * K), device=x.device)
    for k in range(K * K):
        kh, kw = divmod(k, K)
        oy, ox = off[..., 2 * k], off[..., 2 * k + 1]
        dy = clamp_offset(oy, r)[..., None] + (kh - padding)
        dx = clamp_offset(ox, r)[..., None] + (kw - padding)
        mk = m[..., k:k + 1]
        uk = u[..., k, :]
        acc = torch.zeros((N, H, W, Cin), dtype=dt, device=x.device)
        sy = torch.zeros((N, H, W, Cin), device=x.device)
        sx = torch.zeros((N, H, W, Cin), device=x.device)
        for iy in range(kh - padding - radius, kh - padding + radius + 2):
            wy, swy = hat(iy - dy), hat_slope(iy - dy)
            for ix in range(kw - padding - radius,
                            kw - padding + radius + 2):
                wx, swx = hat(ix - dx), hat_slope(ix - dx)
                win = (slice(None), slice(iy + P, iy + P + H),
                       slice(ix + P, ix + P + W))
                acc = acc + xp[win] * (wy * wx).to(dt)
                xs = xp[win].float()
                sy = sy + (swy * wx) * xs
                sx = sx + (wy * swx) * xs
                if need_x:
                    dxp[win] += (wy * wx * mk.float()) * uk
        tile[..., k, :] = acc * mk
        t = acc.float()
        dmask[..., k] = (uk * t).sum(-1)
        mf = mk[..., 0].float()
        doff[..., 2 * k] = mf * clamp_slope(oy, r) * (uk * sy).sum(-1)
        doff[..., 2 * k + 1] = mf * clamp_slope(ox, r) * (uk * sx).sum(-1)
    dw = (tile.reshape(-1, K * K * Cin).t() @ g).reshape(K, K, Cin, Cout)
    return (dxp[:, P:P + H, P:P + W].to(dt) if need_x else None,
            doff if need_off else None,
            dmask.to(dt) if need_mask else None,
            dw if need_w else None,
            g.float().sum(0).to(dt) if need_b else None)


def _check_geometry(K: int, padding: int, radius: int):
    if K != 3 or padding != 1:
        raise ValueError(f'the kernel takes K=3, padding=1 (got K={K}, '
                         f'padding={padding})')
    if radius not in (1, 2):
        raise ValueError(f'the kernel takes radius 1 or 2 (got {radius})')


def deform_conv_shift_cuda(x: torch.Tensor, offset: torch.Tensor,
                           mask: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor], K: int = 3,
                           padding: int = 1, radius: int = 1
                           ) -> torch.Tensor:
    """Launch the forward kernel on tensors the wrapper has checked and
    cast (offset f32; x, mask, weight, bias in one type; contiguous)."""
    global launches, wgmma_launches
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    out = torch.empty((N, H, W, Cout), dtype=dt, device=dev)
    lib = LIB.load()
    is_bf16 = int(dt == torch.bfloat16)
    aligned = int((x.data_ptr() | weight.data_ptr()) % 16 == 0)
    wgmma = lib.dcn_shift_takes_wgmma(Cin, Cout, is_bf16, aligned)
    with on_device(dev):
        stream = raw_stream(dev)
        err = lib.dcn_shift_forward(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), N, H, W, Cin, Cout, radius, is_bf16, stream)
    check_launch('dcn_shift', err)
    launches += 1
    wgmma_launches += wgmma
    return out


def deform_conv_shift_backward_cuda(x: torch.Tensor, offset: torch.Tensor,
                                    mask: torch.Tensor, weight: torch.Tensor,
                                    grad_out: torch.Tensor, radius: int = 1,
                                    needs: Sequence[bool] = ALL, K: int = 3,
                                    padding: int = 1) -> Grads:
    """The backward on the card, on the tensors the forward was given:
    what ``deform_conv_shift_backward_plain`` returns.

    U = G W^T and dW = A^T G are plain large matrix products outside any
    kernel (``torch.matmul``; the JAX package leaves them to XLA as the
    transpose of its einsum), dbias a sum over the pixels. One call of the
    library launches the hand-written rest: the tap kernel (the tap tile A,
    dmask and doffset from U, with the hat's and the clamp's slopes) and the
    dx kernel (the transpose of the shift as a gather: no atomics). T is
    recomputed from x here; the forward keeps no tile.
    """
    global backward_launches, backward_tiled_launches
    _check_geometry(K, padding, radius)
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    need_x, need_off, need_mask, need_w, need_b = needs
    g = grad_out.to(dt).contiguous()
    check_tensor('grad_out', g, (N, H, W, Cout), dt, dev)
    g2 = g.reshape(-1, Cout)
    u = tile = doff = dmask = dx = None
    if need_x or need_off or need_mask:
        u = g2 @ weight.reshape(9 * Cin, Cout).t()          # (P, 9 Cin)
    if need_w:
        tile = torch.empty((N * H * W, 9 * Cin), dtype=dt, device=dev)
    if need_off:
        doff = torch.empty((N, H, W, 18), dtype=torch.float32, device=dev)
    if need_mask:
        dmask = torch.empty((N, H, W, 9), dtype=dt, device=dev)
    if need_x:
        dx = torch.empty_like(x)
    if u is not None or tile is not None:
        ptr = [None if t is None else t.data_ptr()
               for t in (u, tile, doff, dmask, dx)]
        tiled = ctypes.c_int(0)     # the library's report of its tap kernel
        with on_device(dev):
            stream = raw_stream(dev)
            err = LIB.load().dcn_shift_backward(
                x.data_ptr(), offset.data_ptr(), mask.data_ptr(), *ptr,
                N, H, W, Cin, radius, int(dt == torch.bfloat16),
                ctypes.byref(tiled), stream)
        check_launch('dcn_shift backward', err)
        backward_launches += 1
        backward_tiled_launches += tiled.value
    dw = (tile.t() @ g2).reshape(3, 3, Cin, Cout) if need_w else None
    db = g2.float().sum(0).to(dt) if need_b else None
    return dx, doff, dmask, dw, db


class DeformConvShift(torch.autograd.Function):
    """``forward(x, offset, mask, weight, bias, geometry, forward,
    backward)``: ``forward(x, offset, mask, weight, bias, *geometry)`` with
    the gradient ``backward(x, offset, mask, weight, grad, radius, needs,
    K, padding)``; geometry is (K, padding, radius). Saves the four inputs
    and nothing else."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, geometry, forward,
                backward):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.geometry, ctx.backward = geometry, backward
        return forward(x, offset, mask, weight, bias, *geometry)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:5]
        if not any(needs):
            return (None,) * 8
        K, padding, radius = ctx.geometry
        grads = ctx.backward(*ctx.saved_tensors, grad, radius, needs, K,
                             padding)
        return (*grads, None, None, None)


def _pair(device: torch.device):
    """(forward, backward) for tensors on ``device``."""
    if device.type == 'cpu':
        return deform_conv_shift_plain, deform_conv_shift_backward_plain
    if device.type == 'cuda':
        return deform_conv_shift_cuda, deform_conv_shift_backward_cuda
    raise ValueError(f'no DCN shift kernel for device {device}')


def deform_conv_shift(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], K: int = 3,
                      padding: int = 1, radius: int = 1) -> torch.Tensor:
    """DCNv2 shift expansion.

    Args: x (N,H,W,Cin) NHWC; offset (N,H,W,2*K*K) per-tap (dy, dx); mask
    (N,H,W,K*K) already sigmoided; weight (K,K,Cin,Cout); bias (Cout,) or
    None. Returns (N,H,W,Cout) in ``x.dtype``. Differentiable in all five.

    CPU tensors run ``deform_conv_shift_plain`` and, under autograd, the
    closed-form backward; CUDA tensors launch the kernels, which take K=3,
    padding=1, radius 1 or 2, x in f32 or bf16 and a contiguous x. As the
    TPU wrapper does, offset is read as f32 and mask, weight and bias in
    ``x.dtype`` (casts that autograd sees, outside the kernels).
    """
    forward, backward = _pair(x.device)
    dt = x.dtype
    if x.device.type == 'cuda':
        _check_geometry(K, padding, radius)
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f'the kernel takes f32 or bf16 x (got {dt})')
        if x.dim() != 4:
            raise ValueError(f'x must be (N,H,W,Cin), got {tuple(x.shape)}')
        N, H, W, Cin = x.shape
        Cout = weight.shape[-1]
        dev = x.device
        check_tensor('x', x, (N, H, W, Cin), dt, dev)
        offset = offset.to(torch.float32).contiguous()
        mask = mask.to(dt).contiguous()
        weight = weight.to(dt).contiguous()
        check_tensor('offset', offset, (N, H, W, 18), torch.float32, dev)
        check_tensor('mask', mask, (N, H, W, 9), dt, dev)
        check_tensor('weight', weight, (3, 3, Cin, Cout), dt, dev)
        if bias is not None:
            bias = bias.to(dt).contiguous()
            check_tensor('bias', bias, (Cout,), dt, dev)
    else:
        offset, mask, weight = offset.float(), mask.to(dt), weight.to(dt)
        bias = None if bias is None else bias.to(dt)
    args = (x, offset, mask, weight, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return DeformConvShift.apply(*args, (K, padding, radius), forward,
                                     backward)
    return forward(*args, K, padding, radius)
