"""Building blocks shared by the DAS model family, port of
``das_tpu/models/layers.py``.

Modules work on NCHW tensors (``channels_last`` memory on the card). Their
parameter names are the reference's torch key names: a ``ConvModule`` holds
``conv`` and ``bn`` or ``gn``; a ``DeformConv2d`` holds ``weight``,
``bias`` and ``conv_offset``.

Types follow the JAX modules, which compute in the model dtype with f32
parameters. A serving model casts its conv weights to the compute dtype
(``cast_compute``); a trainable one keeps f32 master weights and casts them
at each call (``keep_master_weights``). Either way a conv computes in
``compute_dtype(conv)``; norms take their statistics and affine in f32 and
return the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import conv_gn
from ..ops.deform_conv import modulated_deform_conv


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Fill ``t`` from N(0, std^2) drawn from ``gen`` (on the CPU)."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def lecun_normal_(t: torch.Tensor, gen: torch.Generator):
    """Normal with std 1/sqrt(fan_in), flax's default kernel init."""
    fan_in = t[0].numel()
    normal_(t, 1.0 / math.sqrt(fan_in), gen)


def he_normal_(t: torch.Tensor, gen: torch.Generator):
    """Normal with std sqrt(2/fan_in)."""
    fan_in = t[0].numel()
    normal_(t, math.sqrt(2.0 / fan_in), gen)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of f32 NCHW ``x`` with its moments over every
    rank of ``group``: the global batch's, as the JAX step's SPMD BatchNorm
    takes them. Returns (y, mean, biased var).

    Forward: one all-reduce of the per-channel sums and the count (the
    global mean), one of the sums of squared deviations from it (the
    variance, two passes as on one card). Backward: one all-reduce of the
    concatenated per-channel ``[sum g, sum g * xhat]``, then the global
    batch's input gradient; the weight's and bias's gradients stay this
    rank's sums, which the step's gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, group):
        dims = (0, 2, 3)
        s = torch.cat([x.sum(dims), x.new_full((1,), x.numel() / x.shape[1])])
        dist.all_reduce(s, group=group)
        count = s[-1]
        mean = s[:-1] / count
        d = x - mean[:, None, None]
        sq = (d * d).sum(dims)
        dist.all_reduce(sq, group=group)
        var = sq / count
        invstd = torch.rsqrt(var + 1e-5)
        xhat = d * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight[:, None, None] + bias[:, None, None], mean, var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        xhat, weight, invstd, count = ctx.saved_tensors
        dims = (0, 2, 3)
        g_sum, gx_sum = gy.sum(dims), (gy * xhat).sum(dims)
        tot = torch.cat([g_sum, gx_sum])
        dist.all_reduce(tot, group=ctx.group)
        g_mean, gx_mean = (tot / count).chunk(2)
        dx = (weight * invstd)[:, None, None] * (
            gy - g_mean[:, None, None] - xhat * gx_mean[:, None, None])
        return dx, gx_sum, g_sum, None


class BatchNorm(nn.Module):
    """BatchNorm (BN and SyncBN alike), eps 1e-5, f32 math. Eval
    normalises with the running statistics. Training normalises with the
    batch's and updates the running ones as flax does (``momentum=0.9``):
    ``running = 0.9 running + 0.1 batch``, with the biased batch variance.
    With a process group (``group``, which ``parallel.replicate`` sets) the
    training moments are the global batch's, over every rank, as SyncBN's;
    without one, this process's batch's. Its keys are those the reference
    checkpoints carry, less ``num_batches_tracked``.

    ``recomputing`` (set by ``remat`` while it recomputes a region in the
    backward) skips the running update: the forward already made it."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.group = None
        self.recomputing = False

    def _update(self, mean: torch.Tensor, var: torch.Tensor):
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                1e-5).to(x.dtype)
        if self.group is not None:
            y, mean, var = _GlobalBatchNorm.apply(xf, self.weight,
                                                  self.bias, self.group)
            if not self.recomputing:
                self._update(mean, var)
            return y.to(x.dtype)
        # no running buffers here: F.batch_norm would update them with the
        # unbiased variance
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                         1e-5)
        if not self.recomputing:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
                self._update(mean, var)
        return y.to(x.dtype)


def remat(module: nn.Module, fn, *args):
    """``fn(*args)`` (a forward of ``module``) as one rematerialised region,
    JAX's ``nn.remat``: where autograd records, its activations are dropped
    after the forward and recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant); elsewhere it is a plain
    call. The backward graph is the one a plain call records, so losses,
    gradients and outputs are the same bits.

    The recompute runs ``module``'s train-mode BatchNorms again with
    ``recomputing`` set, so the running statistics take one update a step,
    bit for bit as without remat. With a process group each of them
    all-reduces its moments again (``_GlobalBatchNorm``): the collectives
    stay matched because every rank recomputes the same regions in the
    same order. Kernel launch counts include the recompute's."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.recomputing = True
        try:
            return fn(*a)
        finally:
            for m in norms:
                m.recomputing = False
    # no region draws random numbers: no RNG state to keep for the recompute
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class GroupNorm(nn.Module):
    """GroupNorm over contiguous channel groups, eps 1e-5, f32 math."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, 1e-5).to(x.dtype)


def make_norm(norm_cfg: Optional[dict], channels: int):
    """(name, module) for an mmcv-style norm_cfg: BN/SyncBN -> 'bn',
    GN -> 'gn'; (None, None) without a norm."""
    if norm_cfg is None:
        return None, None
    kind = norm_cfg if isinstance(norm_cfg, str) else norm_cfg['type']
    if kind in ('BN', 'SyncBN'):
        return 'bn', BatchNorm(channels)
    if kind == 'GN':
        groups = 32 if isinstance(norm_cfg, str) \
            else norm_cfg.get('num_groups', 32)
        return 'gn', GroupNorm(groups, channels)
    raise ValueError(f'unsupported norm type {kind}')


def compute_dtype(conv: nn.Module) -> torch.dtype:
    """The dtype a conv (or deform conv) computes in: the one
    ``keep_master_weights`` set, else its weights'."""
    return getattr(conv, 'compute_dtype', conv.weight.dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Run ``conv`` in its compute dtype, as flax casts its input and its
    f32 parameters."""
    dt = compute_dtype(conv)
    if conv.weight.dtype == dt:
        return conv(x.to(dt))
    bias = None if conv.bias is None else conv.bias.to(dt)
    return conv._conv_forward(x.to(dt), conv.weight.to(dt), bias)


class DeformConv2d(nn.Module):
    """DCNv2 pack layer: zero-init offset conv + modulated deform conv.

    ``weight`` is (Cout, Cin, K, K) like the reference's; the deform conv
    itself runs in NHWC with the (K, K, Cin, Cout) kernel. Under training
    the lowering is the JAX module's: an explicit ``train_gather_mode``
    wins, else ``'patch'`` -> ``'clip'``, ``'shift_pallas'`` -> ``'shift'``,
    ``'hybrid_pallas'`` -> ``'hybrid'``. On the card ``'shift'`` and
    ``'hybrid'`` run the kernel K1 forward and backward
    (``ops/dcn_shift.py``), on the CPU the plain shift expansion.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1,
                 use_bias: bool = True, gather_mode: str = 'patch',
                 shift_radius: int = 2, shift_budget: int = 2048,
                 train_gather_mode: str = 'auto'):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.padding = padding
        self.gather_mode = gather_mode
        self.train_gather_mode = train_gather_mode
        self.shift_radius = shift_radius
        self.shift_budget = shift_budget
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) \
            if use_bias else None
        self.conv_offset = nn.Conv2d(in_channels, 3 * k * k, k,
                                     padding=padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def lowering(self) -> str:
        """The gather mode this call runs (JAX layers.py:111-119)."""
        if not self.training:
            return self.gather_mode
        if self.train_gather_mode != 'auto':
            return self.train_gather_mode
        return {'patch': 'clip', 'shift_pallas': 'shift',
                'hybrid_pallas': 'hybrid'}.get(self.gather_mode,
                                               self.gather_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.kernel_size ** 2
        dt = compute_dtype(self)
        x = x.to(dt)
        raw = conv2d(self.conv_offset, x).permute(0, 2, 3, 1)   # NHWC
        offset = raw[..., :2 * kk]
        mask = torch.sigmoid(raw[..., 2 * kk:])
        out = modulated_deform_conv(
            x.permute(0, 2, 3, 1).contiguous(), offset, mask,
            self.weight.to(dt).permute(2, 3, 1, 0),
            None if self.bias is None else self.bias.to(dt),
            kernel_size=self.kernel_size, padding=self.padding,
            gather_mode=self.lowering(), shift_radius=self.shift_radius,
            shift_budget=self.shift_budget)
        return out.permute(0, 3, 1, 2)


class ConvModule(nn.Module):
    """conv -> norm -> act, matching mmcv ConvModule defaults.

    ``bias='auto'`` means bias iff there is no norm (mmcv behaviour).
    ``dcn=True`` makes the conv a ``DeformConv2d`` (3x3, stride 1).
    ``fused_gn=True`` runs an eval 3x3/s1/p1 bias-free conv+GN+relu as one
    ``ops.conv_gn.conv_gn_relu`` call (the JAX module's ``_use_fused_gn``
    gate, condition for condition); the parameters, and so the state dict,
    are those of the unfused module. ``remat=True`` makes each training
    call one rematerialised region (``remat``), as the JAX head wraps each
    of its ``ConvModule``s in ``nn.remat``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 bias: Union[str, bool] = 'auto',
                 norm_cfg: Optional[dict] = None, act: Optional[str] = 'relu',
                 dcn: bool = False, dcn_gather_mode: str = 'patch',
                 dcn_shift_radius: int = 2, dcn_shift_budget: int = 2048,
                 fused_gn: bool = False, dcn_train_gather_mode: str = 'auto',
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        use_bias = (norm_cfg is None) if bias == 'auto' else bool(bias)
        if act not in (None, 'relu'):
            raise ValueError(f'unsupported act {act}')
        self.act = act
        self.fused_gn = fused_gn
        if dcn:
            assert stride == 1
            self.conv = DeformConv2d(in_channels, out_channels, kernel_size,
                                     padding, use_bias, dcn_gather_mode,
                                     dcn_shift_radius, dcn_shift_budget,
                                     dcn_train_gather_mode)
        else:
            self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                                  stride, padding, bias=use_bias)
        name, norm = make_norm(norm_cfg, out_channels)
        self.norm_name = name
        if norm is not None:
            self.add_module(name, norm)

    def use_fused_gn(self) -> bool:
        """The JAX module's ``_use_fused_gn`` gate: eval, not DCN, no bias,
        3x3, stride 1, padding 1, relu, GN."""
        conv = self.conv
        return (self.fused_gn and not self.training
                and not isinstance(conv, DeformConv2d) and conv.bias is None
                and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
                and conv.padding == (1, 1) and self.act == 'relu'
                and self.norm_name == 'gn')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training:
            return remat(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused_gn():
            dt = compute_dtype(self.conv)
            out = conv_gn.conv_gn_relu(
                x.to(dt).permute(0, 2, 3, 1).contiguous(),
                self.conv.weight.to(dt).permute(2, 3, 1, 0), self.gn.weight,
                self.gn.bias,
                groups=self.gn.num_groups)
            return out.permute(0, 3, 1, 2)
        if isinstance(self.conv, DeformConv2d):
            x = self.conv(x)
        else:
            x = conv2d(self.conv, x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        if self.act == 'relu':
            x = F.relu(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (ref: mmcv Scale at das_head.py:171).
    The product is f32, as the JAX module's f32 parameter promotes it."""

    def __init__(self, init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() * self.scale


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1), NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


def cast_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of a serving model: every conv's (and deform
    conv's) weight and bias take ``dtype``; norms, ``Scale`` and the flows
    stay f32, as the JAX modules keep f32 parameters and compute norms in
    f32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, DeformConv2d)):
            for name, p in m.named_parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def keep_master_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of a trainable model: every parameter stays
    f32 (SGD on bf16 weights would lose the updates) and each conv casts its
    weight and bias to ``dtype`` at the call, as flax's ``dtype`` against
    ``param_dtype``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, DeformConv2d)):
            m.compute_dtype = dtype
    return model
