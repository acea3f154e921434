"""CUDA graphs over fixed-shape regions of an eval forward.

A region is a function of a module's call that launches the same kernels
at every call of one shape: the head's trunk at one level, the recursive
update's body. ``Graphs`` keeps the regions of one module, by key: the
region's own arguments (a tensor by shape, dtype, strides and device,
anything else by value) and whether inference mode is on.

- The first call at a key runs eagerly, so a shape seen once (a single
  image's ``inference_detector``) never captures. The second runs the
  region eagerly on a side stream (the warm-up capture needs; its outputs
  are the call's) and captures it into a ``torch.cuda.CUDAGraph``. Later
  calls copy their tensor arguments into the graph's static ones and
  replay: the same kernels, hand-written ones included, in the same
  order and types.
- A module's graphs share one memory pool. A graph's outputs are its
  static tensors, which the next replay at that key overwrites: the caller
  consumes them, or asks for copies (``fresh``), before it replays again.
  The head's trunk and the recursive update keep a pool each, so that
  the trunk's outputs, which live across the update's replay, never share
  memory with the update's temporaries, whatever order the two were
  captured in.
- A replay reads the parameters at the addresses its capture saw. The
  cache is dropped when any of them moved (``cast_compute``, ``.to()``, a
  rebound ``.data``), or a DCN's lowering changed; ``load_state_dict``
  copies in place, so a replay reads the new values.
- ``launches``-style counters of the hand kernels (``ops/gather.py``,
  ``ops/dcn_shift.py``, ``ops/conv_gn.py``) advance on each replay by what
  the capture launched, and not at the capture, which runs nothing: every
  call counts the kernels it runs, one run's worth.

A call runs eagerly, exactly as without graphs, unless the tensors are on
a CUDA device, the owner is in eval mode, grad is off, no module in the
region has a forward hook or pre-hook (nor is a global one registered)
and every DCN in it takes a lowering without a host sync (not
``'hybrid*'``, whose repair tests its flag on the host): ``gate`` names
the first condition that fails. A hooked module is so always called. No
graph is captured while a profiler records (the trace would hold launches
that never ran); one captured before replays. A replay runs the kernels
its capture launched: a launcher swapped in afterwards is not called
(``Graphs.drop`` starts over).

``captures``, ``replays`` and ``eager`` count a region's calls by kind
since the process started.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.nn.modules import module as _module

from ..ops import bn_act, conv_gn, dcn_shift, gather, window_attn
from .layers import DeformConv2d

captures: Counter = Counter()
replays: Counter = Counter()
eager: Counter = Counter()

LIMIT = 16          # captured keys a module keeps; further keys run eagerly
HOST_SYNC = ('hybrid', 'hybrid_pallas')
# the hand kernels' launch counters that a replay advances
KERNEL_COUNTERS = ((gather, 'launches'), (gather, 'sampler_launches'),
                   (gather, 'sampler_masked_launches'),
                   (dcn_shift, 'launches'), (dcn_shift, 'wgmma_launches'),
                   (conv_gn, 'launches'), (bn_act, 'launches'),
                   (window_attn, 'launches'), (window_attn, 'pairs'))


def _scan(modules: Sequence[nn.Module]) -> Tuple[Optional[str], tuple]:
    """(a reason the region must run eagerly found in its modules, or
    None; the addresses of their parameters and the DCNs' lowerings, which
    the graphs hold to) in one pass."""
    why = None
    if _module._global_forward_hooks or _module._global_forward_pre_hooks:
        why = 'hook'
    state = []
    for m in modules:
        if why is None and (m._forward_hooks or m._forward_pre_hooks):
            why = 'hook'
        if isinstance(m, DeformConv2d):
            state.append(m.lowering())
            if why is None and state[-1] in HOST_SYNC:
                why = 'host sync'
        for p in m._parameters.values():
            if p is not None:
                state.append(p.data_ptr())
    return why, tuple(state)


def gate(owner: nn.Module, modules: Sequence[nn.Module], args: Sequence
         ) -> Tuple[Optional[str], Optional[tuple]]:
    """Why a call of a region of ``owner`` over ``modules`` with ``args``
    runs eagerly: 'training', 'grad', 'hook', 'host sync' or 'device', the
    first that holds, or None where it may be graphed; and ``_scan``'s
    state of the modules, where the gate got to them."""
    if owner.training:
        return 'training', None
    if torch.is_grad_enabled():
        return 'grad', None
    why, state = _scan(modules)
    if why is None and not all(
            a.is_cuda for a in args if isinstance(a, torch.Tensor)):
        why = 'device'
    return why, state


def _signature(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype, a.stride(), a.device)
    return a


def _counts() -> List[int]:
    return [getattr(m, n) for m, n in KERNEL_COUNTERS]


class _Entry:
    """One captured region: its graph, static arguments and outputs, the
    kernel launches its capture recorded, and (``first``) the outputs of
    the eager run before the capture, which the capturing call returns."""

    def __init__(self, fn: Callable, args: Sequence, pool):
        # the static arguments live outside the graph's pool
        self.static = [a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args]
        dev = next(a for a in args if isinstance(a, torch.Tensor)).device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.first = fn(*self.static)
            self.graph = torch.cuda.CUDAGraph()
            before = _counts()
            self.graph.capture_begin(pool=pool)
            try:
                self.out = fn(*self.static)
            finally:
                self.graph.capture_end()
            # a captured launch runs nothing: replays count it
            self.delta = [(m, n, b - a) for (m, n), a, b in
                          zip(KERNEL_COUNTERS, before, _counts()) if b != a]
            for m, n, d in self.delta:
                setattr(m, n, getattr(m, n) - d)
        cur.wait_stream(side)
        for t in (self.first if isinstance(self.first, tuple)
                  else (self.first,)):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)

    def replay(self, args: Sequence):
        for s, a in zip(self.static, args):
            if isinstance(s, torch.Tensor):
                s.copy_(a)
        self.graph.replay()
        for m, n, d in self.delta:
            setattr(m, n, getattr(m, n) + d)


class Graphs:
    """The captured regions of one module, of one ``kind`` (the counters'
    key). Kept as a plain attribute: not in the state dict; a copy or a
    pickle of the module starts with none."""

    def __init__(self, kind: str):
        self.kind = kind
        self.drop()

    def __reduce__(self):
        return Graphs, (self.kind,)

    def drop(self):
        """Forget every graph (their pool is freed with them)."""
        self.entries: Dict[tuple, _Entry] = {}
        self.seen = set()
        self.pool = None
        self.state = None

    def run(self, fn: Callable, args: Sequence, owner: nn.Module,
            modules: Sequence[nn.Module], fresh: Sequence[int] = ()):
        """``fn(*args)``, a region of ``owner`` that calls ``modules``,
        eagerly or from a graph (see the module's docstring). ``fresh``
        names outputs of a tuple result that are copied after a replay,
        so that they outlive the next one."""
        why, state = gate(owner, modules, args)
        if why is not None:
            eager[self.kind] += 1
            return fn(*args)
        if state != self.state:
            self.drop()
            self.state = state
        key = (torch.is_inference_mode_enabled(),
               *(_signature(a) for a in args))
        entry = self.entries.get(key)
        if entry is None:
            if key not in self.seen or len(self.entries) >= LIMIT \
                    or torch.autograd._profiler_enabled():
                if len(self.seen) >= 4 * LIMIT:
                    self.seen.clear()
                self.seen.add(key)
                eager[self.kind] += 1
                return fn(*args)
            entry = self.entries[key] = _Entry(fn, args, self.pool)
            if self.pool is None:
                self.pool = entry.graph.pool()
            captures[self.kind] += 1
            out, entry.first = entry.first, None
            return out
        entry.replay(args)
        replays[self.kind] += 1
        if not fresh:
            return entry.out
        return tuple(o.clone() if i in fresh else o
                     for i, o in enumerate(entry.out))
