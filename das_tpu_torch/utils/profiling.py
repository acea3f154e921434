"""Profiling and tracing, the port's counterpart of
``das_tpu/utils/profiling.py``: a device trace of a block of code, and the
program's named spans in it.

``trace`` runs ``torch.profiler`` over the block, with the card's activity
where a card is there, and writes the trace as a Chrome trace JSON file
(``*.pt.trace.json``) into ``log_dir``, which TensorBoard's profiler plugin
and Perfetto read.

``span(name)`` marks a region of the program. While a ``torch.profiler``
session records, it is a ``record_function`` range, so it lands in the same
trace as the CUDA runtime's calls and the device's kernels, on one clock;
otherwise it is one shared no-op context, which costs a check of the
profiler's state. The program's spans are named ``das.<layer>``.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block into ``log_dir``, with the
    card's activity where a card is there; yields the
    ``torch.profiler.profile`` (``key_averages()`` once the block is left)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def span(name: str):
    """A context marking the region ``name`` in a profiler's trace while
    one records; the shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
