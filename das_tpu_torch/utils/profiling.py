"""Profiling and tracing, the port's counterpart of
``das_tpu/utils/profiling.py``: a device trace of a block of code, a rolling
per-step timer and named regions for the trace.

``trace`` runs ``torch.profiler`` over the block, with the card's activity
where a card is there, and writes the trace as a Chrome trace JSON file
(``*.pt.trace.json``) into ``log_dir``, which TensorBoard's profiler plugin
and Perfetto read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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


class StepTimer:
    """Rolling per-step wall-clock stats."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        if dt > 0:
            self.times.append(dt)
            self.times = self.times[-self.window:]
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def img_per_s(self, batch_size: int) -> float:
        return batch_size / self.mean if self.mean else 0.0


def annotate(name: str):
    """Named region for profile traces."""
    return torch.profiler.record_function(name)
