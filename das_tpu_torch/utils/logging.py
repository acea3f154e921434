"""Metric logging (replaces mmcv TextLoggerHook + TensorboardLoggerHook,
ref configs/_base_/default_runtime.py:5-10): text log + a jsonl metrics
stream + native TensorBoard event files (utils/tb_events.py); the port's
copy of ``das_tpu/utils/logging.py``. ``MetricLogger.log`` turns the
metrics into floats (a host sync for tensors on the card) only on its
interval, and logs ``img_per_s`` as the images stepped since the previous
logged line over the host time since that line's sync."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict


def get_root_logger(log_file=None, level=logging.INFO):
    """The 'das_tpu_torch' logger, to stdout and to ``log_file`` (added once
    per file: a second run in one process logs to its own file too, where
    the JAX logger keeps only the first run's)."""
    logger = logging.getLogger('das_tpu_torch')
    fmt = logging.Formatter('%(asctime)s - %(name)s - %(levelname)s - '
                            '%(message)s')
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file and not any(
            getattr(h, 'baseFilename', None) == os.path.abspath(log_file)
            for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    def __init__(self, work_dir: str, interval: int = 50,
                 tensorboard: bool = True):
        os.makedirs(work_dir, exist_ok=True)
        stamp = time.strftime('%Y%m%d_%H%M%S')
        self.log_file = os.path.abspath(
            os.path.join(work_dir, f'{stamp}.log'))
        self.logger = get_root_logger(self.log_file)
        self.jsonl = open(os.path.join(work_dir, f'{stamp}.metrics.jsonl'),
                          'a')
        self.interval = interval
        self.tb = None
        if tensorboard:
            from .tb_events import EventWriter
            self.tb = EventWriter(os.path.join(work_dir, 'tf_logs'))
        self.start(0)

    def text(self, msg: str):
        self.logger.info(msg)

    def start(self, step: int):
        """Start the rate's clock: the loop's next step is ``step + 1``."""
        self.mark = (step, time.perf_counter())

    def log(self, step: int, metrics: Dict, batch_size: int):
        """On the interval: the metrics as floats, and ``img_per_s``, the
        ``batch_size`` images of each step since the previous logged line
        (or ``start``; the logger starts at step 0) over the host time
        since then. Each line's ``float`` waits for the card, so that is a
        rate of images trained, not of steps enqueued."""
        if step % self.interval != 0:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        last, since = self.mark
        self.mark = (step, now)
        vals.update(step=step, img_per_s=batch_size * (step - last)
                    / max(now - since, 1e-9))
        self.jsonl.write(json.dumps(vals) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalars(
                step, {f'train/{k}': v for k, v in vals.items()
                       if k != 'step'})
        parts = ', '.join(f'{k}: {v:.4f}' for k, v in vals.items()
                          if k != 'step')
        self.logger.info(f'step {step}: {parts}')

    def close(self):
        for h in list(self.logger.handlers):
            if getattr(h, 'baseFilename', None) == self.log_file:
                self.logger.removeHandler(h)
                h.close()
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class NullLogger:
    """What a rank other than 0 logs through: nothing (rank 0 writes the
    text log, the metrics and the event file for the whole group)."""

    def text(self, msg: str):
        pass

    def start(self, step: int):
        pass

    def log(self, step: int, metrics: Dict, batch_size: int):
        pass

    def close(self):
        pass
