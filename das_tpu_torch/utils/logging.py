"""Metric logging (replaces mmcv TextLoggerHook + TensorboardLoggerHook,
ref configs/_base_/default_runtime.py:5-10): text log + a jsonl metrics
stream + native TensorBoard event files (utils/tb_events.py); the port's
copy of ``das_tpu/utils/logging.py``. ``MetricLogger.log`` turns the
metrics into floats (a host sync for tensors on the card) only on its
interval."""

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

    def text(self, msg: str):
        self.logger.info(msg)

    def log(self, step: int, metrics: Dict, batch_size: int, dt: float):
        if step % self.interval != 0:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        vals.update(step=step, img_per_s=batch_size / max(dt, 1e-9))
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
