"""Minimal TensorBoard event-file writer (no dependencies), the port's copy
of ``das_tpu/utils/tb_events.py``: the same bytes for the same scalars and
wall time.

Replaces the reference's ``TensorboardLoggerHook``
(ref configs/_base_/default_runtime.py:5-10) without importing the heavy
tensorboard stack: scalar summaries are encoded directly in the
TFRecord + Event-proto wire format, so the files open in stock
TensorBoard (``tensorboard --logdir work_dir``).

Wire format:
* TFRecord framing: u64-LE length, masked crc32c(length), payload,
  masked crc32c(payload).
* ``Event`` proto: wall_time (field 1, double), step (field 2, varint),
  file_version (field 3, string) or summary (field 5, message).
* ``Summary.value`` (field 1): tag (field 1, string) +
  simple_value (field 2, float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
    out = bytearray()
    out += b'\x09' + struct.pack('<d', wall_time)        # field 1 double
    if step:
        out += b'\x10' + _varint(step)                   # field 2 varint
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return bytes(out)


def _scalar_summary(scalars: Dict[str, float]) -> bytes:
    out = bytearray()
    for tag, val in scalars.items():
        v = _field_bytes(1, tag.encode()) + \
            b'\x15' + struct.pack('<f', float(val))
        out += _field_bytes(1, v)
    return bytes(out)


class EventWriter:
    """Append-only scalar event writer; one file per run."""

    def __init__(self, logdir: str, suffix: str = ''):
        os.makedirs(logdir, exist_ok=True)
        fname = ('events.out.tfevents.%010d.%s%s'
                 % (time.time(), socket.gethostname(), suffix))
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, 'ab')
        self._write(_event(time.time(), file_version='brain.Event:2'))

    def _write(self, payload: bytes):
        length = struct.pack('<Q', len(payload))
        self._f.write(length + struct.pack('<I', _masked_crc(length)) +
                      payload + struct.pack('<I', _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        self._write(_event(time.time(), step=step,
                           summary=_scalar_summary(scalars)))
        self._f.flush()

    def close(self):
        self._f.close()
