"""Image file decoding: ``imread``, the port's ``cv2.imread(path,
IMREAD_COLOR)``.

Where ``cv2`` can be imported it decodes. Where it cannot (a host with
PyTorch and no OpenCV), ``imread`` reads PNG files itself with ``zlib`` and
numpy: 8-bit, non-interlaced, colour types 0 (grey), 2 (RGB) and 6 (RGBA),
all five row filters, converted to 3-channel BGR as ``IMREAD_COLOR`` does
(grey replicated, alpha dropped). The same bytes give the same array as
``cv2.imread``. Any other file (JPEG among them) raises an error that
names ``cv2``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of the image file at ``path``; raises
    ``FileNotFoundError`` when it cannot be read."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(path) from e
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f'{path}: without cv2 only PNG files can be read '
                         '(install opencv-python to read JPEG and others)')
    return read_png(data, path)


def _chunks(data: bytes, what: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IEND':
            return
    raise ValueError(f'{what}: truncated PNG (no IEND chunk)')


def read_png(data: bytes, what: str = '<png>') -> np.ndarray:
    """Decode PNG bytes to (H, W, 3) uint8 BGR, as ``cv2.imread(path,
    IMREAD_COLOR)`` does. Only 8-bit non-interlaced grey, RGB and RGBA;
    anything else raises an error that names cv2."""
    header, idat = None, []
    for kind, body in _chunks(data, what):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError(f'{what}: PNG without IHDR')
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f'{what}: PNG bit depth {depth}, colour type {ctype}, interlace '
            f'{interlace}: without cv2 only 8-bit non-interlaced grey, RGB '
            'and RGBA PNGs can be read')
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f'{what}: PNG data of {raw.size} bytes, expected '
                         f'{h * (stride + 1)}')
    raw = raw.reshape(h, stride + 1)
    # rows without a filter are their bytes; the others, in order, read
    # the row above
    out = raw[:, 1:].copy()
    zero = np.zeros(stride, np.uint8)
    for y in np.flatnonzero(raw[:, 0]).tolist():
        out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:],
                           out[y - 1] if y else zero, bpp, what)
    px = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])      # RGB(A) -> BGR


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int,
              what: str) -> np.ndarray:
    """Undo one row's filter (PNG spec section 9.2), arithmetic mod 256."""
    if kind == 0:                                            # None
        return line
    if kind == 1:                                            # Sub
        return line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8) \
            .reshape(-1)
    if kind == 2:                                            # Up
        return line + prior
    if kind not in (3, 4):
        raise ValueError(f'{what}: unknown PNG row filter {kind}')
    # Average and Paeth read the reconstructed byte to the left: a loop
    cur = line.astype(np.int64).tolist()
    up = prior.astype(np.int64).tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        if kind == 3:                                        # Average
            cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 255
            continue
        b = up[i]                                            # Paeth
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return np.asarray(cur, np.uint8)
