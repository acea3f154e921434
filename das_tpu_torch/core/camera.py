"""Pinhole camera math, the port's copy of ``das_tpu/core/camera.py``
(ref: mytools/vis_3d.py:4-27).

``pixel2world`` inverts the intrinsics on (u, v), scales by depth, and
applies the inverse extrinsics; ``world2pixel`` is the forward projection.
Used by the evaluators for camera-space back-projection.
"""

from __future__ import annotations

import numpy as np


def pixel2world(x: np.ndarray, K: np.ndarray, R: np.ndarray,
                t: np.ndarray) -> np.ndarray:
    """Back-project pixel+depth to world.

    Args:
        x: (3, N) rows [u, v, z]
        K: (2+, 3) intrinsics (only the 2x3 top block is used)
        R: (3, 3) rotation; t: (3, 1) translation
    Returns (3, N) world coordinates.
    """
    X = np.array(x, np.float64, copy=True)
    X[0, :] -= K[0][2]
    X[1, :] -= K[1][2]
    K2 = np.array([[K[0][0], K[0][1]], [K[1][0], K[1][1]]], np.float64)
    X[:2] = np.linalg.inv(K2) @ X[:2]
    X[0:2, :] = X[0:2, :] * X[2, :]
    return np.linalg.inv(np.asarray(R, np.float64)) @ (
        X - np.asarray(t, np.float64).reshape(3, 1))


def world2pixel(X: np.ndarray, K: np.ndarray, R: np.ndarray,
                t: np.ndarray) -> np.ndarray:
    """Project world points (3, N) to pixels; z preserved as depth."""
    x = np.asarray(R, np.float64) @ X + \
        np.asarray(t, np.float64).reshape(3, 1)
    x = np.array(x, copy=True)
    x[0:2, :] = x[0:2, :] / (x[2, :] + 1e-5)
    u = K[0][0] * x[0, :] + K[0][1] * x[1, :] + K[0][2]
    v = K[1][0] * x[0, :] + K[1][1] * x[1, :] + K[1][2]
    x[0, :] = u
    x[1, :] = v
    return x
