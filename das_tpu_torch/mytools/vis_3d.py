"""Drop-in camera-math module (ref: mytools/vis_3d.py), the port's
counterpart of the repo's ``mytools/vis_3d.py``, which imports JAX through
``das_tpu``; this one imports only numpy
and the port's camera module.

The reference exposes ``world2pixel`` / ``pixel2world`` from this path and
its evaluators consume ``pixel2world(...)[-1]`` (the world-space result).
The port keeps the canonical implementations in
``das_tpu_torch.core.camera``; this module preserves the reference's import
path and return conventions for scripts written against it:

* ``pixel2world`` returns the reference's ``(x1, x2, x3)`` tuple —
  intrinsics-normalised rays, camera-space points (rays * depth), and
  world-space points (ref mytools/vis_3d.py:17-27).
* ``world2pixel`` returns a (3, N) array with rows [u, v, z]. The
  reference computes v from the already-overwritten u row
  (ref vis_3d.py:10-12); that is only observable when K[1][0] != 0,
  which never holds for the datasets' intrinsics — this version uses the
  order-independent form from ``das_tpu_torch.core.camera``.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import world2pixel  # noqa: F401  (re-export)


def pixel2world(x: np.ndarray, K: np.ndarray, R: np.ndarray,
                t: np.ndarray):
    """Back-project pixels+depth; returns (rays, camera, world) like the
    reference (evaluators use ``[-1]``)."""
    X = np.array(x, np.float64, copy=True)
    X[0, :] -= K[0][2]
    X[1, :] -= K[1][2]
    K2 = np.array([[K[0][0], K[0][1]], [K[1][0], K[1][1]]], np.float64)
    X[:2] = np.linalg.inv(K2) @ X[:2]
    x1 = X.copy()
    X[0:2, :] = X[0:2, :] * X[2, :]
    x2 = X.copy()
    x3 = np.linalg.inv(np.asarray(R, np.float64)) @ (
        X - np.asarray(t, np.float64).reshape(3, 1))
    return x1, x2, x3
