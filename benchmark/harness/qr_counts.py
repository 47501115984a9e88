"""The work of the QR program's fronts, from the symbolic's unpadded
front sizes: a front of f rows and c columns is factored by Householder
QR (2 c^2 (f - c/3) flops where f >= c, 2 f^2 (c - f/3) where f < c) and
its reflectors are applied to one right-hand side (4 f c).  It reads the
f x c front and its right-hand side once and writes them once.  Counted
on the unpadded sizes, the work is the same whatever buckets, padding or
library carry it.  The fronts are factored in float64 (the program's
``front_dtype``), whose tensor-core peak on the H100 equals the float32
peak that the flops are held against; their bytes count at the
fronts' entry size, which the front end reports."""
from __future__ import annotations

import numpy as np

from . import counts


def qr_front_flops(rows, cols) -> np.ndarray:
    """Operations of each front's QR and of carrying one right-hand
    side."""
    f = np.asarray(rows, dtype=np.float64)
    c = np.asarray(cols, dtype=np.float64)
    qr = np.where(f >= c, 2.0 * c * c * (f - c / 3.0),
                  2.0 * f * f * (c - f / 3.0))
    return qr + 4.0 * f * c


def qr_front_bytes(rows, cols, itemsize: int = 4) -> np.ndarray:
    """Bytes of each front: the front and its right-hand side read once
    and written once."""
    f = np.asarray(rows, dtype=np.float64)
    c = np.asarray(cols, dtype=np.float64)
    return 2.0 * f * (c + 1.0) * itemsize


def qr_front_least_s(rows, cols, itemsize: int = 4) -> float:
    """The least time the card could take for every front: per front the
    larger of its operations over the float32 peak and its bytes over the
    HBM peak."""
    return float(np.maximum(
        qr_front_flops(rows, cols) / counts.PEAK_FLOPS_F32,
        qr_front_bytes(rows, cols, itemsize) / counts.PEAK_HBM_BYTES).sum())
