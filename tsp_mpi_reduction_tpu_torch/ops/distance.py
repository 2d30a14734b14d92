"""Pairwise Euclidean distances.

Reference: ``computeDistanceMatrix`` (assignment2.h:184-200), a double loop
of ``sqrt(pow(dx,2) + pow(dy,2))``. Here: one broadcast on the device, or a
host numpy copy for bit-exact float64 parity.

The device version squares and adds as separate elementwise ops (eager
PyTorch fuses no multiply-add, and an explicit ``dx*dx + dy*dy`` avoids a
reduction's wider accumulator). Its square root is the device's: PyTorch's
vectorized CPU ``sqrt`` is not always correctly rounded (1 ulp off numpy
on some float64 inputs), so the bit-exact float64 path is the host numpy
matrix. Comparisons that start from different distance tensors need a
tolerance; comparisons from one distance tensor do not.
"""

from __future__ import annotations

import numpy as np
import torch


def distance_matrix(xy: torch.Tensor) -> torch.Tensor:
    """``[..., n, 2]`` coordinates -> ``[..., n, n]`` distances, on ``xy``'s
    device and in its dtype."""
    dx = xy[..., :, None, 0] - xy[..., None, :, 0]
    dy = xy[..., :, None, 1] - xy[..., None, :, 1]
    d = dx * dx
    del dx
    d += dy * dy
    return d.sqrt_()


def distance_matrix_np(xy: np.ndarray) -> np.ndarray:
    """Host float64 distances, bit-exact against the C oracle: numpy's
    multiply, add and sqrt are correctly rounded and applied in the
    reference's order (assignment2.h:141-144, 196)."""
    xy = np.asarray(xy, dtype=np.float64)
    diff = xy[..., :, None, :] - xy[..., None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


def edge_length(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance between point tensors ``a`` and ``b`` (``[..., 2]`` each)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    return torch.sqrt(dx * dx + dy * dy)
