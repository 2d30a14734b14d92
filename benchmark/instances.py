"""The inputs of every cell, made from ``--seed`` by the benchmark alone.

- ``proof_copy``: a copy of a TSPLIB EUC_2D instance under a relabeling of
  all its cities. It leaves every ``nint`` distance as it was, so each
  copy keeps the published optimum, while its distance matrix is new
  bytes (a new instance to the program's caches) and its root, city 0,
  is any of the instance's cities.
- ``blocked_cities``: a city set in the reference program's block layout
  (tsp.cpp:373-403): block ``i`` of a ``rows x cols`` grid has row ``i //
  rows`` and column ``cols - i % cols - 1``, its cities uniform in that
  rectangle of the ``grid_x x grid_y`` plane.

Input ``i`` of a run with seed ``s`` comes from ``numpy`` ``PCG64`` seeded
with ``(stream, s, i)``: the same seed gives the same inputs, in any
process.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .reference.tsp import euc_2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: stream ids keep the warm-up, the window and the controls apart
WINDOW, WARM, CONTROL, SAMPLE = 1, 2, 3, 4


def rng(stream: int, seed: int, i: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([stream, int(seed) & (2**64 - 1), i]))


def load_coords(rel_path: str) -> np.ndarray:
    with open(os.path.join(ROOT, rel_path)) as f:
        return np.asarray(json.load(f)["node_coords"], np.int64)


@dataclass
class ProofCopy:
    xy: np.ndarray  # [n, 2] integer coordinates of the copy
    d: np.ndarray  # [n, n] int64 EUC_2D distances, as the solver gets them
    labels: np.ndarray  # labels[new] = original city


def proof_copy(coords: np.ndarray, stream: int, seed: int, i: int,
               precision: Optional[str] = None) -> ProofCopy:
    """Copy ``i`` of the instance ``coords``: its cities under a relabeling
    drawn from the seed.

    ``precision`` "bfloat16" computes the copy's distances with its
    coordinates, differences, squares and root in bfloat16 (the control's
    lower precision); None computes them exactly (``euc_2d``)."""
    labels = rng(stream, seed, i).permutation(coords.shape[0])
    xy = coords[labels]
    if precision is None:
        d = euc_2d(xy)
    else:
        d = _euc_2d_low(xy, precision)
    return ProofCopy(xy=xy, d=d, labels=labels)


def _euc_2d_low(xy: np.ndarray, precision: str) -> np.ndarray:
    import torch

    dt = getattr(torch, precision)
    p = torch.as_tensor(xy, dtype=torch.float64).to(dt)
    dx = p[:, None, 0] - p[None, :, 0]
    dy = p[:, None, 1] - p[None, :, 1]
    r = (dx * dx + dy * dy).sqrt()
    return torch.floor(r + 0.5).to(torch.float64).numpy().astype(np.int64)


def blocks_per_dim(num_blocks: int):
    """The reference's grid (tsp.cpp:136-157): a square gives sqrt x sqrt,
    else the smallest divisor from 2 up times its cofactor."""
    r = math.isqrt(num_blocks)
    if r * r == num_blocks:
        return r, r
    div = 2
    while num_blocks % div:
        div += 1
    return div, num_blocks // div


def blocked_cities(n: int, num_blocks: int, grid_x: float, grid_y: float, stream: int, seed: int,
                   i: int) -> np.ndarray:
    """``[B, n, 2]`` float64 cities, uniform within each block's rectangle."""
    rows, cols = blocks_per_dim(num_blocks)
    g = rng(stream, seed, i)
    u = g.random((num_blocks, n, 2))
    b = np.arange(num_blocks)
    row, col = b // rows, cols - (b % cols) - 1
    xs, ys = grid_x / rows, grid_y / cols
    xy = np.empty((num_blocks, n, 2))
    xy[..., 0] = (row * xs)[:, None] + u[..., 0] * xs
    xy[..., 1] = (col * ys)[:, None] + u[..., 1] * ys
    return xy
