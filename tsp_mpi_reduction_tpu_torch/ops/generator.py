"""Blocked-instance generator, bit-exact against the reference.

Replicated behaviour (quirks intentional, SURVEY.md §5):

- ``getBlocksPerDim`` (tsp.cpp:136-157): a perfect square gives sqrt x
  sqrt, else the smallest divisor >= 2 times its cofactor.
- ``distributeCities`` (tsp.cpp:373-403): block ``i`` of ``rows x cols``
  has ``row = i / rows`` and ``col = cols - (i % cols) - 1``; each city
  draws x then y with ``fRand`` over ``[row*xspb, (row+1)*xspb] x
  [col*yspb, (col+1)*yspb]``. City ids are sequential in generation order.
- The block spacing is C ``float`` arithmetic (tsp.cpp:378-379); only the
  final ``fRand`` mix runs in double. Replicated with ``np.float32``.
- Non-square factorizations place cities outside the nominal grid
  (SURVEY.md quirk #3); reproduced as is.

Host numpy: the coordinates are made once and then moved to the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .rand import GlibcRand


def is_square(x: int) -> bool:
    """``ISSQUARE`` (assignment2.h:11): float sqrt residue test."""
    s = math.sqrt(x)
    return s - math.floor(s) == 0.0


def get_blocks_per_dim(num_blocks: int) -> Tuple[int, int]:
    """Near-square factorization (tsp.cpp:136-157): returns (rows, cols)."""
    if is_square(num_blocks):
        r = int(math.sqrt(num_blocks))
        return r, r
    divisor = 2
    while num_blocks % divisor != 0:
        divisor += 1
    return divisor, num_blocks // divisor


def generate_blocked_cities(
    num_cities_per_block: int,
    rows: int,
    cols: int,
    grid_dim_x: int,
    grid_dim_y: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``rows*cols`` blocks of cities in the reference's generation order
    (block-major, city-minor, x before y — tsp.cpp:384-399).

    Returns ``(ids, xy)``: ``[B, n]`` int32 and ``[B, n, 2]`` float64.
    """
    n = num_cities_per_block
    num_blocks = rows * cols
    rng = GlibcRand(seed)

    xspb = np.float32(grid_dim_x) / np.float32(rows)
    yspb = np.float32(grid_dim_y) / np.float32(cols)

    # two draws per city, x then y
    raw = rng.fill(2 * num_blocks * n).astype(np.float64) / float(2147483647)
    raw = raw.reshape(num_blocks, n, 2)

    i = np.arange(num_blocks)
    row = i // rows  # (i - i % rows) / rows, tsp.cpp:391
    col = (cols - (i % cols)) - 1  # tsp.cpp:393

    # float32 bounds widened to double at the fRand call (tsp.cpp:394-395)
    x_lo = (row.astype(np.float32) * xspb).astype(np.float64)
    x_hi = ((row + 1).astype(np.float32) * xspb).astype(np.float64)
    y_lo = (col.astype(np.float32) * yspb).astype(np.float64)
    y_hi = ((col + 1).astype(np.float32) * yspb).astype(np.float64)

    xy = np.empty((num_blocks, n, 2), dtype=np.float64)
    xy[:, :, 0] = x_lo[:, None] + raw[:, :, 0] * (x_hi - x_lo)[:, None]
    xy[:, :, 1] = y_lo[:, None] + raw[:, :, 1] * (y_hi - y_lo)[:, None]

    ids = np.arange(num_blocks * n, dtype=np.int32).reshape(num_blocks, n)
    return ids, xy


def generate_instance(
    num_cities_per_block: int,
    num_blocks: int,
    grid_dim_x: int,
    grid_dim_y: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """The full instance as ``main()`` builds it (tsp.cpp:312-314)."""
    rows, cols = get_blocks_per_dim(num_blocks)
    return generate_blocked_cities(
        num_cities_per_block, rows, cols, grid_dim_x, grid_dim_y, seed
    )
