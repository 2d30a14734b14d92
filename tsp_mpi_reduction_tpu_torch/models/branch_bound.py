"""Exact branch-and-bound TSP on one device: packed frontier + batched step.

Counterpart of ``tsp_mpi_reduction_tpu/models/branch_bound.py``, single
device. A solve:

1. builds the bound tables on the host in float64 numpy
   (:func:`_bound_setup`: Held-Karp 1-tree potentials snapped to a
   power-of-two grid, so every float32 value the search computes on an
   integer metric is exact);
2. builds the incumbent: multistart nearest-neighbour tours polished by
   batched 2-opt/Or-opt on the device, then iterated local search
   (:func:`strong_incumbent`);
3. runs the search on the device: each expansion step pops the top k nodes
   of a packed int32 frontier, re-bounds every popped node with the
   reduced-cost MST bound (the Prim chain runs in the hand-written CUDA
   kernel ``prim_chain`` on a CUDA device), expands all k*n children,
   prunes them against the incumbent, and pushes the survivors
   best-first (:func:`_expand_step`; on a CUDA device the hand-written
   kernel ``push_rows`` builds and stores the pushed rows in place);
4. guards the frontier's capacity. The device loop (the default on a CUDA
   device, :func:`_guarded_expand_steps`) checks the count every step,
   squeezes incumbent-closed nodes out on the device
   (:func:`_compact_frontier`) and stops before a push could overflow;
   the host loop runs ``inner_steps`` steps between checks. Either way,
   a frontier near capacity is exchanged with the host reservoir
   (:class:`_Reservoir`), which hands nodes back when the device stack
   empties. ``reorder_every`` re-sorts the stack best-bound-first
   (:func:`_reorder_frontier`).

Frontier row layout (``FRONTIER_LAYOUT_VERSION`` 2 of the JAX package;
P = ceil(n/4) path words, W = ceil(n/32) mask words)::

    [0, P)      path    4 uint8 city ids per int32 word (byte j of word w
                        is city 4w+j)
    [P, P+W)    mask    visited bitmask words, as int32 bit patterns
    P+W         depth   int32
    P+W+1..+3   cost, bound, sum_min: float32 stored as their int32 bits

Visited masks are int32 bit patterns here (the JAX package reads them as
uint32): ``(w >> b) & 1`` gives the same bit for every b, bit 31 included.

Not ported yet, each raising ``ValueError("... not ported yet")``:
checkpoints and resume, ``ascent="device"`` and the Boruvka MST.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import expand_kernels, prim_kernels
from ..ops.local_search import polish

INF = float("inf")

#: city ids packed per int32 path word (uint8 lanes; ids < 200 < 256)
PATH_PACK = 4

#: ceil(200/32) = 7 mask words; the Prim kernel's register arrays
MAX_BNB_CITIES = 200

#: the MST bound's Prim chain: "auto" (the CUDA kernel on a CUDA device,
#: the plain chain on the CPU), "prim" (the plain torch chain) or
#: "prim_chain" (the kernel's wrapper, which takes the plain chain only
#: for CPU tensors)
MST_KERNELS = ("auto", "prim", "prim_chain")

#: the expansion step's push: "auto" (the fused ``push_rows`` kernel on a
#: CUDA device, the reference push on the CPU), "reference" (the candidate
#: block) or "fused" (``push_rows``, whose wrapper takes its plain version
#: only for CPU tensors)
STEP_KERNELS = ("auto", "reference", "fused")


def _path_words(n: int) -> int:
    """int32 words holding the packed [n]-city tour prefix (P)."""
    return (n + PATH_PACK - 1) // PATH_PACK


def _layout(cols: int) -> Tuple[int, int]:
    """Invert the packed-row width ``cols = P + W + 4`` to ``(n_hi, W)``:
    the (P, W) cell is unique for a width; ``n_hi`` is the largest n in
    it (the exact n is threaded separately where it matters)."""
    for n_hi in range(min((cols - 5) * PATH_PACK, 32 * (cols - 5)), 0, -1):
        w = (n_hi + 31) // 32
        if _path_words(n_hi) + w + 4 == cols:
            return n_hi, w
    raise ValueError(f"no valid (n, W) layout for packed row width {cols}")


def _pack_path_np(path: np.ndarray, n: int) -> np.ndarray:
    """[..., n] city ids -> [..., P] int32 words, byte j of word w = city
    4w+j (explicit shifts: endian-independent)."""
    p = _path_words(n)
    padded = np.zeros(path.shape[:-1] + (p * PATH_PACK,), np.uint32)
    padded[..., :n] = np.asarray(path, np.int64) & 0xFF
    lanes = padded.reshape(path.shape[:-1] + (p, PATH_PACK))
    words = lanes[..., 0] | (lanes[..., 1] << 8) | (lanes[..., 2] << 16) | (lanes[..., 3] << 24)
    return words.astype(np.uint32).view(np.int32)


def _unpack_path_np(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_path_np`: [..., P] words -> [..., n]."""
    u = np.ascontiguousarray(words).view(np.uint32)
    shifts = np.arange(PATH_PACK, dtype=np.uint32) * 8
    lanes = (u[..., :, None] >> shifts) & np.uint32(0xFF)
    return lanes.reshape(words.shape[:-1] + (-1,))[..., :n].astype(np.int32)


def _unpack_rows_np(rows: np.ndarray, n: Optional[int] = None) -> dict:
    """Packed int32 rows -> the logical fields (numpy); ``n`` None takes
    the layout maximum for the width."""
    n_hi, w = _layout(rows.shape[-1])
    n = n_hi if n is None else n
    p = _path_words(n_hi)
    rows = np.ascontiguousarray(rows)

    def fcol(c):
        return np.ascontiguousarray(rows[..., c]).view(np.float32)

    return {
        "path": _unpack_path_np(rows[..., :p], n),
        "mask": np.ascontiguousarray(rows[..., p : p + w]).view(np.uint32),
        "depth": rows[..., -4],
        "cost": fcol(-3),
        "bound": fcol(-2),
        "sum_min": fcol(-1),
    }


def _pack_rows_np(path, mask, depth, cost, bound, sum_min) -> np.ndarray:
    """Inverse of :func:`_unpack_rows_np`: six field arrays -> rows."""

    def fbits(a):
        return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)

    return np.concatenate(
        [
            _pack_path_np(np.asarray(path), np.shape(path)[-1]),
            np.ascontiguousarray(np.asarray(mask, np.uint32)).view(np.int32),
            np.asarray(depth, np.int32)[..., None],
            fbits(cost)[..., None],
            fbits(bound)[..., None],
            fbits(sum_min)[..., None],
        ],
        axis=-1,
    )


def _f32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> the float32 values whose bits they hold."""
    return words.view(torch.float32)


def _i32(vals: torch.Tensor) -> torch.Tensor:
    """float32 values -> their int32 bit patterns."""
    return vals.contiguous().view(torch.int32)


def _unpack_path(words: torch.Tensor, n: int) -> torch.Tensor:
    """[..., P] int32 words -> [..., n] city ids (the arithmetic shift
    sign-extends; ``& 0xFF`` restores the byte)."""
    shifts = torch.arange(PATH_PACK, dtype=torch.int32, device=words.device) * 8
    lanes = (words[..., :, None] >> shifts) & 0xFF
    return lanes.reshape(words.shape[:-1] + (-1,))[..., :n]


def _path_byte_get(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """City id at prefix position ``pos`` per row: words [k, P], pos [k]."""
    word = words.gather(1, (pos // PATH_PACK).long()[:, None])[:, 0]
    return (word >> ((pos % PATH_PACK) * 8)) & 0xFF


class Frontier(NamedTuple):
    """Packed frontier: ONE ``[F, P + W + 4]`` int32 node buffer (layout in
    the module docstring), the stack height ``count`` (0-d int32) and the
    sticky ``overflow`` flag (0-d bool: a push overran capacity, children
    were dropped, so the run can no longer prove optimality)."""

    nodes: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor

    @property
    def _pw(self) -> Tuple[int, int]:
        n_hi, w = _layout(self.nodes.shape[-1])
        return _path_words(n_hi), w

    @property
    def path_words(self) -> torch.Tensor:
        return self.nodes[..., : self._pw[0]]

    def path_view(self, n: int) -> torch.Tensor:
        """Unpacked [..., n] city prefix for the exact ``n``."""
        return _unpack_path(self.path_words, n)

    @property
    def path(self) -> torch.Tensor:
        return _unpack_path(self.path_words, _layout(self.nodes.shape[-1])[0])

    @property
    def mask(self) -> torch.Tensor:
        """Visited mask words as int32 bit patterns."""
        p, w = self._pw
        return self.nodes[..., p : p + w]

    @property
    def depth(self) -> torch.Tensor:
        return self.nodes[..., -4]

    @property
    def cost(self) -> torch.Tensor:
        return _f32(self.nodes[..., -3])

    @property
    def bound(self) -> torch.Tensor:
        return _f32(self.nodes[..., -2])

    @property
    def sum_min(self) -> torch.Tensor:
        return _f32(self.nodes[..., -1])


@dataclass
class BnBResult:
    """What a solve reports; the fields mirror the JAX package's
    ``BnBResult`` for the parts this port computes."""

    cost: float
    tour: np.ndarray  # [n+1] closed tour from city 0
    nodes_expanded: int
    iterations: int  # expansion steps budgeted: inner_steps per host round
    proven_optimal: bool
    wall_seconds: float  # the search alone
    nodes_per_sec: float
    time_to_best: float
    root_lower_bound: float = -np.inf
    lower_bound: float = -np.inf  # certified at stop
    setup_seconds: float = 0.0  # bound setup + incumbent
    ascent_seconds: float = 0.0
    ils_seconds: float = 0.0
    lower_bound_raw: float = -np.inf
    # host reservoir transfers (SpillStats): rounds, events, full merges,
    # bytes each way
    spill_rounds: int = 0
    spill_events: int = 0
    spill_full_merges: int = 0
    spill_bytes_to_host: int = 0
    spill_bytes_to_device: int = 0
    steps_run: int = 0  # expansion steps run (one _expand_step call each)
    mst_kernel: str = ""  # the resolved Prim chain: "prim" or "prim_chain"
    step_kernel: str = ""  # the resolved push: "reference" or "fused"
    device_loop: bool = False  # the resolved loop


# ---------------------------------------------------------------------------
# Incumbent
# ---------------------------------------------------------------------------


def nearest_neighbor_tour(d: np.ndarray, start: int = 0) -> np.ndarray:
    n = d.shape[0]
    visited = np.zeros(n, bool)
    tour = [start]
    visited[start] = True
    for _ in range(n - 1):
        cur = tour[-1]
        cand = np.where(visited, np.inf, d[cur])
        nxt = int(np.argmin(cand))
        tour.append(nxt)
        visited[nxt] = True
    return np.asarray(tour + [tour[0]], dtype=np.int32)


def _double_bridge(rng, open_tour: np.ndarray, n: int) -> np.ndarray:
    """Cut an open tour at 3 random interior points and reconnect the 4
    segments in A-C-B-D order (the ILS kick 2-opt cannot undo)."""
    i, j, kk = np.sort(rng.choice(np.arange(1, n), size=3, replace=False))
    return np.concatenate([open_tour[:i], open_tour[j:kk], open_tour[i:j], open_tour[kk:]])


def _close_from_zero(open_tour: np.ndarray) -> np.ndarray:
    """Rotate an open tour to start at city 0 and append the closing 0."""
    rot = int(np.argwhere(open_tour == 0)[0, 0])
    open0 = np.roll(open_tour, -rot)
    return np.concatenate([open0, open0[:1]]).astype(np.int32)


def two_opt(d: np.ndarray, tour: np.ndarray, max_rounds: int = 200) -> np.ndarray:
    """Host best-improvement 2-opt (numpy delta matrix)."""
    t = tour[:-1].copy()
    n = len(t)
    for _ in range(max_rounds):
        pos = np.concatenate([t, t[:1]])
        a, b = pos[:-1], pos[1:]
        da = d[a[:, None], a[None, :]] + d[b[:, None], b[None, :]]
        db = d[a, b][:, None] + d[a, b][None, :]
        delta = da - db
        iu = np.triu_indices(n, k=2)
        flat = delta[iu]
        k = int(np.argmin(flat))
        if flat[k] >= -1e-9:
            break
        i, j = iu[0][k], iu[1][k]
        t[i + 1 : j + 1] = t[i + 1 : j + 1][::-1]
    return np.concatenate([t, t[:1]]).astype(np.int32)


def tour_cost(d: np.ndarray, tour: np.ndarray) -> float:
    return float(d[tour[:-1], tour[1:]].sum())


def strong_incumbent(
    d: np.ndarray, starts: int = 8, perturbations: Optional[int] = None, device="cuda"
) -> np.ndarray:
    """Best of ``starts`` nearest-neighbour tours polished as one batch on
    ``device`` (2-opt + Or-opt, float32), then ``perturbations`` rounds of
    iterated local search: a batch of double-bridge kicks of the best tour,
    re-polished. ``None`` picks 30 rounds for n >= 30, else 0. Costs are
    measured on the host in float64. Returns a closed [n+1] tour from 0."""
    n = d.shape[0]
    if perturbations is None:
        perturbations = 30 if n >= 30 else 0
    if n < 4:
        perturbations = 0  # double-bridge needs 3 distinct interior cuts
    d64 = np.asarray(d, np.float64)
    d32 = torch.as_tensor(np.asarray(d, np.float32), device=device)

    def vpolish(tours: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(np.asarray(tours, np.int64), device=device)
        return polish(t, d32)[0].cpu().numpy().astype(np.int32)

    ss = sorted(set(np.linspace(0, n - 1, min(starts, n)).astype(int).tolist()))
    opens = np.stack([nearest_neighbor_tour(d64, s)[:-1] for s in ss])
    polished = vpolish(opens)
    costs = [tour_cost(d64, np.concatenate([t, t[:1]])) for t in polished]
    best = polished[int(np.argmin(costs))]
    best_cost = float(np.min(costs))

    rng = np.random.default_rng(0)
    batch = polished.shape[0]
    for _ in range(perturbations):
        kicks = [_double_bridge(rng, best, n) for _ in range(batch)]
        repolished = vpolish(np.stack(kicks))
        rcosts = [tour_cost(d64, np.concatenate([t, t[:1]])) for t in repolished]
        rbest = int(np.argmin(rcosts))
        if rcosts[rbest] < best_cost:
            best_cost = rcosts[rbest]
            best = repolished[rbest]
    return _close_from_zero(best)


def strong_incumbent_host(
    d: np.ndarray, starts: int = 8, perturbations: Optional[int] = None
) -> np.ndarray:
    """Numpy twin of :func:`strong_incumbent` (multistart NN, numpy 2-opt,
    sequential double-bridge ILS; no Or-opt). Same contract, no device."""
    n = d.shape[0]
    if perturbations is None:
        perturbations = 30 if n >= 30 else 0
    if n < 4:
        perturbations = 0
    d64 = np.asarray(d, np.float64)
    ss = sorted(set(np.linspace(0, n - 1, min(starts, n)).astype(int).tolist()))
    best, best_cost = None, np.inf
    for s in ss:
        t = two_opt(d64, nearest_neighbor_tour(d64, s))
        c = tour_cost(d64, t)
        if c < best_cost:
            best, best_cost = t[:-1].copy(), c
    rng = np.random.default_rng(0)
    n_kicks = len(ss)
    for _ in range(perturbations):
        round_best, round_cost = None, np.inf
        for _ in range(n_kicks):
            kick = _double_bridge(rng, best, n)
            t = two_opt(d64, np.concatenate([kick, kick[:1]]))
            c = tour_cost(d64, t)
            if c < round_cost:
                round_best, round_cost = t[:-1].copy(), c
        if round_cost < best_cost:
            best, best_cost = round_best, round_cost
    return _close_from_zero(best)


def _initial_incumbent(d, ils_rounds, device) -> np.ndarray:
    """The ILS incumbent of a fresh solve (16 starts), polished on the
    solve's device."""
    return strong_incumbent(d, starts=16, perturbations=ils_rounds, device=device)


# ---------------------------------------------------------------------------
# Bound tables
# ---------------------------------------------------------------------------


def _is_integral(d) -> bool:
    """Every distance is integer-valued: the fixed-point-exact float32 path."""
    d64 = np.asarray(d, np.float64)
    return bool(np.all(d64 == np.rint(d64)))


@functools.lru_cache(maxsize=None)
def _mask_consts(n: int, device: str):
    """Per-``n`` helpers for the [W]-word visited mask -> (word_idx [n]
    int64, bit [n] int32): city j is bit ``bit[j]`` of word ``word_idx[j]``
    (the push's OR table lives in ``ops/expand_kernels``)."""
    return (
        torch.as_tensor(np.arange(n) // 32, dtype=torch.int64, device=device),
        torch.as_tensor(np.arange(n) % 32, dtype=torch.int32, device=device),
    )


class BoundData(NamedTuple):
    """float32 tensors on the solve's device + flags driving the pruning."""

    min_out: torch.Tensor  # [n] per-city weight (incremental bound)
    bound_adj: torch.Tensor  # [n] per-child adjustment
    dbar: torch.Tensor  # [n, n] reduced metric d + pi_i + pi_j (MST bound)
    pi: torch.Tensor  # [n] potentials (zeros in min-out mode)
    slack: torch.Tensor  # 0-d rounding slack of the MST bound (0 if exact)
    ascent_step: torch.Tensor  # 0-d per-node mini-ascent step
    lam_budget: torch.Tensor  # 0-d clamp on per-node ascent deltas
    root_lb: float  # certified global lower bound (float64)
    integral: bool  # integer metric: bounds are fixed-point exact


def _bound_setup(d, bound: str, ascent_steps: int = 400, node_ascent: int = 0,
                 ascent: str = "host", device="cuda") -> BoundData:
    """Bound tables for a metric and bound mode, in float64 numpy on the
    host, handed to ``device`` as float32 (``branch_bound.py:652-781``).

    "min-out": pi = 0. "one-tree": Held-Karp ascent potentials pi; weights
    become the min reduced outgoing edge - 2*pi, with a per-child
    adjustment pi[child] - pi[0]; ``dbar`` feeds the per-node MST bound.
    On an integer metric pi is snapped to the finest power-of-two grid that
    keeps every value the search computes exact in float32 (no slack, root
    bound rounded up); otherwise a slack sized for ~3n roundings per bound
    chain is shaved off.
    """
    n = d.shape[0]
    d64 = np.asarray(d, np.float64)
    integral = _is_integral(d64)
    eye = np.eye(n, dtype=bool)
    if bound == "one-tree":
        if ascent != "host":
            raise ValueError(f"ascent={ascent!r} is not ported yet (the port runs the host ascent)")
        from ..ops.one_tree import held_karp_potentials_np

        pi64, _ = held_karp_potentials_np(d64, steps=ascent_steps)
    elif bound == "min-out":
        pi64 = np.zeros(n)
    else:
        raise ValueError(f"bound must be 'one-tree' or 'min-out', got {bound!r}")

    # magnitude cap over every float32 intermediate of the search (prefix
    # costs, MST sums, carried weight sums, pi and mini-ascent corrections)
    max_d = float(np.abs(d64).max())
    max_pi = float(np.abs(pi64).max())
    mag = n * (max_d + 4.0 * max_pi) + 4.0 * float(np.abs(pi64).sum()) + 2.0 * n * max_d + 1.0

    g_cap = int(np.floor(np.log2(2.0**24 / mag)))
    if integral and g_cap < 0:
        integral = False  # a grid coarser than 1 would not hold integers
    if integral:
        grid = 2.0 ** (-min(10, g_cap))
        pi64 = np.round(pi64 / grid) * grid
        slack = 0.0
    else:
        slack = 3.0 * (1 + node_ascent) * n * float(np.spacing(np.float32(mag)))

    dbar64 = d64 + pi64[:, None] + pi64[None, :]
    dbar_inf = np.where(eye, np.inf, dbar64)
    w = dbar_inf.min(1) - 2.0 * pi64
    adj = pi64 - pi64[0]

    if bound == "one-tree":
        from ..ops.one_tree import one_tree_value_np

        root_lb = one_tree_value_np(d64, pi64)
    else:
        root_lb = float(w.sum())  # every city is left once

    if integral:
        root_lb = float(np.ceil(root_lb - 1e-6))
    else:
        root_lb = root_lb - slack
        adj = adj - slack
    raw_step = max_d / (8.0 * n)
    lam_budget = max_d / 4.0
    if integral:
        raw_step = max(grid, np.floor(raw_step / grid) * grid)
        lam_budget = max(grid, np.floor(lam_budget / grid) * grid)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return BoundData(f32(w), f32(adj), f32(dbar64), f32(pi64), f32(slack), f32(raw_step),
                     f32(lam_budget), root_lb, integral)


# ---------------------------------------------------------------------------
# The MST bound
# ---------------------------------------------------------------------------


def _first_argmin_excluding(row: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Per row, the first index of the minimum over every column except
    ``skip`` (one per row); an all-inf remainder gives its first index."""
    cols = torch.arange(row.shape[1], device=row.device)[None, :]
    keep = cols != skip[:, None]
    m2 = torch.where(keep, row, INF).amin(dim=1)
    return ((row == m2[:, None]) & keep).to(torch.int32).argmax(dim=1)


def _conn_edges(dbar, unvis, cur, n, lam=None):
    """Connection edges -> (conn, bump) (``branch_bound.py:784-821``).

    The path relaxation closes MST(U) with one edge cur->U and one edge
    U->0; root lanes (``cur == 0``) take the two cheapest 0-incident edges.
    ``lax.top_k(-row_0, 2)`` lists equal values by ascending index; here
    that is two first-index argmins, the first winner excluded from the
    second.
    """
    cities = torch.arange(n, device=dbar.device)[None, :]
    row_cur = torch.where(unvis, prim_kernels.edge_rows(dbar, cur, lam), INF)
    row_0 = torch.where(unvis, prim_kernels.edge_rows(dbar, torch.zeros_like(cur), lam), INF)
    a_cur = row_cur.argmin(dim=1)
    min_cur = row_cur.gather(1, a_cur[:, None])[:, 0]
    i1 = row_0.argmin(dim=1)
    i2 = _first_argmin_excluding(row_0, i1)
    v1 = row_0.gather(1, i1[:, None])[:, 0]
    v2 = row_0.gather(1, i2[:, None])[:, 0]
    is_root = cur == 0
    conn = torch.where(is_root, v1 + v2, min_cur + v1)
    conn = torch.where(torch.isfinite(conn), conn, INF)
    zero = torch.zeros_like(cur)

    def onehot(idx):
        return (cities == idx[:, None]).to(torch.int32)

    bump = (
        onehot(torch.where(is_root, i2, a_cur))
        + onehot(i1)
        + onehot(torch.where(is_root, zero, cur))
        + onehot(zero)
    )
    return conn, bump


def _not_ported(what: str):
    raise ValueError(f"{what} is not ported yet")


def _resolve_mst_kernel(mst_kernel: str, device) -> str:
    """``auto`` -> the kernel on a CUDA device, the plain chain on the CPU."""
    if mst_kernel == "boruvka":
        _not_ported("mst_kernel='boruvka'")
    if mst_kernel not in MST_KERNELS:
        raise ValueError(f"unknown mst_kernel {mst_kernel!r} (expected one of {MST_KERNELS}; "
                         "the JAX package's prim_pallas is prim_chain here)")
    if mst_kernel == "auto":
        return "prim_chain" if torch.device(device).type == "cuda" else "prim"
    return mst_kernel


def _mst_conn(dbar, unvis, cur, n, lam=None, mst_kernel: str = "prim"):
    """MST(U) + connection edges -> (value, degrees): the Prim chain (plain
    or the ``prim_chain`` kernel) plus :func:`_conn_edges`."""
    chain = prim_kernels.prim_chain if mst_kernel == "prim_chain" else prim_kernels.prim_chain_reference
    tot, deg = chain(dbar, unvis, n, lam)
    conn, bump = _conn_edges(dbar, unvis, cur, n, lam)
    return tot + conn, deg + bump


def _batched_mst_bound(dbar, pi, unvis, cur, p_cost, n, node_ascent=0, ascent_step=None,
                       lam_budget=None, mst_kernel: str = "prim"):
    """Reduced-cost MST + connection-edges lower bound for k nodes
    (``branch_bound.py:1013-1091``):

        prefix_cost + MST_dbar(U) + conn - pi[cur] - pi[0] - 2*sum(pi[U]),

    then ``node_ascent`` per-node subgradient steps on per-lane deltas
    ``lam`` (targets: cur/0 -> 1, U -> 2), keeping the best bound; each
    step is one more Prim chain. Float adds in the JAX package's order.
    """
    k = unvis.shape[0]
    val, deg = _mst_conn(dbar, unvis, cur, n, mst_kernel=mst_kernel)
    val = torch.where(torch.isfinite(val), val, INF)
    sum_pi_u = torch.where(unvis, pi[None, :], 0.0).sum(dim=1)
    best = p_cost + val - pi[cur] - pi[0] - 2.0 * sum_pi_u

    if node_ascent > 0:
        cities = torch.arange(n, device=dbar.device)
        icur = cities[None, :] == cur[:, None]
        i0 = cities[None, :] == 0
        in_s = unvis | icur | i0
        target = 2 * unvis.to(torch.int32) + icur.to(torch.int32) + i0.to(torch.int32)
        lam = torch.zeros((k, n), dtype=dbar.dtype, device=dbar.device) + p_cost[:, None] * 0
        for _ in range(node_ascent):
            g = torch.where(in_s, deg - target, 0).to(dbar.dtype)
            lam = torch.minimum(torch.maximum(lam + ascent_step * g, -lam_budget), lam_budget)
            val, deg = _mst_conn(dbar, unvis, cur, n, lam, mst_kernel=mst_kernel)
            val = torch.where(torch.isfinite(val), val, INF)
            lam_cur = lam.gather(1, cur[:, None])[:, 0]
            corr = (
                pi[cur] + lam_cur + pi[0] + lam[:, 0]
                + 2.0 * (sum_pi_u + torch.where(unvis, lam, 0.0).sum(dim=1))
            )
            best = torch.maximum(best, p_cost + val - corr)
    return best


# ---------------------------------------------------------------------------
# The expansion step
# ---------------------------------------------------------------------------


def _expand_step(fr: Frontier, inc_cost, inc_tour, d, bd: BoundData, k: int, n: int,
                 use_mst: bool = True, node_ascent: int = 0, mst_kernel: str = "prim",
                 push_order: str = "best-first", push_block: int = 0,
                 step_kernel: str = "reference"):
    """Pop <= k nodes, re-bound, expand, prune, push
    (``branch_bound.py:1108-1411``).

    ``step_kernel``: "reference" (build the ``[k*n, C]`` candidate block,
    compact it, write it at the stack top) or "fused" (``push_rows`` builds
    and stores only the pushed rows; the hand kernel on a CUDA device).
    Both share every screen, flag and destination, so the live prefix is
    bit-identical; only dead rows past the count can differ.

    Returns ``(frontier', inc_cost', inc_tour', popped)``. The frontier's
    node buffer is updated IN PLACE (the JAX step donates it); count and
    overflow are new 0-d tensors. Nothing here waits for the device
    (no host scalar becomes a device tensor, no data-dependent shape),
    except the ``n_push`` read that a ``push_block`` cap needs.
    """
    nodes = fr.nodes
    f_phys = nodes.shape[0]
    if f_phys <= k * n:
        raise ValueError(
            f"frontier buffer has {f_phys} rows but the push block needs "
            f"k*n = {k * n} (+>=1 logical slot); lower k or raise capacity"
        )
    if push_order not in ("best-first", "natural"):
        raise ValueError(f"unknown push_order {push_order!r} (expected best-first|natural)")
    if push_block < 0:
        raise ValueError(f"push_block must be >= 0, got {push_block}")
    if step_kernel not in ("reference", "fused"):
        raise ValueError(f"unknown step_kernel {step_kernel!r} (expected reference|fused)")
    if step_kernel == "fused" and push_block:
        raise ValueError("push_block is a reference-kernel knob; "
                         "step_kernel='fused' writes pushed rows only")
    dev = nodes.device
    integral = bd.integral
    f_cap = f_phys - k * n
    w = (n + 31) // 32
    pw = _path_words(n)
    kn = k * n
    lanes = torch.arange(k, dtype=torch.int32, device=dev)
    take = torch.clamp(fr.count, max=k)
    idx = torch.clamp(fr.count - 1 - lanes, min=0)
    live = lanes < take
    p = nodes[idx.long()]  # [k, P + W + 4]: the popped rows, a copy
    p_pathw = p[:, :pw]
    p_mask = p[:, pw : pw + w]
    p_depth = p[:, pw + w]
    p_cost = _f32(p[:, pw + w + 1])
    p_bound = _f32(p[:, pw + w + 2])
    p_sum = _f32(p[:, pw + w + 3])
    # pop-side re-prune against the current incumbent
    if integral:
        live = live & (p_bound <= inc_cost - 1.0)
    else:
        live = live & (p_bound < inc_cost)
    cur = _path_byte_get(p_pathw, torch.clamp(p_depth - 1, min=0)).long()

    word_idx, bit = _mask_consts(n, str(dev))
    unvis = ((p_mask[:, word_idx] >> bit[None, :]) & 1) == 0

    if use_mst:
        strong = _batched_mst_bound(
            bd.dbar, bd.pi, unvis, cur, p_cost, n, node_ascent, bd.ascent_step,
            bd.lam_budget, mst_kernel,
        ) - bd.slack
        if integral:
            live = live & (strong <= inc_cost - 1.0)
        else:
            live = live & (strong < inc_cost)

    feasible = unvis & live[:, None]
    ccost = p_cost[:, None] + d[cur]
    cbound = ccost + p_sum[:, None] + bd.bound_adj[None, :]
    if use_mst:
        # a parent's MST bound bounds every child too: keep the tighter one
        cbound = torch.maximum(cbound, strong[:, None])
    cdepth = p_depth[:, None] + 1

    # completions: the child is the last unvisited city -> close to 0
    is_complete = (cdepth == n) & feasible
    total = ccost + d[:, 0][None, :]
    comp_total = torch.where(is_complete, total, INF).reshape(-1)
    best_flat = comp_total.argmin()
    best_total = comp_total[best_flat]
    bi, bc = best_flat // n, (best_flat % n).to(torch.int32)
    new_inc_cost = torch.minimum(inc_cost, best_total)
    best_path = _unpack_path(p_pathw[bi], n).clone()
    best_path[torch.clamp(p_depth[bi], max=n - 1).long()] = bc
    cand_tour = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    cand_tour[:n] = best_path
    new_inc_tour = torch.where(best_total < inc_cost, cand_tour, inc_tour)

    # pushable children: feasible, not complete, bound under the incumbent
    if integral:
        push = feasible & ~is_complete & (cbound <= new_inc_cost - 1.0)
    else:
        push = feasible & ~is_complete & (cbound < new_inc_cost)
    child_sum = p_sum[:, None] - bd.min_out[None, :]

    flat_push = push.reshape(-1)
    if push_order == "natural":
        rank = torch.cumsum(flat_push.to(torch.int32), 0) - 1
    else:
        # two-level best-first order: children DESC by bound within each
        # parent, parents DESC by their best child; stable sorts, as jnp's
        keys = torch.where(push, cbound, -INF)
        child_ord = torch.argsort(-keys, dim=1, stable=True)
        best_child = torch.where(push, cbound, INF).amin(dim=1)
        parent_key = torch.where(torch.isfinite(best_child), best_child, -INF)
        parent_ord = torch.argsort(-parent_key, stable=True)
        ar_k = torch.arange(k, dtype=torch.int64, device=dev)
        inv_parent = torch.empty(k, dtype=torch.int64, device=dev)
        inv_parent[parent_ord] = ar_k
        inv_child = torch.empty((k, n), dtype=torch.int64, device=dev)
        inv_child.scatter_(1, child_ord, torch.arange(n, device=dev).expand(k, n).contiguous())
        prio = (inv_parent[:, None] * n + inv_child).reshape(-1)  # a permutation of [kn]
        flags_in_order = torch.empty(kn, dtype=torch.int64, device=dev)
        flags_in_order[prio] = flat_push.to(torch.int64)
        rank = torch.cumsum(flags_in_order, 0)[prio] - 1
    n_push = flat_push.sum().to(torch.int32)
    base = fr.count - take

    if step_kernel == "fused":
        # the fused push: destination rows from the same rank as the
        # reference push, pruned children parked at f_phys (not stored);
        # ``p`` is the gathered copy of the popped rows, since the
        # destinations start at count - take, the slots they came from
        dest = torch.where(flat_push, base + rank, f_phys).to(torch.int32).reshape(k, n)
        expand_kernels.push_rows(nodes, p, dest, ccost, cbound, child_sum, n)
    else:
        _reference_push(nodes, p, ccost, cbound, child_sum, flat_push, rank, base, n, push_block)

    new_count = base + n_push
    overflow = fr.overflow | (new_count > f_cap) | (base > f_phys - kn)
    new_count = torch.clamp(new_count, max=f_cap)
    return Frontier(nodes, new_count, overflow), new_inc_cost, new_inc_tour, take


def _reference_push(nodes, parents, ccost, cbound, child_sum, flat_push, rank, base, n: int,
                    push_block: int = 0) -> None:
    """The reference push, in place: the ``[k*n, C]`` candidate block in the
    packed layout, compacted in priority order (pushed candidate c to slot
    ``rank[c]``, the rest to one spare slot that is cut off), written as
    one contiguous block at row ``base`` (clamped into the buffer).
    ``push_block`` caps the block when every pushed row fits in it."""
    kn = flat_push.shape[0]
    dev = nodes.device
    cand = expand_kernels.child_rows(parents, _i32(ccost), _i32(cbound), _i32(child_sum), n)
    cand = cand.reshape(kn, -1)
    comp_idx = torch.zeros(kn + 1, dtype=torch.int64, device=dev)
    comp_idx.scatter_(0, torch.where(flat_push, rank, kn), torch.arange(kn, device=dev))
    rows = kn
    if push_block and push_block < kn and int(flat_push.sum()) <= push_block:
        rows = push_block  # capped write; every pushed row is inside it
    start = torch.clamp(base, max=nodes.shape[0] - rows)
    nodes.index_copy_(0, start.long() + torch.arange(rows, device=dev), cand[comp_idx[:rows]])


def _expand_loop(fr: Frontier, inc_cost, inc_tour, d, bd: BoundData, k: int, n: int,
                 inner_steps: int, **step_kw):
    """Up to ``inner_steps`` expansion steps, stopping when the frontier is
    empty (one count read per step). Returns (frontier, inc_cost,
    inc_tour, popped, steps run)."""
    popped = torch.zeros((), dtype=torch.int64, device=fr.nodes.device)
    steps = 0
    while steps < inner_steps and _read_count(fr)[0] > 0:
        fr, inc_cost, inc_tour, take = _expand_step(fr, inc_cost, inc_tour, d, bd, k, n, **step_kw)
        popped = popped + take
        steps += 1
    return fr, inc_cost, inc_tour, int(popped), steps


# ---------------------------------------------------------------------------
# The device loop: re-sort, compaction, the guarded steps
# ---------------------------------------------------------------------------

#: since the last :func:`reset_frontier_stats`: frontier re-sorts,
#: on-device compactions, and the largest count the loops read (the tests
#: and ``chip_smoke.py`` read them)
FRONTIER_STATS = {"reorders": 0, "compactions": 0, "peak_count": 0}


def reset_frontier_stats() -> None:
    for key in FRONTIER_STATS:
        FRONTIER_STATS[key] = 0


def _read_count(fr: Frontier, *flags) -> Tuple:
    """Count, overflow flag and any further 0-d bool ``flags`` in one
    device-to-host read."""
    cnt, *bits = torch.stack([fr.count] + [f.to(torch.int32) for f in (fr.overflow, *flags)]).tolist()
    FRONTIER_STATS["peak_count"] = max(FRONTIER_STATS["peak_count"], cnt)
    return (cnt, *map(bool, bits))


def _reorder_frontier(fr: Frontier, rows: Optional[int] = None) -> Frontier:
    """Re-sort the live stack so the lowest-bound node is on top (popped
    next), in place (``branch_bound.py:1488-1516``): bound DESC from the
    bottom, dead rows (-inf keys) past the live prefix; a stable argsort, as
    ``jnp.argsort``. ``rows`` limits the sort to the logical slots (None:
    the whole buffer)."""
    nodes = fr.nodes
    rows = nodes.shape[0] if rows is None else rows
    live = torch.arange(rows, device=nodes.device) < fr.count
    key = torch.where(live, _f32(nodes[:rows, -2]), -INF)
    perm = torch.argsort(-key, stable=True)
    nodes[:rows] = nodes[:rows][perm]
    FRONTIER_STATS["reorders"] += 1
    return Frontier(nodes, fr.count, fr.overflow)


def _compact_frontier(fr: Frontier, inc_cost, integral: bool,
                      rows: Optional[int] = None) -> Frontier:
    """Drop the nodes the incumbent has closed from the device stack, in
    place and in stable order (``branch_bound.py:1527-1552``). A gather
    ``new[j] = old[src[j]]``: ``src`` sends slot j to the j-th alive row,
    and slots past the alive count to themselves; the alive rows' slots
    come from a prefix sum scattered into a spare entry for the dead ones,
    so nothing waits for the device."""
    nodes = fr.nodes
    dev = nodes.device
    rows = nodes.shape[0] if rows is None else rows
    bound = _f32(nodes[:rows, -2])
    live = torch.arange(rows, device=dev) < fr.count
    if integral:
        alive = live & (bound <= inc_cost - 1.0)
    else:
        alive = live & (bound < inc_cost)
    slot = torch.where(alive, torch.cumsum(alive, 0) - 1, rows)
    src = torch.arange(rows + 1, device=dev)
    src.scatter_(0, slot, torch.arange(rows, device=dev))
    nodes[:rows] = nodes[src[:rows]]
    FRONTIER_STATS["compactions"] += 1
    return Frontier(nodes, alive.sum().to(torch.int32), fr.overflow)


def _guarded_expand_steps(fr: Frontier, inc_cost, inc_tour, d, bd: BoundData, k: int, n: int,
                          max_steps: int, reorder_every: int = 0, step0: int = 0,
                          deadline: Optional[float] = None, **step_kw):
    """Up to ``max_steps`` expansion steps with a per-step capacity guard
    (``branch_bound.py:1617-1702``): compact when the count passes
    ``f_cap - headroom``, and when compaction cannot get below that line,
    stop with the stack intact (the stopping iteration counts as a step),
    so the push never overflows. Every ``reorder_every`` run-global steps
    (``step0 + i``) the stack is re-sorted first.

    PyTorch has no device ``while_loop``, so this is a host loop with the
    JAX loop's semantics. The host reads count, overflow and whether the
    step improved the incumbent together, once per step (and the count once
    more after a compaction); so it also stops at the first step that ends
    past ``deadline`` (a ``time.perf_counter()`` value) and stamps the
    improvement's time itself, where the JAX loop sizes its runs by a
    measured step rate and interpolates the time to best. Returns
    ``(frontier, inc_cost, inc_tour, popped, steps, t_improved, expanded)``;
    ``t_improved`` is the ``perf_counter`` time of the last incumbent
    improvement, None if none; ``expanded`` counts the steps that expanded
    (all but a final stop on a full stack).
    """
    dev = fr.nodes.device
    f_cap = max(fr.nodes.shape[0] - k * n, 1)
    headroom = min(f_cap // 4, k * (n - 1))
    popped = torch.zeros((), dtype=torch.int64, device=dev)
    t_improved = None
    cnt, overflow = _read_count(fr)
    i = expanded = 0
    full = False
    while i < max_steps and cnt > 0 and not overflow and not full:
        if reorder_every and (step0 + i) % reorder_every == reorder_every - 1:
            fr = _reorder_frontier(fr, rows=f_cap)
        if cnt > f_cap - headroom:
            fr = _compact_frontier(fr, inc_cost, bd.integral, rows=f_cap)
            cnt = int(fr.count)
        full = cnt > f_cap - headroom
        i += 1
        if not full:
            ic_before = inc_cost
            fr, inc_cost, inc_tour, take = _expand_step(fr, inc_cost, inc_tour, d, bd, k, n, **step_kw)
            popped = popped + take
            expanded += 1
            cnt, overflow, improved = _read_count(fr, inc_cost < ic_before)
            if improved:
                t_improved = time.perf_counter()
            if deadline is not None and time.perf_counter() > deadline:
                break
    return fr, inc_cost, inc_tour, int(popped), i, t_improved, expanded


def _resolve_device_loop(device_loop: bool, auto: bool, capacity: int, k: int, n: int) -> bool:
    """The device loop's compaction floor ``capacity >= 4*k*(n-1)`` (one push
    batch of headroom per step): auto falls back to the host loop, an
    explicit request raises (``branch_bound.py:1954-1969``)."""
    if device_loop and capacity < 4 * k * (n - 1):
        if auto:
            return False
        raise ValueError(
            f"device_loop needs capacity >= 4*k*(n-1) = {4 * k * (n - 1)} "
            f"(got {capacity}); lower k or raise capacity"
        )
    return device_loop


def _dispatch_budget(remaining_units: int, int32_cap_units: int) -> int:
    """Step budget of one device-loop run (``branch_bound.py:1999-2038``):
    the remaining iterations and the steps at which the int32 node counter
    could overflow. The JAX package also caps a run by the clock, from a
    measured step rate; the port's loop reads the device every step, so
    :func:`_guarded_expand_steps` checks the deadline itself, on every
    device."""
    return max(min(remaining_units, int32_cap_units), 1)


# ---------------------------------------------------------------------------
# The host reservoir
# ---------------------------------------------------------------------------


@dataclass
class SpillStats:
    """Reservoir transfer accounting (``branch_bound.py:327-346``):
    exchange/refill rounds and events, full merges among them, and the
    bytes moved each way (live-prefix fetches down, kept slices up)."""

    rounds: int = 0
    events: int = 0
    full_merges: int = 0
    bytes_to_host: int = 0
    bytes_to_device: int = 0


def _np_bound_col(rows: np.ndarray) -> np.ndarray:
    """The float32 bound column of packed host rows (second to last)."""
    return np.ascontiguousarray(rows[..., -2]).view(np.float32)


def _fetch_live_rows(nodes: torch.Tensor, cnt: int) -> np.ndarray:
    """The one device-to-host fetch of a spill: only the live prefix of the
    frontier buffer, copied so it never aliases the buffer."""
    return nodes[:cnt].cpu().numpy().copy()


class _Reservoir:
    """Host overflow store for frontier nodes: packed numpy chunks in the
    frontier's row layout (``branch_bound.py:1737-1927``). When the device
    stack nears capacity its rows are re-partitioned with the reservoir and
    the best-bound half goes back; when the stack empties, nodes flow back.
    A node is dropped only by a certified bound check."""

    def __init__(self, stats: Optional[SpillStats] = None):
        self.chunks: list = []
        self.stats = stats if stats is not None else SpillStats()

    def __len__(self) -> int:
        return sum(int(c.shape[0]) for c in self.chunks)

    def min_bound(self) -> float:
        """Min bound over every spilled node (inf when empty)."""
        mins = [float(_np_bound_col(c).min()) for c in self.chunks if c.shape[0]]
        return min(mins) if mins else float("inf")

    def prune(self, inc_cost: float, integral: bool) -> None:
        """Drop incumbent-closed rows chunk by chunk (no concatenate)."""
        out = []
        for c in self.chunks:
            b = _np_bound_col(c)
            alive = b <= inc_cost - 1.0 if integral else b < inc_cost
            if alive.all():
                out.append(c)
            elif alive.any():
                out.append(c[alive])
        self.chunks = out

    def refill(self, fr: Frontier, inc_cost: float, integral: bool, capacity: int) -> Frontier:
        """Reload up to half the logical ``capacity`` onto an empty device
        stack, written in place over the dead rows of the buffer."""
        keep = self._partition(None, inc_cost, integral, capacity)
        if keep is None:
            return fr
        take = keep.shape[0]
        self.stats.rounds += 1
        self.stats.events += 1
        self.stats.bytes_to_device += keep.nbytes
        fr.nodes[:take].copy_(torch.from_numpy(keep))
        return Frontier(fr.nodes, _count_like(fr.count, take), fr.overflow)

    def _partition(self, extra, inc_cost, integral, capacity: int):
        """Merge ``extra`` rows (or None) with every spilled chunk, drop the
        incumbent-closed ones, keep the best-bound ``min(alive, capacity //
        2)`` rows (stack order: worst at the bottom) and re-spill the rest.
        Selection by argpartition; only the kept rows are sorted."""
        chunks = self.chunks if extra is None else self.chunks + [extra]
        self.chunks = []
        chunks = [c for c in chunks if c.shape[0]]
        if not chunks:
            return None
        merged = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        bounds = _np_bound_col(merged)
        alive = bounds <= inc_cost - 1.0 if integral else bounds < inc_cost
        merged = merged[alive]
        bounds = bounds[alive]
        m = merged.shape[0]
        take = min(m, capacity // 2)
        if take == 0:
            if m:
                self.chunks.append(merged)  # no device slots: stay spilled
            return None
        if take < m:
            sel = np.argpartition(bounds, take - 1)[:take]
            rest = np.ones(m, bool)
            rest[sel] = False
            self.chunks.append(merged[rest])
            merged = merged[sel]
            bounds = bounds[sel]
        return merged[np.argsort(-bounds, kind="stable")]

    def exchange(self, fr: Frontier, inc_cost: float, integral: bool, capacity: int) -> Frontier:
        """Fetch the live prefix and re-partition: when the reservoir holds
        the global alive minimum, merge everything and put the best-bound
        ``capacity // 2`` back on the device; else keep the best half of the
        live rows only and spill the rest. Only the kept slice goes up."""
        cnt = int(fr.count)
        live = _fetch_live_rows(fr.nodes, cnt)
        lb = _np_bound_col(live)
        alive_lb = lb[lb <= inc_cost - 1.0] if integral else lb[lb < inc_cost]
        live_min = float(alive_lb.min()) if alive_lb.size else float("inf")
        merge = not (cnt and self.min_bound() >= live_min)
        self.stats.rounds += 1
        self.stats.events += 1
        self.stats.full_merges += int(merge)
        self.stats.bytes_to_host += live.nbytes
        if merge:
            keep = self._partition(live, inc_cost, integral, capacity)
        else:
            keep = self._keep_live_only(live, inc_cost, integral, capacity)
        if keep is None:
            return Frontier(fr.nodes, _count_like(fr.count, 0), fr.overflow)
        take = keep.shape[0]
        self.stats.bytes_to_device += keep.nbytes
        fr.nodes[:take].copy_(torch.from_numpy(keep))
        return Frontier(fr.nodes, _count_like(fr.count, take), fr.overflow)

    def _keep_live_only(self, live, inc_cost, integral, capacity: int):
        """Best-half select over the live rows only; the cut rows join the
        reservoir, whose chunks are never touched."""
        saved, self.chunks = self.chunks, []
        keep = self._partition(live, inc_cost, integral, capacity)
        saved.extend(self.chunks)
        self.chunks = saved
        return keep


def _count_like(count: torch.Tensor, value: int) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=count.device)


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------


def make_root_frontier(n: int, capacity: int, min_out: np.ndarray, device="cuda",
                       pad_rows: int = 0) -> Frontier:
    """Root frontier: ``capacity`` logical slots plus ``pad_rows`` rows of
    push padding (solve passes k*n), built on ``device``. The root is
    {path 0, city 0 visited, depth 1, cost 0, bound 0, sum_min}."""
    w = (n + 31) // 32
    pw = _path_words(n)
    row0 = np.zeros(pw + w + 4, np.int32)
    row0[pw] = 1  # mask word 0: city 0 visited
    row0[pw + w] = 1  # depth
    row0[pw + w + 3] = np.float32(min_out[1:].sum()).view(np.int32)
    nodes = torch.zeros((capacity + pad_rows, pw + w + 4), dtype=torch.int32, device=device)
    nodes[0] = torch.as_tensor(row0, device=device)
    return Frontier(
        nodes,
        torch.tensor(1, dtype=torch.int32, device=device),
        torch.tensor(False, device=device),
    )


def _spill_headroom(capacity: int, inner_steps: int, k: int, n: int) -> int:
    """Spill before one inner batch could overflow the stack (each step
    pushes at most k*(n-1) children); small capacities keep the top half."""
    return min(capacity // 2, max(1, inner_steps) * k * (n - 1))


def _final_lower_bound(proven: bool, cost: float, root_lb: float, open_bounds,
                       reservoir: Optional[_Reservoir] = None, overflow: bool = False) -> float:
    """Certified global lower bound at stop: the proven cost, or the min
    bound over the still-open nodes (device frontier and host reservoir),
    floored at the root bound and capped at the incumbent; after an
    overflow only the root bound is certified."""
    if proven:
        return cost
    if overflow:
        return min(root_lb, cost)
    mins = [float(b.min()) for b in open_bounds if b.size]
    if reservoir is not None and len(reservoir):
        mins.append(reservoir.min_bound())
    lb = min(mins) if mins else cost
    return min(max(lb, root_lb), cost)


def _resolve_step_kernel(step_kernel: str, device) -> str:
    """``auto`` -> the fused push on a CUDA device, the reference on the CPU."""
    if step_kernel not in STEP_KERNELS:
        raise ValueError(f"unknown step_kernel {step_kernel!r} (expected one of {STEP_KERNELS})")
    if step_kernel == "auto":
        return "fused" if torch.device(device).type == "cuda" else "reference"
    return step_kernel


def solve(
    d: np.ndarray,
    capacity: int = 1 << 17,
    k: int = 256,
    inner_steps: int = 32,
    max_iters: int = 200_000,
    time_limit_s: Optional[float] = None,
    target_cost: Optional[float] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    bound: str = "one-tree",
    mst_prune: bool = True,
    ils_rounds: Optional[int] = None,
    node_ascent: int = 2,
    device_loop: Optional[bool] = None,
    ascent: str = "host",
    reorder_every: int = 0,
    mst_kernel: str = "auto",
    push_order: str = "best-first",
    push_block: int = 0,
    step_kernel: str = "auto",
    device="cuda",
) -> BnBResult:
    """Exact B&B on one device; ``d`` is a dense [n, n] distance matrix.

    ``branch_bound.solve`` of the JAX package, single device: bound setup
    on the host, the incumbent and the search on ``device``. Stops when the
    frontier and the host reservoir are both empty (proven optimal) or at
    ``max_iters`` / ``time_limit_s`` / ``target_cost`` (then best so far).

    ``device_loop``: None is on for a CUDA device and off for the CPU. On,
    the steps run under :func:`_guarded_expand_steps` (compaction and a stop
    before the stack could overflow, then a reservoir exchange); off, in
    batches of ``inner_steps`` with a reservoir exchange when a batch could
    overflow. ``reorder_every`` re-sorts the stack best-bound-first every
    that many steps. ``step_kernel`` and ``mst_kernel`` "auto" pick the
    hand kernels on a CUDA device and the plain versions on the CPU.
    Checkpoints, resume and ``ascent="device"`` raise ``ValueError``.
    """
    t_setup = time.perf_counter()
    n = d.shape[0]
    if not 3 <= n <= MAX_BNB_CITIES:
        raise ValueError(f"B&B engine supports 3 <= n <= {MAX_BNB_CITIES} cities, got {n}")
    if checkpoint_path or checkpoint_every or resume_from:
        _not_ported("checkpoint/resume")
    if ascent != "host":
        _not_ported(f"ascent={ascent!r}")
    device = torch.device(device)
    mst_kernel = _resolve_mst_kernel(mst_kernel, device)
    step_kernel = _resolve_step_kernel(step_kernel, device)
    auto_loop = device_loop is None
    if auto_loop:
        device_loop = device.type == "cuda"
    device_loop = _resolve_device_loop(bool(device_loop), auto_loop, capacity, k, n)

    d32 = torch.as_tensor(np.asarray(d, np.float32), device=device)
    t_asc = time.perf_counter()
    bd = _bound_setup(d, bound, node_ascent=node_ascent, device=device)
    ascent_s = time.perf_counter() - t_asc
    min_out_np = bd.min_out.cpu().numpy().astype(np.float64)
    integral = bd.integral

    t_ils = time.perf_counter()
    inc_tour_np = _initial_incumbent(d, ils_rounds, device)
    ils_s = time.perf_counter() - t_ils
    inc_cost = torch.tensor(tour_cost(np.asarray(d, np.float64), inc_tour_np),
                            dtype=torch.float32, device=device)
    inc_tour = torch.as_tensor(inc_tour_np, dtype=torch.int32, device=device)
    fr = make_root_frontier(n, capacity, min_out_np, device=device, pad_rows=k * n)
    headroom = _spill_headroom(capacity, inner_steps, k, n)
    spill_stats = SpillStats()
    reservoir = _Reservoir(stats=spill_stats)

    step_kw = dict(use_mst=mst_prune, node_ascent=node_ascent, mst_kernel=mst_kernel,
                   push_order=push_order, push_block=push_block, step_kernel=step_kernel)
    inner = max(1, inner_steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_setup
    t_best = 0.0
    last_inc = float(inc_cost)
    last_pruned = last_inc  # reservoir GC high-water mark
    nodes = it = steps_run = 0
    last_reorder = 0
    deadline = None if time_limit_s is None else t0 + time_limit_s
    while it < max_iters:
        if device_loop:
            budget = _dispatch_budget(max_iters - it, (2**31 - 1) // max(k, 1))
            fr, inc_cost, inc_tour, popped, steps, t_improved, expanded = _guarded_expand_steps(
                fr, inc_cost, inc_tour, d32, bd, k, n, budget, reorder_every, it, deadline, **step_kw
            )
            nodes += popped
            steps_run += expanded
            if t_improved is not None:
                last_inc = float(inc_cost)
                t_best = t_improved - t0
            it += max(steps, 1)
            if bool(fr.overflow):
                break  # exactness already lost (only if the guard was bypassed)
        else:
            fr, inc_cost, inc_tour, popped, steps = _expand_loop(
                fr, inc_cost, inc_tour, d32, bd, k, n, inner, **step_kw
            )
            nodes += popped
            steps_run += steps
            it += inner
        cnt = int(fr.count)
        ic = float(inc_cost)
        if ic < last_inc:
            last_inc = ic
            t_best = time.perf_counter() - t0
        if len(reservoir) and last_inc < last_pruned:
            reservoir.prune(last_inc, integral)
            last_pruned = last_inc
        if cnt == 0 and len(reservoir):
            fr = reservoir.refill(fr, ic, integral, capacity)
            cnt = int(fr.count)
        elif cnt > capacity - headroom:
            fr = reservoir.exchange(fr, ic, integral, capacity)
            cnt = int(fr.count)
        if reorder_every and not device_loop and it - last_reorder >= reorder_every:
            fr = _reorder_frontier(fr, rows=capacity)
            last_reorder = it
        if cnt == 0:
            break
        if time_limit_s is not None and time.perf_counter() - t0 > time_limit_s:
            break
        if target_cost is not None and ic <= target_cost:
            break
    wall = time.perf_counter() - t0
    count = int(fr.count)
    overflow = bool(fr.overflow)
    proven = count == 0 and len(reservoir) == 0 and not overflow
    lb_raw = _final_lower_bound(proven, float(inc_cost), bd.root_lb,
                                [fr.bound[:count].cpu().numpy()], reservoir, overflow=overflow)
    return BnBResult(
        cost=float(inc_cost),
        tour=inc_tour.cpu().numpy(),
        nodes_expanded=nodes,
        iterations=it,
        proven_optimal=proven,
        wall_seconds=wall,
        nodes_per_sec=nodes / wall if wall > 0 else 0.0,
        time_to_best=t_best,
        root_lower_bound=bd.root_lb,
        lower_bound=min(lb_raw, float(inc_cost)),
        setup_seconds=setup_s,
        ascent_seconds=ascent_s,
        ils_seconds=ils_s,
        lower_bound_raw=lb_raw,
        spill_rounds=spill_stats.rounds,
        spill_events=spill_stats.events,
        spill_full_merges=spill_stats.full_merges,
        spill_bytes_to_host=spill_stats.bytes_to_host,
        spill_bytes_to_device=spill_stats.bytes_to_device,
        steps_run=steps_run,
        mst_kernel=mst_kernel,
        step_kernel=step_kernel,
        device_loop=device_loop,
    )
