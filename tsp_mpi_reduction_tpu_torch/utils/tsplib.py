"""TSPLIB95 instance loader (north-star extension, SURVEY.md §7 step 7).

The port's own copy of ``tsp_mpi_reduction_tpu/utils/tsplib.py`` (plain
numpy, no JAX), so the port never imports the JAX package.

The reference has no file-based instances — its only input is the random
generator (tsp.cpp:373-403). The north star asks for TSPLIB B&B mode
(BASELINE.json configs: burma14, ulysses22, eil51, berlin52, kroA100,
pr124), so this implements the TSPLIB95 format: NODE_COORD_SECTION /
EDGE_WEIGHT_SECTION parsing and the spec's distance functions (EUC_2D,
CEIL_2D, MAX_2D, MAN_2D, GEO, ATT, EXPLICIT full/triangular matrices).

Distance semantics follow the TSPLIB95 spec (integer-valued metrics via
nint/ceil as specified). The solver reads no instance files at run time
beyond what it is given; the embedded instances (``burma14`` below and
``tsplib_data``) have their optima re-derived by the exact solver in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

#: Known optimal tour lengths (TSPLIB95 published results) — used for
#: time-to-optimal reporting, never as inputs to the solver.
KNOWN_OPTIMA: Dict[str, int] = {
    "burma14": 3323,
    "ulysses16": 6859,
    "ulysses22": 7013,
    "gr17": 2085,
    "gr21": 2707,
    "gr24": 1272,
    "fri26": 937,
    "bayg29": 1610,
    "bays29": 2020,
    "dantzig42": 699,
    "att48": 10628,
    "eil51": 426,
    "berlin52": 7542,
    "st70": 675,
    "eil76": 538,
    "kroA100": 21282,
    "kroB100": 22141,
    "pr124": 59030,
}


@dataclass
class TSPLIBInstance:
    name: str
    dimension: int
    edge_weight_type: str
    comment: str = ""
    coords: Optional[np.ndarray] = None  # [n, 2] raw file coordinates
    matrix: Optional[np.ndarray] = None  # explicit weights, if given
    meta: Dict[str, str] = field(default_factory=dict)

    def distance_matrix(self) -> np.ndarray:
        """Dense [n, n] integer distance matrix per the TSPLIB95 metric."""
        if self.matrix is not None:
            return self.matrix.astype(np.int64)
        if self.coords is None:
            raise ValueError(f"{self.name}: no coords and no explicit matrix")
        fn = _METRICS.get(self.edge_weight_type)
        if fn is None:
            raise ValueError(f"unsupported EDGE_WEIGHT_TYPE {self.edge_weight_type}")
        return fn(self.coords)

    @property
    def known_optimum(self) -> Optional[int]:
        return KNOWN_OPTIMA.get(self.name)


def _nint(x: np.ndarray) -> np.ndarray:
    return np.floor(x + 0.5).astype(np.int64)


def _euc_2d(c: np.ndarray) -> np.ndarray:
    d = c[:, None, :] - c[None, :, :]
    return _nint(np.sqrt((d * d).sum(-1)))


def _ceil_2d(c: np.ndarray) -> np.ndarray:
    d = c[:, None, :] - c[None, :, :]
    return np.ceil(np.sqrt((d * d).sum(-1))).astype(np.int64)


def _max_2d(c: np.ndarray) -> np.ndarray:
    d = np.abs(c[:, None, :] - c[None, :, :])
    return np.maximum(_nint(d[..., 0]), _nint(d[..., 1]))


def _man_2d(c: np.ndarray) -> np.ndarray:
    d = np.abs(c[:, None, :] - c[None, :, :])
    return _nint(d.sum(-1))


def _att(c: np.ndarray) -> np.ndarray:
    d = c[:, None, :] - c[None, :, :]
    r = np.sqrt((d * d).sum(-1) / 10.0)
    t = _nint(r)
    return np.where(t < r, t + 1, t).astype(np.int64)


def _geo(c: np.ndarray) -> np.ndarray:
    # TSPLIB95: coordinates are DDD.MM (degrees.minutes)
    pi = 3.141592
    deg = np.trunc(c)
    minutes = c - deg
    rad = pi * (deg + 5.0 * minutes / 3.0) / 180.0
    lat, lon = rad[:, 0], rad[:, 1]
    rrr = 6378.388
    q1 = np.cos(lon[:, None] - lon[None, :])
    q2 = np.cos(lat[:, None] - lat[None, :])
    q3 = np.cos(lat[:, None] + lat[None, :])
    arg = np.clip(0.5 * ((1.0 + q1) * q2 - (1.0 - q1) * q3), -1.0, 1.0)
    m = (rrr * np.arccos(arg) + 1.0).astype(np.int64)
    np.fill_diagonal(m, 0)  # the formula yields int(0 + 1.0) = 1 on i == j
    return m


_METRICS = {
    "EUC_2D": _euc_2d,
    "CEIL_2D": _ceil_2d,
    "MAX_2D": _max_2d,
    "MAN_2D": _man_2d,
    "ATT": _att,
    "GEO": _geo,
}


def parse(text: str) -> TSPLIBInstance:
    """Parse a .tsp file's contents."""
    meta: Dict[str, str] = {}
    lines = [ln.strip() for ln in text.splitlines()]
    i = 0
    coords = None
    weights: List[float] = []
    while i < len(lines):
        ln = lines[i]
        if not ln or ln == "EOF":
            i += 1
            continue
        if ":" in ln and not ln.split(":")[0].strip().endswith("SECTION"):
            key, _, val = ln.partition(":")
            meta[key.strip().upper()] = val.strip()
            i += 1
            continue
        section = ln.split(":")[0].strip().upper()
        if section == "NODE_COORD_SECTION" or section == "DISPLAY_DATA_SECTION":
            n = int(meta["DIMENSION"])
            rows = []
            for j in range(n):
                parts = lines[i + 1 + j].split()
                rows.append((float(parts[1]), float(parts[2])))
            if section == "NODE_COORD_SECTION":
                coords = np.asarray(rows, dtype=np.float64)
            i += n + 1
            continue
        if section == "EDGE_WEIGHT_SECTION":
            i += 1
            while i < len(lines) and lines[i] and not lines[i][0].isalpha():
                weights.extend(float(x) for x in lines[i].split())
                i += 1
            continue
        i += 1  # unknown section/keyword lines are skipped

    n = int(meta["DIMENSION"])
    ewt = meta.get("EDGE_WEIGHT_TYPE", "EUC_2D").upper()
    matrix = None
    if ewt == "EXPLICIT":
        matrix = _assemble_matrix(
            np.asarray(weights), n, meta.get("EDGE_WEIGHT_FORMAT", "FULL_MATRIX").upper()
        )
    return TSPLIBInstance(
        name=meta.get("NAME", "unnamed"),
        dimension=n,
        edge_weight_type=ewt,
        comment=meta.get("COMMENT", ""),
        coords=coords,
        matrix=matrix,
        meta=meta,
    )


def _assemble_matrix(w: np.ndarray, n: int, fmt: str) -> np.ndarray:
    m = np.zeros((n, n), dtype=np.int64)
    wi = iter(w.astype(np.int64))
    if fmt == "FULL_MATRIX":
        m = w.astype(np.int64).reshape(n, n)
    elif fmt in ("UPPER_ROW", "UPPER_DIAG_ROW"):
        diag = fmt == "UPPER_DIAG_ROW"
        for r in range(n):
            for c in range(r if diag else r + 1, n):
                m[r, c] = next(wi)
        m = m + m.T - np.diag(np.diag(m))
    elif fmt in ("LOWER_ROW", "LOWER_DIAG_ROW"):
        diag = fmt == "LOWER_DIAG_ROW"
        for r in range(n):
            for c in range(0, (r + 1) if diag else r):
                m[r, c] = next(wi)
        m = m + m.T - np.diag(np.diag(m))
    else:
        raise ValueError(f"unsupported EDGE_WEIGHT_FORMAT {fmt}")
    return m


def load(path) -> TSPLIBInstance:
    with open(path) as f:
        return parse(f.read())


# --- embedded fixture: burma14 (smallest classic GEO instance) ---
# 14 Burmese cities, optimum 3323; the only instance small enough to embed
# from public knowledge and self-validate via the exact solver in tests.
BURMA14 = """NAME: burma14
TYPE: TSP
COMMENT: 14-Staedte in Burma (Zaw Win)
DIMENSION: 14
EDGE_WEIGHT_TYPE: GEO
EDGE_WEIGHT_FORMAT: FUNCTION
DISPLAY_DATA_TYPE: COORD_DISPLAY
NODE_COORD_SECTION
   1  16.47       96.10
   2  16.47       94.44
   3  20.09       92.54
   4  22.39       93.37
   5  25.23       97.24
   6  22.00       96.05
   7  20.47       97.02
   8  17.20       96.29
   9  16.30       97.38
  10  14.05       98.12
  11  16.53       97.38
  12  21.52       95.59
  13  19.41       97.13
  14  20.09       94.55
EOF
"""


def burma14() -> TSPLIBInstance:
    return parse(BURMA14)


def embedded(name: str) -> TSPLIBInstance:
    """Load an embedded instance by TSPLIB name (see utils.tsplib_data).

    Every embedded coordinate set is validated against its published
    optimum by tests/test_tsplib.py (exact proof or bound bracketing) —
    see the tsplib_data module docstring.
    """
    try:
        return parse(EMBEDDED[name])
    except KeyError:
        raise KeyError(
            f"no embedded instance {name!r}; available: {sorted(EMBEDDED)}"
        ) from None


def resolve_instance(spec: str) -> TSPLIBInstance:
    """One instance-spec resolver for every driver (``tools/bnb_solve.py``,
    ``tools/bnb_chunked.py``): an embedded name, a ``random:N[:SEED]``
    synthetic spec, or a TSPLIB file path. Raises ValueError for a
    malformed random spec, OSError for an unreadable path — callers turn
    both into usage errors. Critically, the SAME resolver in the chunk
    driver and the chunk solver means fingerprint pre-flight checks
    (resilience.checkpoint) compare byte-identical distance matrices."""
    if spec in EMBEDDED:
        return embedded(spec)
    if spec.startswith("random:"):
        parts = spec.split(":")
        try:
            n_cities = int(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (ValueError, IndexError):
            raise ValueError(
                f"bad random instance spec {spec!r}: want random:N[:SEED]"
            ) from None
        if n_cities < 3:
            raise ValueError(f"bad random instance spec {spec!r}: need at least 3 cities")
        rng = np.random.default_rng(seed)
        xy = rng.uniform(0, 1000, (n_cities, 2))
        return TSPLIBInstance(
            name=f"random{n_cities}s{seed}",
            dimension=n_cities,
            edge_weight_type="EUC_2D",
            comment=f"uniform random {n_cities} cities, seed {seed}",
            coords=xy,
        )
    return load(spec)


def _ulysses16_text() -> str:
    """ulysses16 is, by TSPLIB construction, the first 16 ulysses22 cities."""
    from . import tsplib_data

    lines = tsplib_data.ULYSSES22.splitlines()
    head = [
        "NAME: ulysses16",
        "TYPE: TSP",
        "COMMENT: Odyssey of Ulysses (Groetschel/Padberg)",
        "DIMENSION: 16",
        "EDGE_WEIGHT_TYPE: GEO",
        "NODE_COORD_SECTION",
    ]
    coords = [ln for ln in lines if ln.strip() and ln.strip()[0].isdigit()][:16]
    return "\n".join(head + coords + ["EOF", ""])


def _build_embedded() -> Dict[str, str]:
    from . import tsplib_data

    return {
        "burma14": BURMA14,
        "ulysses16": _ulysses16_text(),
        "ulysses22": tsplib_data.ULYSSES22,
        "eil51": tsplib_data.EIL51,
        "berlin52": tsplib_data.BERLIN52,
        "kroA100": tsplib_data.KROA100,
    }


EMBEDDED: Dict[str, str] = _build_embedded()
