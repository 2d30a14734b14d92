"""Device selection and the dtype policy: ``--backend={auto,cuda,cpu}``.

``auto`` and ``cuda`` both demand a CUDA device and raise when there is
none: the port never falls back to the CPU on its own. ``cpu`` is the
explicit host mode the tests use.

Default dtype: float64 on the CPU (oracle parity), float32 on CUDA (speed
mode). float64 stays available on CUDA, where it is native.
"""

from __future__ import annotations

import torch

BACKENDS = ("auto", "cuda", "cpu")


def resolve_device(backend: str = "auto") -> torch.device:
    """Map a ``--backend`` name to a ``torch.device``; no fallback."""
    backend = backend.lower()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--backend={backend} needs a CUDA device and none is available; "
            "pass --backend=cpu to run on the host"
        )
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def parse_dtype(name) -> torch.dtype:
    """``"float64"``/``"float32"`` (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        if name not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {name}")
        return name
    table = {"float64": torch.float64, "float32": torch.float32}
    if name not in table:
        raise ValueError(f"dtype must be float32 or float64, got {name!r}")
    return table[name]


def synchronize(device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
