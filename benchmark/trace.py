"""The ``--trace 1`` run's device trace: ``torch.profiler`` (CUPTI on the
card) over the first calls of the window, reduced to what the per-layer
metrics and the result's ``breakdown`` read.

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, fills) inside the traced window, ``window_s`` its length.
- ``kernels``: launches and summed device seconds by kernel name.
- ``gaps``: the device's idle seconds inside the window, labelled by what
  the host was doing: the benchmark's own span around each call, and the
  phases inside it that the call's result reports (its own timing
  fields, placed from the call's start).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)
    calls: int = 0

    def kernel(self, part: str) -> Tuple[int, float]:
        """Launches and device seconds of every kernel whose name holds
        ``part``."""
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if part in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(((k, t) for k, (_, t) in self.kernels.items()), key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[k[:160], t] for k, t in ops], "idle_gaps": [[k, t] for k, t in gaps]}


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`; :meth:`span` marks a
    call on the host timeline."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.device = device
        self.prof = profile(activities=acts)
        self._window = None

    def start(self) -> None:
        self.prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self.prof.stop()

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(name)

    def summarize(self, span: str, answers: List[dict], phases: Callable[[dict], list]) -> TraceSummary:
        host, dev = _events(self.prof)
        win = [(s, e) for name, s, e in host if name == WINDOW]
        if not win:
            raise RuntimeError("trace: the window's span is missing")
        ws, we = win[0]
        calls = sorted((int(name.split("#")[1]), s, e) for name, s, e in host if name.startswith(span + "#"))
        dev = [(name, max(s, ws), min(e, we)) for name, s, e in dev
               if e > ws and s < we and name != WINDOW and not name.startswith(span + "#")]
        kernels: Dict[str, List[float]] = {}
        for name, s, e in dev:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) * 1e-9
        busy, gaps = _union_and_gaps([(s, e) for _, s, e in dev], ws, we)
        labels = _labels(calls, answers, phases, span)
        starts = [s for s, _, _ in labels]
        idle: Dict[str, float] = {}
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            j = bisect.bisect_right(starts, mid) - 1
            name = labels[j][2] if j >= 0 and labels[j][1] > mid else "harness"
            idle[name] = idle.get(name, 0.0) + (ge - gs) * 1e-9
        return TraceSummary(window_s=(we - ws) * 1e-9, busy_s=busy * 1e-9,
                            kernels={k: (int(c), t) for k, (c, t) in kernels.items()}, gaps=idle,
                            calls=len(calls))


def _events(prof) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """(host spans, device activities) as (name, start ns, end ns)."""
    host, dev = [], []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            s = int(e.start_ns())
            rec = (e.name(), s, s + int(e.duration_ns()))
            on_dev = e.device_type() == torch.autograd.DeviceType.CUDA
            if on_dev and e.is_user_annotation():
                continue  # a host span's shadow on the device timeline, not device work
            (dev if on_dev else host).append(rec)
    except AttributeError:
        for e in prof.events():
            rec = (e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000))
            on_dev = e.device_type == torch.autograd.DeviceType.CUDA
            if on_dev and getattr(e, "is_user_annotation", False):
                continue
            (dev if on_dev else host).append(rec)
    return host, dev


def _union_and_gaps(iv: List[Tuple[int, int]], ws: int, we: int):
    """Length of the union of intervals inside [ws, we] and the gaps
    between them."""
    iv.sort()
    busy, gaps, cur = 0, [], ws
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if we > cur:
        gaps.append((cur, we))
    return busy, gaps


def _labels(calls, answers, phases, span) -> List[Tuple[int, int, str]]:
    """Sorted, disjoint (start, end, label) host intervals: each call's
    phases, and the call's own span where no phase covers it."""
    out = []
    for idx, s, e in calls:
        last = s
        if idx < len(answers) and answers[idx] is not None:
            for name, a, b in phases(answers[idx]):
                ps, pe = max(s + int(a * 1e9), last), min(s + int(b * 1e9), e)
                if pe > ps:
                    if ps > last:
                        out.append((last, ps, span))
                    out.append((ps, pe, name))
                    last = pe
        if e > last:
            out.append((last, e, span))
    return out
