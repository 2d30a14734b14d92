"""One run of one cell: load, warm up, measure for ``--seconds``, judge the
answers, print the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration's file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, which names the driver, ``drivers/<driver>.py``),
and one reader a metric (``metrics/<metric>.py``, a function ``read(run)``
that returns a number or None). Adding a cell, a mix, a driver or a metric
adds files and edits none.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

from . import instances

ROOT = instances.ROOT
HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tsp_mpi_reduction_tpu")


class SpecError(ValueError):
    """A cell, configuration, traffic mix, driver or metric that is not
    where its name says."""


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"{what}: no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(spec: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and metrics,
    each read from its own file. Raises :class:`SpecError` for anything
    missing."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"cell {name!r} names config {w['config']!r}, which BENCHMARK.json lacks")
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]), f"config {w['config']!r}")
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"), f"traffic {w['traffic']!r}")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    for m in e2e + layer:
        metric_reader(m["name"])
    driver_module(traffic["driver"])
    return Cell(w, config, traffic, e2e, layer)


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"metric {name!r}: no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(name: str):
    if not os.path.isfile(os.path.join(HERE, "drivers", f"{name}.py")):
        raise SpecError(f"driver {name!r}: no file drivers/{name}.py")
    return importlib.import_module(f"benchmark.drivers.{name}")


@dataclass
class Run:
    """What a run hands the metric readers."""

    cell: Cell
    seconds: float  # the measured window
    answers: List[dict]  # the window's completed calls
    setup_s: float
    trace: Optional[object] = None  # trace.TraceSummary


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name and power limit (``nvidia-smi``), or the CPU."""
    import torch

    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        limit = out[device.index or 0].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"kind": torch.cuda.get_device_name(device), "power_limit": limit}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, log=sys.stderr) -> dict:
    """Set up, warm up, measure, judge; returns the result object."""
    import torch

    from .trace import Tracer

    device = torch.device(device)
    drv = driver_module(cell.traffic["driver"]).Driver(cell.config, cell.traffic, seed, device)
    pool = int(math.ceil(seconds * float(cell.traffic["calls_per_s_max"]))) + 1
    inputs = drv.inputs(instances.WINDOW, 0, pool)
    drv.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    answers: List[Optional[dict]] = []
    failed = errors = 0

    def call(i: int) -> None:
        nonlocal failed, errors, inputs
        if len(inputs) <= i:  # more calls than the pool foresaw
            inputs += drv.inputs(instances.WINDOW, len(inputs), len(inputs))
        try:
            a = drv.call(inputs[i])
            answers.append(a)
            failed += int(drv.failed(a))
        except Exception as exc:  # a call that raises is a failed call; the window goes on
            errors += 1
            failed += 1
            answers.append(None)
            if errors <= 3:
                print(f"benchmark: call {i} raised {type(exc).__name__}: {exc}", file=log)

    setup_s = process_age_s()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        call(len(answers))
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    in_window = len(answers)
    # the trace covers calls of their own after the window, so that the
    # window's calls and the program's timing fields carry no profiler cost
    tracer = None
    if trace:
        tracer = Tracer(device)
        tracer.start()
        for _ in range(int(cell.traffic["trace_calls"])):
            with tracer.span(f"{drv.span}#{len(answers)}"):
                call(len(answers))
        tracer.stop()
    attempted = len(answers)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_reserved(device))
    else:
        peak = 0
    done = [a for a in answers if a is not None]
    window_done = [a for a in answers[:in_window] if a is not None]
    # the program's state goes before the reference runs
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check(done, [inp for inp, a in zip(inputs, answers) if a is not None])
    t_check = time.perf_counter() - t_check
    if errors:
        checks.append(("errors", float(errors), 0.0))
    correct = all(v <= lim for _, v, lim in checks)

    t_trace = time.perf_counter()
    summary = tracer.summarize(drv.span, answers, drv.phases) if tracer else None
    t_trace = time.perf_counter() - t_trace
    info = card(device)
    print(f"benchmark: {info['kind']}, power limit {info['power_limit']}", file=log)
    print(f"benchmark: setup {setup_s:.2f} s, window {window_s:.2f} s ({in_window} calls, "
          f"{attempted - in_window} traced after it), "
          f"check {t_check:.2f} s, trace reading {t_trace:.2f} s", file=log)
    if window_done:
        fields = [k for k, v in window_done[0].items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
        means = {k: sum(a[k] for a in window_done) / len(window_done) for k in fields}
        print("benchmark: window means " + json.dumps(means), file=log)
    run = Run(cell, window_s, window_done, setup_s, summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": info["kind"],
           "count": int(cell.workload["chips"]), "memory_peak_bytes": peak}
    if summary:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if summary:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = find_cell(load_spec(), args.workload)
    except SpecError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.workload["chips"]):
        print(f"benchmark: cell {args.workload} needs {cell.workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, which no run may load", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
