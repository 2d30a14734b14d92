"""Cells of the benchmark cut to a size the CPU tests can run: the same
files, drivers, checks and metrics, with the configuration's and the
traffic mix's sizes made small. The B&B instance is eil51's first cities,
whose optimum the reference's Held-Karp gives.

``KEPT`` holds the traffic mixes that have a driver and no cell yet, so
that their driver stays tested until a cell names them."""

from __future__ import annotations

import copy

import torch

from benchmark import harness, instances
from benchmark.reference import tsp as ref


#: cell name -> (configuration, traffic mix, end-to-end metric) of a mix
#: kept without a cell
KEPT = {"blocked16.r16-tree": ("blocked-16x1024", "pipeline.r16-tree", "pipeline_ms")}


def spec() -> dict:
    """``BENCHMARK.json`` with the kept mixes as cells of their own."""
    s = harness.load_spec()
    for name, (config, traffic, moves) in KEPT.items():
        s["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "kept"})
        for m in s["end_to_end"] + s["per_layer"]:
            if name not in m.get("workloads", [name]) and (m["name"] == moves or m.get("moves") == moves):
                m["workloads"].append(name)
    return s


CELLS = [w["name"] for w in spec()["workloads"]]


def cell(name: str, **traffic) -> harness.Cell:
    c = copy.deepcopy(harness.find_cell(spec(), name))
    if "instance" in c.config:
        n = 9
        inst = c.config["instance"]
        xy = instances.load_coords(inst["file"])[:n]
        opt, _ = ref.held_karp(torch.as_tensor(ref.euc_2d(xy), dtype=torch.float64)[None])
        inst.update(cities=n, dimension=n, optimum=float(opt[0]))
        c.traffic["solver"].update(k=16)
        if "capacity" in c.traffic["solver"]:
            c.traffic["solver"]["capacity"] = 2048
        else:
            c.traffic["solver"]["capacity_per_rank"] = 1024
    else:
        ranks = int(c.traffic.get("ranks", 1))
        c.config["deployment"].update(cities_per_block=5, num_blocks=max(4, 2 * ranks))
    c.traffic.update(traffic)
    return c


def run(name: str, seconds: float = 0.5, seed: int = 2**31 + 7, trace: bool = False, **traffic) -> dict:
    return harness.run_cell(cell(name, **traffic), seed, seconds, trace, "cpu")

