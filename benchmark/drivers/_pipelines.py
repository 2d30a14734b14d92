"""What the pipeline drivers share: a fresh seeded city set a call in the
reference program's block layout, handed to the program through ``xy=``,
and a sample of the window's runs, drawn from the seed, judged by the
reference.

The block tours a run's Held-Karp returns are not part of the entry's
result, so the driver keeps the tensors that ``solve_blocks_from_dists``
hands back to the entry (a pass-through wrapper in the entry's module:
the same call, the same tensors, no copy in the window) and reads them on
the host after the window for the sampled runs. An entry that no longer
calls it by that name leaves nothing to judge, and every call fails."""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .. import checks, instances


class PipelineDriver:
    span = "pipeline"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        dep = config["deployment"]
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.n, self.blocks = dep["cities_per_block"], dep["num_blocks"]
        self.grid = (dep["grid_x"], dep["grid_y"])
        self.dtype = dep["dtype"]
        self.ranks = int(traffic.get("ranks", 1))
        mod = self.entry_module()
        self._module, self._orig = mod, mod.solve_blocks_from_dists
        self._taps: list = []

        def tap(dists, dtype=torch.float64):
            out = self._orig(dists, dtype)
            self._taps.append(out)
            return out

        mod.solve_blocks_from_dists = tap
        # the slots of a P-rank layout that hold blocks, in block order
        self._valid = np.flatnonzero(checks.slot_blocks(self.blocks, self.ranks) >= 0)

    def entry_module(self):
        raise NotImplementedError

    def run(self, xy: np.ndarray):
        raise NotImplementedError

    def inputs(self, stream: int, start: int, count: int) -> List[np.ndarray]:
        return [instances.blocked_cities(self.n, self.blocks, *self.grid, stream, self.seed, i)
                for i in range(start, start + count)]

    def warm(self) -> None:
        self.call(self.inputs(instances.WARM, 0, 1)[0])

    def call(self, xy: np.ndarray) -> dict:
        t = time.perf_counter()
        res = self.run(xy)
        if not self._taps:
            raise RuntimeError(f"{self._module.__name__} did not call solve_blocks_from_dists: "
                               "no block tours to judge")
        _, tours = self._taps.pop()
        self._taps.clear()
        return {"cost": float(res.cost), "tour": res.tour_ids, "block_costs": res.block_costs,
                "block_tours_dev": tours,
                "phase_s": dict(res.phase_seconds), "call_s": time.perf_counter() - t}

    @staticmethod
    def failed(answer: dict) -> bool:
        return False

    @staticmethod
    def phases(a: dict):
        """Spans inside a call, in seconds from its start, from the
        result's phase seconds (each ends in a synchronize)."""
        out, t = [], 0.0
        ph = a["phase_s"]
        if "solve_reduce" in ph:
            sr = ph["solve_reduce"]
            return [("pipeline.distances", 0.0, max(a["call_s"] - sr, 0.0)),
                    ("pipeline.solve_reduce", max(a["call_s"] - sr, 0.0), a["call_s"])]
        for name in ("generate", "distances", "solve", "merge_fold"):
            if name in ph:
                out.append((f"pipeline.{name}", t, t + ph[name]))
                t += ph[name]
        out.append(("pipeline.finish", t, a["call_s"]))
        return out

    def check(self, answers: List[dict], inputs: List[np.ndarray]) -> List[checks.Check]:
        k = min(int(self.traffic["check_runs"]), len(answers))
        pick = sorted(instances.rng(instances.SAMPLE, self.seed, 0).choice(len(answers), size=k, replace=False)) \
            if answers else []
        sample = []
        for i in pick:
            a = dict(answers[i])
            a["block_tours"] = a.pop("block_tours_dev").cpu().numpy()[self._valid]
            sample.append(a)
        for a in answers:
            a.pop("block_tours_dev", None)
        return checks.pipelines(sample, [inputs[i] for i in pick], self.ranks, self.config["limits"],
                                self.device)

    def release(self) -> None:
        self._module.solve_blocks_from_dists = self._orig
        self._taps.clear()
