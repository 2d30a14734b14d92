"""What the B&B drivers share: seeded copies of a TSPLIB instance, one
proof a call, every proof of the window judged against the published
optimum."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from .. import checks, instances


class ProofDriver:
    """Closed loop of proofs, one copy of the configuration's instance a
    call. ``precision`` "bfloat16" hands the solver distances computed in
    bfloat16 (the control); None hands it the exact EUC_2D matrix."""

    span = "proof"

    def __init__(self, config: dict, traffic: dict, seed: int, device, precision: Optional[str] = None):
        from tsp_mpi_reduction_tpu_torch.models import branch_bound

        self.bb = branch_bound
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.precision = precision
        inst = config["instance"]
        self.coords = instances.load_coords(inst["file"])[: inst.get("cities")]
        self.optimum = float(inst["optimum"])
        self.kwargs = dict(config["solver"], **traffic["solver"])

    def inputs(self, stream: int, start: int, count: int) -> List[instances.ProofCopy]:
        return [instances.proof_copy(self.coords, stream, self.seed, i, self.precision)
                for i in range(start, start + count)]

    def solve(self, d: np.ndarray):
        raise NotImplementedError

    def warm(self) -> None:
        self.call(self.inputs(instances.WARM, 0, 1)[0])

    def call(self, cp: instances.ProofCopy) -> dict:
        t = time.perf_counter()
        res = self.solve(cp.d)
        return {"cost": float(res.cost), "tour": np.asarray(res.tour), "proven": bool(res.proven_optimal),
                "lower_bound": float(res.lower_bound), "root_lower_bound": float(res.root_lower_bound),
                "nodes": int(res.nodes_expanded), "wall_s": float(res.wall_seconds),
                "setup_s": float(res.setup_seconds), "ascent_s": float(res.ascent_seconds),
                "ils_s": float(res.ils_seconds), "call_s": time.perf_counter() - t}

    @staticmethod
    def failed(answer: dict) -> bool:
        return not answer["proven"]

    @staticmethod
    def phases(a: dict):
        """Spans inside a call, in seconds from its start, from the
        result's own timing fields (solve's clock starts at the call)."""
        s0, s1 = a["setup_s"], a["setup_s"] + a["wall_s"]
        return [("proof.ascent", 0.0, a["ascent_s"]),
                ("proof.ils", a["ascent_s"], a["ascent_s"] + a["ils_s"]),
                ("proof.prepare", a["ascent_s"] + a["ils_s"], s0),
                ("proof.search", s0, s1), ("proof.finish", s1, a["call_s"])]

    def check(self, answers: List[dict], inputs: List[instances.ProofCopy]) -> List[checks.Check]:
        return checks.proofs(answers, inputs[: len(answers)], self.optimum, self.config["limits"])

    def release(self) -> None:
        pass
