"""``models.branch_bound.solve_sharded``: one proof over R rank frontiers
batched on one device (the program's ``BatchedRanks``)."""

from __future__ import annotations

from ._proofs import ProofDriver


class Driver(ProofDriver):
    def solve(self, d):
        kw = dict(self.kwargs)
        return self.bb.solve_sharded(d, kw.pop("ranks"), device=self.device, **kw)
