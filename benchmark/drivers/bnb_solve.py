"""``models.branch_bound.solve``: one proof on one device."""

from __future__ import annotations

from ._proofs import ProofDriver


class Driver(ProofDriver):
    def solve(self, d):
        return self.bb.solve(d, device=self.device, **self.kwargs)
