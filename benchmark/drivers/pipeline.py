"""``models.pipeline.run_pipeline``: Held-Karp for every block, then the
rank-local sequential fold (tsp.cpp:348-352), on one device."""

from __future__ import annotations

from ._pipelines import PipelineDriver


class Driver(PipelineDriver):
    def entry_module(self):
        from tsp_mpi_reduction_tpu_torch.models import pipeline

        return pipeline

    def run(self, xy):
        return self._module.run_pipeline(self.n, self.blocks, *self.grid, xy=xy, dtype=self.dtype,
                                         device=self.device)
