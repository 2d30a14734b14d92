"""``models.distributed.run_pipeline_ranks``: the reference's P-rank run
emulated on one device: each rank's blocks solved and folded, then the
binary reduce tree (``MPI_ManualReduce``, tsp.cpp:52-134)."""

from __future__ import annotations

from ._pipelines import PipelineDriver


class Driver(PipelineDriver):
    def entry_module(self):
        from tsp_mpi_reduction_tpu_torch.models import distributed

        return distributed

    def run(self, xy):
        return self._module.run_pipeline_ranks(self.n, self.blocks, *self.grid, self.ranks, xy=xy,
                                               dtype=self.dtype, device=self.device)
