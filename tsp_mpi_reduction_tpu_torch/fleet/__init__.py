"""fleet/: the serve layer across processes.

Ported so far: :mod:`.shared_cache`, the disk tier under the serve cache
(``serve --shared-cache DIR``). The front, the replicas and the supervisor
of ``tsp_mpi_reduction_tpu/fleet`` are not ported yet.
"""
