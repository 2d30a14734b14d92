"""Runtime contracts of the port (:mod:`.contracts`).

Counterpart of ``tsp_mpi_reduction_tpu/analysis``, as far as its runtime
half goes: the shape/dtype/device contracts on the ``Frontier`` and
``PaddedTour`` boundaries, the reservoir exchange bound and the in-place
check on the frontier buffer. Import it as ``from
tsp_mpi_reduction_tpu_torch.analysis import contracts``.
"""
