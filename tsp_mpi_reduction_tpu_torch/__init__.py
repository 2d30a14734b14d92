"""PyTorch/CUDA port of the blocked TSP solver (JZHeadley/TSP-MPI-Reduction).

The same pipeline as the JAX package ``tsp_mpi_reduction_tpu``, written as
plain PyTorch functions on tensors with an explicit ``device``:

- the instance is generated with a bit-exact replica of glibc ``rand()``;
- every block is solved exactly by a batched Held-Karp DP whose min-plus
  relaxation runs in hand-written CUDA kernels on the GPU
  (``kernels/csrc/held_karp_relax.cu``);
- block tours are folded with the reference's 2-opt merge operator, and
  ``--ranks=P`` replays the reference's binary MPI reduce tree on one device.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--backend=cpu`` / ``device="cpu"``); there is no silent CPU fallback.
This package imports neither ``jax`` nor ``tsp_mpi_reduction_tpu``.

Layout (each module mirrors its namesake in ``tsp_mpi_reduction_tpu``):
    ops/       glibc-rand replica, generator, distances, Held-Karp, merge
    kernels/   CUDA C++ sources and their nvcc/ctypes build
    models/    single-rank pipeline and single-device rank emulation
    parallel/  the reference's reduce tree
    utils/     device selection, CLI, reporting, phase timing, state carry
"""

__version__ = "0.1.0"
