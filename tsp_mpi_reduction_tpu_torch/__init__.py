"""PyTorch/CUDA port of the blocked TSP solver (JZHeadley/TSP-MPI-Reduction).

The same pipeline as the JAX package ``tsp_mpi_reduction_tpu``, written as
plain PyTorch functions on tensors with an explicit ``device``:

- the instance is generated with a bit-exact replica of glibc ``rand()``;
- every block is solved exactly by a batched Held-Karp DP whose min-plus
  relaxation runs in hand-written CUDA kernels on the GPU
  (``kernels/csrc/held_karp_relax.cu``);
- block tours are folded with the reference's 2-opt merge operator, and
  ``--ranks=P`` replays the reference's binary MPI reduce tree on one device;
- TSPLIB instances are solved exactly by single-device branch-and-bound
  (``models/branch_bound.py``, ``tools/bnb_solve.py``) whose per-node MST
  bound runs its Prim chain in a hand-written CUDA kernel
  (``kernels/csrc/prim_chain.cu``); its snapshots are the JAX package's
  TSPCKPT1 files, and ``tools/bnb_chunked.py`` runs a campaign of
  chunks, each a fresh process resuming the last snapshot;
- ``python -m tsp_mpi_reduction_tpu_torch serve`` answers JSONL requests
  under deadlines on the strongest tier that fits (``serve/``).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--backend=cpu`` / ``device="cpu"``); there is no silent CPU fallback.
This package imports neither ``jax`` nor ``tsp_mpi_reduction_tpu``.

Layout (each module mirrors its namesake in ``tsp_mpi_reduction_tpu``):
    ops/       glibc-rand replica, generator, distances, Held-Karp, merge,
               1-tree bound, local search, the Prim chain
    kernels/   CUDA C++ sources and their nvcc/ctypes build
    models/    single-rank pipeline, single-device rank emulation, B&B
    parallel/  the reference's reduce tree
    resilience/ the crash-safe checkpoint store, fault seams, retry, health
    obs/       the metrics registry, span tracing and latency SLOs
    serve/     the JSONL solve service: canonical keys, cache, micro-batch
               scheduler with preemptible B&B slices, deadline ladder
    fleet/     the shared disk tier of the serve cache
    tools/     the B&B driver and the chunked campaign driver
    utils/     device selection, CLI, reporting, phase timing, state carry,
               TSPLIB instances
"""

__version__ = "0.1.0"
