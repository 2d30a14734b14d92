"""Command-line drivers of the port (``python -m tsp_mpi_reduction_tpu_torch.tools.<name>``)."""
