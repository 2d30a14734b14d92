"""``python -m tsp_mpi_reduction_tpu_torch`` — the reference's ``./tsp`` CLI."""

import sys

from .utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
