"""Run one cell of the benchmark once and print its result line last.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's CUDA devices.
The kernel and compiler caches stay inside the checkout, at fixed paths
under ``build/``.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, "build", "benchmark", _sub)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
