"""Port hygiene: the PyTorch/CUDA package and ``chip_smoke.py`` stand alone.

Neither imports ``jax`` nor anything of the JAX package
``tsp_mpi_reduction_tpu`` (``tsp_mpi_reduction_tpu_torch`` itself is
allowed). The kernel wrappers take the plain version only for CPU tensors,
and ``chip_smoke.py`` refuses to run without a CUDA device.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from tsp_mpi_reduction_tpu_torch.ops import held_karp_kernels as hkk
from tsp_mpi_reduction_tpu_torch.ops import prim_kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsp_mpi_reduction_tpu_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "tsp_mpi_reduction_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _absolute_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_prefix_spares_the_port_itself():
    assert _forbidden("jax.numpy") and _forbidden("tsp_mpi_reduction_tpu.ops.rand")
    assert not _forbidden("tsp_mpi_reduction_tpu_torch.ops.rand")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_jax_package_import(rel):
    bad = [m for m in _absolute_imports(ROOT / rel) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` and the JAX package
    made unimportable, and none of them is pulled in."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tsp_mpi_reduction_tpu')]:\n"
        "    del sys.modules[k]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['tsp_mpi_reduction_tpu'] = None\n"
        "import tsp_mpi_reduction_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "leaked = [k for k in sys.modules if k.startswith('tsp_mpi_reduction_tpu.')]\n"
        "assert not leaked, leaked\n"
        "print(len(names))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT), timeout=120
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 20  # every module was reached


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    ``meta`` device stands in for a non-CPU device here."""
    before = dict(hkk.LAUNCHES)
    before_prim = dict(prim_kernels.LAUNCHES)
    g = torch.empty((1, 4, 3), device="meta")
    with pytest.raises(ValueError):
        hkk.relax_minplus(g, torch.empty((1, 3, 3), device="meta"))
    table = torch.empty((1, 3, 8), device="meta")
    with pytest.raises(ValueError):
        hkk.relax_dense_sweep(table, torch.empty((1, 3, 3), device="meta"))
    dbar = torch.empty((5, 5), device="meta")
    unvis = torch.empty((4, 5), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar, unvis, 5)
    with pytest.raises(ValueError):
        prim_kernels.prim_chain(dbar, unvis, 5, torch.empty((4, 5), device="meta"))
    assert hkk.LAUNCHES == before
    assert prim_kernels.LAUNCHES == before_prim


def _run_smoke(cwd: pathlib.Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True, cwd=str(cwd), timeout=120
    )


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real there")
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_push_rows_never_falls_back_off_the_cpu():
    from tsp_mpi_reduction_tpu_torch.ops import expand_kernels

    before = dict(expand_kernels.LAUNCHES)
    n, k = 8, 2
    cols = expand_kernels.row_width(n)
    meta = dict(device="meta")
    args = (torch.empty((32, cols), dtype=torch.int32, **meta),
            torch.empty((k, cols), dtype=torch.int32, **meta),
            torch.empty((k, n), dtype=torch.int32, **meta),
            *(torch.empty((k, n), **meta) for _ in range(3)))
    with pytest.raises(ValueError):
        expand_kernels.push_rows(*args, n)
    assert expand_kernels.LAUNCHES == before
