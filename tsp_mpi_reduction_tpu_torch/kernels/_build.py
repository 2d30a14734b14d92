"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/`` have a plain C interface, so they compile in
seconds with ``nvcc`` alone (no PyTorch headers) into a shared library
under ``build/torch_ext/`` at the repository root (gitignored). The
library's name carries a hash of its source and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing is built when
this module is imported: the first kernel launch calls its library's
loader (:func:`library`, :func:`prim_library`, :func:`push_library`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "held_karp_relax.cu", _CSRC / "prim_chain.cu", _CSRC / "push_rows.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_ext"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17",
    "-O3",
    "--fmad=false",  # no multiply-add contraction anywhere (exactness)
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def find_nvcc() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _lib_path(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build(source: pathlib.Path, verbose: bool = False) -> pathlib.Path:
    """Compile ``source`` into its shared library unless it exists.

    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory and spills per kernel) to stderr.
    """
    out = _lib_path(source)
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}) on {source.name}:\n{r.stderr}")
    if verbose:
        print(r.stderr, file=sys.stderr, end="")
    os.replace(tmp, out)
    return out


def build_all(verbose: bool = False) -> list:
    """Build every source at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(lambda s: build(s, verbose), SOURCES))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The Held-Karp relaxation library, built on first use."""
    lib = ctypes.CDLL(str(build(SOURCES[0])))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hk_relax_minplus.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.hk_relax_minplus.restype = i
    lib.hk_relax_dense_sweep.argtypes = [vp, vp, vp, i, vp, i, i, i, i, vp]
    lib.hk_relax_dense_sweep.restype = i
    lib.hk_error_string.argtypes = [i]
    lib.hk_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def prim_library() -> ctypes.CDLL:
    """The branch-and-bound Prim chain library, built on first use."""
    lib = ctypes.CDLL(str(build(SOURCES[1])))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.prim_chain_launch.argtypes = [vp, vp, vp, vp, vp, i, i, vp]
    lib.prim_chain_launch.restype = i
    lib.prim_error_string.argtypes = [i]
    lib.prim_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def push_library() -> ctypes.CDLL:
    """The branch-and-bound fused push library, built on first use."""
    lib = ctypes.CDLL(str(build(SOURCES[2])))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.push_rows_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.push_rows_launch.restype = i
    lib.push_rows_floor_launch.argtypes = [i, i, vp]
    lib.push_rows_floor_launch.restype = i
    lib.push_error_string.argtypes = [i]
    lib.push_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().hk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
