"""Rank groups: the mesh of the JAX package as ranks on one device or as
processes over ``torch.distributed``.

Counterpart of ``tsp_mpi_reduction_tpu/parallel/mesh.py``. The JAX package
runs one SPMD program over a device mesh and moves data with ``ppermute``
and ``all_gather`` under ``shard_map``. Here the step functions of the
mesh paths (the reduce tree, the ring improver, the balance steps of the
sharded branch-and-bound) are written once against a *rank group*, which
has two implementations:

- :class:`BatchedRanks` holds all R ranks in one process, stacked on a
  leading dimension of every tensor: ``all_gather`` is the identity,
  ``ppermute`` a gather over dim 0, ``all_reduce`` a reduction over it;
- :class:`ProcessRanks` is one rank of a ``torch.distributed`` group: its
  leading dimension is 1 and each collective is the ``torch.distributed``
  call. Only ``gloo`` is supported: NCCL refuses two ranks on one device,
  and a machine with one card runs every rank on it. Gloo takes host
  tensors only, so every tensor is copied to the host before a call and
  back to the rank's device after it (:meth:`ProcessRanks._staged`), and
  the staged bytes, calls and seconds are counted per collective kind.

:func:`spawn_ranks` starts R local rank processes (``spawn``, a
``FileStore`` rendezvous in a fresh temporary directory, a deadline) and
returns rank 0's value; :func:`initialize_multihost` joins a group that
``torchrun`` (or a shared file) describes.
"""

from __future__ import annotations

import datetime
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

RANK_AXIS = "ranks"

#: the only process-group backend of this version
BACKENDS = ("gloo",)

#: the collective kinds a rank group counts
KINDS = ("all_gather", "ppermute", "all_reduce", "broadcast", "gather", "scatter")


def torus_dims(num_devices: int) -> Tuple[int, int]:
    """Near-square 2D factorization of the ranks (the reference's
    ``getBlocksPerDim``, tsp.cpp:136-157): ``(rows, cols)``."""
    if math.isqrt(num_devices) ** 2 == num_devices:
        r = math.isqrt(num_devices)
        return r, r
    divisor = 2
    while num_devices % divisor != 0:
        divisor += 1
    return divisor, num_devices // divisor


def make_torus_mesh(ranks) -> np.ndarray:
    """The ``(rows, cols)`` layout of a group's rank ids (the
    ``MPI_Cart_create`` analog, ``mesh.py:31``); ``ranks`` is a group or a
    rank count."""
    num = ranks if isinstance(ranks, int) else ranks.num_ranks
    return np.arange(num).reshape(torus_dims(num))


def check_backend(backend: str) -> None:
    """Refuse every backend but gloo, with the reason."""
    if backend not in BACKENDS:
        raise ValueError(
            f"process-group backend {backend!r} is not supported: only gloo. NCCL refuses two "
            "ranks on one device (\"Duplicate GPU detected\"), so ranks that share a card "
            "exchange through the host; NCCL with one GPU a rank waits for a machine with "
            "more than one card")


class BatchedRanks:
    """All ``num_ranks`` ranks in this process, stacked on dim 0."""

    transport = "batched"

    def __init__(self, num_ranks: int):
        if num_ranks < 1:
            raise ValueError(f"need >= 1 rank, got {num_ranks}")
        self.num_ranks = num_ranks
        self.local = num_ranks
        self.rank = 0
        self.ids = list(range(num_ranks))

    @property
    def is_root(self) -> bool:
        return True

    def process_ids(self) -> List[List[int]]:
        """The global rank ids each process holds, in process order."""
        return [self.ids]

    def rank_ids(self, device) -> torch.Tensor:
        """The global ids of the local rows, ``[local]`` int64."""
        return torch.arange(self.num_ranks, device=device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def ppermute(self, x: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Rank ``dst`` receives rank ``src``'s row for each pair; a rank that
        receives nothing gets zeros (``jax.lax.ppermute``)."""
        out = torch.zeros_like(x)
        if pairs:
            src = torch.as_tensor([s for s, _ in pairs], device=x.device)
            dst = torch.as_tensor([t for _, t in pairs], device=x.device)
            out[dst] = x[src]
        return out

    def shift_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Rank r receives rank r-1's row (cyclic)."""
        return torch.roll(x, 1, 0)

    def shift_back(self, x: torch.Tensor) -> torch.Tensor:
        """Rank r receives rank r+1's row (cyclic)."""
        return torch.roll(x, -1, 0)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``min``, ``max``, ``sum`` or ``any`` over the ranks: ``[R, ...]``
        -> ``[...]``."""
        if op == "min":
            return x.amin(0)
        if op == "max":
            return x.amax(0)
        if op == "sum":
            return x.sum(0, dtype=x.dtype)
        if op == "any":
            return x.any(0)
        raise ValueError(f"unknown reduction {op!r}")

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """A value held once a process (no rank dim): rank ``src``'s on every
        process. One process holds it here."""
        return x

    def agree(self, flag) -> bool:
        """Rank 0's host decision, the same on every rank."""
        return bool(flag)

    def gather_objects(self, obj) -> Optional[list]:
        """Every process's ``obj`` on rank 0's process, in process order."""
        return [obj]

    def scatter_objects(self, objs: Optional[list]):
        """Process p's entry of rank 0's list ``objs``."""
        return objs[0]


class ProcessRanks:
    """One rank of a ``torch.distributed`` group (gloo), its leading
    dimension 1, its tensors on ``device``."""

    transport = "procs"

    def __init__(self, device="cpu", group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no process group: call initialize_multihost() first, or run "
                               "under spawn_ranks or torchrun")
        check_backend(str(dist.get_backend(group)))
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.num_ranks = dist.get_world_size(group)
        self.local = 1
        self.ids = [self.rank]
        self.device = torch.device(device)
        self.cold_start_s: Optional[float] = None
        self.staged_bytes: Dict[str, int] = {k: 0 for k in KINDS}
        self.calls: Dict[str, int] = {k: 0 for k in KINDS}
        self.seconds: Dict[str, float] = {k: 0.0 for k in KINDS}

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def process_ids(self) -> List[List[int]]:
        return [[r] for r in range(self.num_ranks)]

    def rank_ids(self, device) -> torch.Tensor:
        return torch.tensor([self.rank], device=device)

    def _staged(self, kind: str, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """Run ``fn`` on a host copy of ``x`` and bring its host result back
        to ``x``'s device: the one place a collective's tensors cross the
        host, counted per kind. Bools travel as uint8 (gloo has no bool
        reductions)."""
        t0 = time.perf_counter()
        is_bool = x.dtype == torch.bool
        host = x.detach().to("cpu").contiguous()
        if is_bool:
            host = host.to(torch.uint8)
        out = fn(host)
        if is_bool:
            out = out.bool()
        res = out.to(x.device)
        self.staged_bytes[kind] += host.numel() * host.element_size() + out.numel() * out.element_size()
        self.calls[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0
        return res

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, ...]`` -> ``[R, ...]`` (every rank's row, in rank order)."""

        def fn(h):
            outs = [torch.empty_like(h[0]) for _ in range(self.num_ranks)]
            self._dist.all_gather(outs, h[0], group=self.group)
            return torch.stack(outs)

        return self._staged("all_gather", fn, x)

    def ppermute(self, x: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """One paired send/recv a rank (``batch_isend_irecv``); a rank that
        receives nothing gets zeros."""
        me = self.rank
        send_to = [t for s, t in pairs if s == me]
        recv_from = [s for s, t in pairs if t == me]

        def fn(h):
            out = torch.zeros_like(h)
            ops = []
            for t in send_to:
                if t == me:
                    out.copy_(h)
                else:
                    ops.append(self._dist.P2POp(self._dist.isend, h[0], t, group=self.group))
            for s in recv_from:
                if s != me:
                    ops.append(self._dist.P2POp(self._dist.irecv, out[0], s, group=self.group))
            if ops:
                for req in self._dist.batch_isend_irecv(ops):
                    req.wait()
            return out

        return self._staged("ppermute", fn, x)

    def shift_fwd(self, x: torch.Tensor) -> torch.Tensor:
        r = self.num_ranks
        return self.ppermute(x, [(i, (i + 1) % r) for i in range(r)])

    def shift_back(self, x: torch.Tensor) -> torch.Tensor:
        r = self.num_ranks
        return self.ppermute(x, [(i, (i - 1) % r) for i in range(r)])

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``min``, ``max``, ``sum`` or ``any`` over the ranks: ``[1, ...]``
        -> ``[...]``."""
        rop = {"min": "MIN", "max": "MAX", "sum": "SUM", "any": "MAX"}
        if op not in rop:
            raise ValueError(f"unknown reduction {op!r}")

        def fn(h):
            h = h[0].clone()
            self._dist.all_reduce(h, op=getattr(self._dist.ReduceOp, rop[op]), group=self.group)
            return h

        return self._staged("all_reduce", fn, x)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """A value held once a process (no rank dim): rank ``src``'s on every
        rank."""

        def fn(h):
            h = h.clone()
            self._dist.broadcast(h, src=src, group=self.group)
            return h

        return self._staged("broadcast", fn, x)

    def agree(self, flag) -> bool:
        """Rank 0's host decision (a clock reading, a fault seam), broadcast
        so that no rank's own clock or registry steers it apart."""
        return bool(self.broadcast(torch.tensor([int(bool(flag))], dtype=torch.int32))[0])

    def gather_objects(self, obj) -> Optional[list]:
        """Every rank's picklable ``obj`` on rank 0 (None elsewhere)."""
        t0 = time.perf_counter()
        out = [None] * self.num_ranks if self.is_root else None
        self._dist.gather_object(obj, out, dst=0, group=self.group)
        self.calls["gather"] += 1
        self.seconds["gather"] += time.perf_counter() - t0
        return out

    def scatter_objects(self, objs: Optional[list]):
        """Rank r's entry of rank 0's list ``objs``."""
        t0 = time.perf_counter()
        out = [None]
        self._dist.scatter_object_list(out, objs if self.is_root else None, src=0, group=self.group)
        self.calls["scatter"] += 1
        self.seconds["scatter"] += time.perf_counter() - t0
        return out[0]

    def stats(self) -> dict:
        """Staged bytes, calls and seconds per collective kind, and the
        process's cold start (spawn to joined group), when known."""
        return {"staged_bytes": dict(self.staged_bytes), "calls": dict(self.calls),
                "seconds": {k: round(v, 6) for k, v in self.seconds.items()},
                "cold_start_s": self.cold_start_s}


def _rank_device(device, local_rank: int) -> torch.device:
    """``cuda`` -> ``cuda:{local_rank % device_count}``; anything else as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("rank device cuda needs a CUDA device and none is available; "
                               "ask for device='cpu' to run the ranks on the host")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, backend: str = "gloo",
                         timeout_s: float = 600.0) -> int:
    """Join a process group (the ``jax.distributed`` analog, ``mesh.py:41``).

    With no arguments the group comes from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    ``init_method="file:///path"`` with ``world_size`` and ``rank`` joins
    through a shared file. Returns the world size; a no-op when a group
    already exists.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    check_backend(backend)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_world_size()


def make_rank_mesh(num_ranks: Optional[int] = None, device="cuda") -> ProcessRanks:
    """This process's rank of the joined group (``mesh.py:80``): refuses a
    world of another size than ``num_ranks``, since the merge tree and the
    search depend on the rank count. ``device="cuda"`` is the card of
    ``LOCAL_RANK``, made this process's current card."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost() first")
    world = dist.get_world_size()
    if num_ranks is not None and world != num_ranks:
        raise RuntimeError(f"asked for a {num_ranks}-rank mesh but the process group has {world} "
                           "ranks; another rank count would silently change the result")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = _rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ProcessRanks(dev)


def _rank_main(rank: int, world: int, store_path: str, device, timeout_s: float, t_spawn: float,
               fn: Callable, args: tuple, kwargs: dict, results) -> None:
    """A spawned rank: join the group through the file store, run
    ``fn(ranks, *args, **kwargs)``, report rank 0's value (or any rank's
    traceback) to the launcher."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist

    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # ranks x test workers outnumber the cores; one thread a rank
            torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        ranks = ProcessRanks(dev)
        ranks.cold_start_s = time.time() - t_spawn
        out = fn(ranks, *args, **(kwargs or {}))
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, num_ranks: int, args: tuple = (), kwargs: Optional[dict] = None, *,
                device="cuda", timeout_s: float = 600.0, backend: str = "gloo"):
    """Run ``fn(ranks, *args, **kwargs)`` on ``num_ranks`` local rank
    processes and return rank 0's value.

    The processes start with ``spawn`` (a fork after CUDA initialization
    breaks) and meet through a ``FileStore`` in a fresh temporary directory,
    so no TCP port is chosen. Rank r runs on ``cuda:{r % device_count}``
    unless ``device`` is the CPU. ``fn`` and its arguments are pickled: it
    must be a module-level function whose module imports cheaply. Within
    ``timeout_s`` every rank must report; the first rank that raises or
    dies makes this raise with its traceback, after every other rank is
    killed, so a failed rank never leaves its peers waiting.
    """
    import multiprocessing as mp

    check_backend(backend)
    if num_ranks < 1:
        raise ValueError(f"need >= 1 rank, got {num_ranks}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tsp_ranks_")
    results = ctx.Queue()
    t_spawn = time.time()
    procs = [ctx.Process(target=_rank_main, name=f"tsp-rank-{r}",
                         args=(r, num_ranks, os.path.join(tmp, "store"), str(device), timeout_s,
                               t_spawn, fn, args, kwargs, results))
             for r in range(num_ranks)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        done, value = set(), None
        while len(done) < num_ranks:
            try:
                rank, status, payload = results.get(timeout=0.1)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} exited with code {p.exitcode} before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{num_ranks} ranks did not finish within {timeout_s} s "
                                       f"(reported: {sorted(done)})")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            done.add(rank)
            if rank == 0:
                value = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return value
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
        results.close()
        results.cancel_join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
