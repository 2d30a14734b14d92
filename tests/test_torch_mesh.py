"""The port's rank groups (``parallel/mesh.py``) on the CPU.

- every collective of ``ProcessRanks`` over 1, 2, 3 and 4 gloo processes
  (``spawn_ranks``, one group per rank count) equals ``BatchedRanks`` on
  the same numpy-seeded inputs: ``all_gather``, ``ppermute`` forward, back
  and along each round of the reduce tree (ranks that receive nothing get
  zeros), ``all_reduce`` min/max/sum/any, ``broadcast``, ``agree`` (rank
  0's decision on every rank), ``gather_objects`` and ``scatter_objects``;
  exact, but float sums to 1e-12 (float64) and 1e-6 (float32) relative,
  since gloo adds the ranks in its own order;
- a spawned rank has no ``jax`` module;
- ``torus_dims`` equals the JAX package's for 1-16 ranks, and
  ``make_torus_mesh`` lays the rank ids out in that shape;
- ``make_rank_mesh`` refuses a world of another size, and every backend
  but gloo is refused with the reason;
- a rank that raises makes ``spawn_ranks`` raise within its deadline with
  that rank's traceback, and no rank process is left alive.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

import torch_rank_probes as probes
from tsp_mpi_reduction_tpu.parallel import mesh as jmesh
from tsp_mpi_reduction_tpu_torch.parallel import mesh

SEED = 11
#: every spawn's deadline: far inside a test's time, far above a group's start
DEADLINE_S = 120.0


@pytest.fixture(scope="module")
def procs_results():
    """One gloo group per rank count, every primitive in one run."""
    return {r: mesh.spawn_ranks(probes.primitives, r, args=(SEED,), device="cpu", timeout_s=DEADLINE_S)
            for r in (1, 2, 3, 4)}


def _flat(parts):
    return [x for p in parts for x in p]


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_process_ranks_equal_batched(procs_results, r):
    got = procs_results[r]
    want = probes.primitives(mesh.BatchedRanks(r), SEED)
    assert got["jax_loaded"] == []
    for key, w in want.items():
        g = got[key]
        if key in ("jax_loaded", "agree") or key.startswith("bcast_"):
            continue
        if key in ("gather", "scatter"):
            assert _flat(g) == _flat(w), key
            continue
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key.startswith("sum_f"):
            np.testing.assert_allclose(g, w, rtol=1e-12 if key.endswith("64") else 1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    inputs = probes.primitive_inputs(r, SEED)
    want_flag = bool(inputs["bool"][0, 0])
    assert got["agree"] == [want_flag] * r and want["agree"] == [want_flag]
    for name, rows in inputs.items():
        assert len(got[f"bcast_{name}"]) == r and len(want[f"bcast_{name}"]) == 1
        for row in got[f"bcast_{name}"] + want[f"bcast_{name}"]:
            np.testing.assert_array_equal(row, rows[0])
    assert _flat(got["gather"]) == list(range(r))
    # a rank that receives nothing in a tree round gets zeros
    for i, (_, pairs) in enumerate(probes.tree_schedule(r)):
        idle = sorted(set(range(r)) - {dst for _, dst in pairs})
        assert not np.asarray(got[f"tree{i}_i32"])[idle].any()


def test_torus_dims_equal_jax():
    for r in range(1, 17):
        assert mesh.torus_dims(r) == tuple(jmesh.torus_dims(r)), r
        assert mesh.make_torus_mesh(r).shape == mesh.torus_dims(r)
    assert mesh.make_torus_mesh(mesh.BatchedRanks(6)).tolist() == [[0, 1, 2], [3, 4, 5]]


def test_make_rank_mesh_refuses_another_world_and_backends_but_gloo(tmp_path):
    import torch.distributed as dist

    with pytest.raises(ValueError, match="only gloo"):
        mesh.check_backend("nccl")
    with pytest.raises(ValueError, match="only gloo"):
        mesh.spawn_ranks(probes.fail_on, 2, args=(0,), device="cpu", backend="nccl")
    assert mesh.initialize_multihost(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
                                     timeout_s=30) == 1
    try:
        with pytest.raises(RuntimeError, match="2-rank mesh but the process group has 1"):
            mesh.make_rank_mesh(2, device="cpu")
        one = mesh.make_rank_mesh(1, device="cpu")
        assert (one.rank, one.num_ranks, one.local, one.transport) == (0, 1, 1, "procs")
        x = torch.arange(6, dtype=torch.int32).reshape(1, 2, 3)
        assert torch.equal(one.all_gather(x), x) and one.staged_bytes["all_gather"] == 48
    finally:
        dist.destroy_process_group()


def test_failed_rank_raises_with_its_traceback_and_leaves_no_process():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        mesh.spawn_ranks(probes.fail_on, 3, args=(1,), device="cpu", timeout_s=DEADLINE_S)
    assert time.monotonic() - t0 < DEADLINE_S
    assert "rank 1 was told to fail" in str(err.value) and "Traceback" in str(err.value)
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("tsp-rank-")]
