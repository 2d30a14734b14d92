"""The analytic device costs (``obs/costs.py``) against ``tools/kernel_times.py``
and the JAX package's ``obs.device_costs`` schema, on the CPU.

- the records the four kernel wrappers store at their first launch count
  the same bytes and operations as ``kernel_times``' bounds, at the eil51
  and kroA100 shapes of the B&B kernels and the pipeline's full-size
  shapes of the Held-Karp kernels (inputs made with numpy from a seed);
- the pipeline's dense sweep bound is the 0.3008 ms that ``PERF.md``
  records from ``kernel_times``;
- a record has every field of the JAX package's, ``device_costs_block()``
  has the JAX block's keys, the ``xla_entry_*`` gauges mirror it, a second
  launch at a shape costs one lookup, and the wrappers record nothing for
  the plain versions they run on CPU tensors.
"""

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.obs import costs as jcosts
from tsp_mpi_reduction_tpu_torch.obs import costs
from tsp_mpi_reduction_tpu_torch.obs.metrics import REGISTRY
from tsp_mpi_reduction_tpu_torch.ops import expand_kernels, held_karp_kernels, prim_kernels
from tsp_mpi_reduction_tpu_torch.tools import kernel_times as kt


@pytest.fixture(autouse=True)
def _clean_costs(monkeypatch):
    costs.reset_for_testing()
    monkeypatch.setattr(costs, "_card_name", lambda device: "test card")
    yield
    costs.reset_for_testing()


def _unvis(k, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((k, n)) < rng.random((k, 1)))


@pytest.mark.parametrize("k,n", [(1024, 51), (1024, 100), (128, 51)], ids=["eil51", "kroA100", "eil51-R8"])
@pytest.mark.parametrize("lam", [False, True])
def test_prim_chain_counts_equal_kernel_times(k, n, lam):
    unvis = _unvis(k, n, n + lam)
    want_bytes, want_ops = kt.costs.prim_chain_counts(unvis, lam)
    rec = prim_kernels._launch_costs(unvis, n, torch.zeros(k, n) if lam else None)
    assert (rec["bytes_accessed"], rec["flops"]) == (want_bytes, want_ops)
    u = unvis.sum(dim=1).double()
    assert want_ops == float(((u - 1).clamp(min=0) * u).sum()) * (4 if lam else 2)
    assert want_bytes == k * n * (9 if lam else 5) + 4 * n * n + 4 * k


@pytest.mark.parametrize("f,k,n", [((1 << 18) + 1024 * 51, 1024, 51), ((1 << 19) + 1024 * 100, 1024, 100)],
                         ids=["eil51", "kroA100"])
def test_push_rows_counts_equal_kernel_times(f, k, n):
    cols = (n + 3) // 4 + (n + 31) // 32 + 4
    rng = np.random.default_rng(k + n)
    dest = torch.from_numpy(np.where(rng.random((k, n)) < 0.3, rng.integers(0, f, (k, n)), f).astype(np.int32))
    nodes = torch.zeros((f, cols), dtype=torch.int32)
    # kernel_times' recorded call: (nodes shape, parents, dest, ...)
    call = ((f, cols), torch.zeros((k, cols), dtype=torch.int32), dest)
    want_bytes, want_ops, n_push = kt.push_bound([call], k, n)
    rec = expand_kernels._launch_costs(nodes, dest, n)
    assert (rec["bytes_accessed"], rec["flops"]) == (want_bytes, want_ops)
    assert rec["shape"]["n_push"] == n_push == int((dest < f).sum())
    assert rec["alias_bytes"] == rec["output_bytes"] == 4 * f * cols


def test_held_karp_counts_equal_kernel_times():
    m, bsz = 15, 1024  # the pipeline's full size: 16 cities a block, 1024 blocks
    for elt, dt in ((4, "float32"), (8, "float64")):
        rec = held_karp_kernels._sweep_costs(bsz, m, elt, dt)
        assert (rec["bytes_accessed"], rec["flops"]) == kt.costs.relax_dense_counts(bsz, m, elt)
        for j in (1, 14, 3432):
            rec = held_karp_kernels._minplus_costs(bsz, j, m, elt, dt)
            assert (rec["bytes_accessed"], rec["flops"]) == kt.costs.relax_minplus_counts(bsz, j, m, elt)
    b_ms, by = kt.bound_ms(*kt.costs.relax_dense_counts(bsz, m, 4), "float32")
    assert by == "bytes" and round(b_ms, 4) == 0.3008
    # kernel_times reads its counts, bound and peaks from obs/costs
    assert kt.costs is costs and kt.bound_ms is costs.bound_ms


def test_record_has_the_jax_fields_and_one_lookup_later():
    calls = []
    unvis = _unvis(64, 14, 0)

    def counts():
        calls.append(1)
        return prim_kernels._launch_costs(unvis, 14, None)

    for _ in range(3):
        costs.record_launch("prim_chain", ("k64", "n14"), counts, "cpu")
    assert len(calls) == 1
    rec = costs.get("prim_chain@k64.n14")
    jrec = jcosts._roofline({"schema": jcosts.SCHEMA_VERSION, "backend": "tpu", "flops": 1.0,
                             "bytes_accessed": 2.0, "transcendentals": 0.0, "argument_bytes": 0,
                             "output_bytes": 0, "temp_bytes": 0, "alias_bytes": 0,
                             "peak_memory_bytes": 0})
    assert set(jrec) <= set(rec)
    assert rec["backend"] == "gpu" and rec["card"] == "test card" and rec["kernel"] == "prim_chain"
    assert rec["peak_flops_per_s"] == 67e12 and rec["peak_bytes_per_s"] == 3.35e12
    assert rec["peak_memory_bytes"] == rec["argument_bytes"] + rec["output_bytes"]
    assert (rec["bound_ms"], rec["bound_by"]) == kt.bound_ms(rec["bytes_accessed"], rec["flops"], "float32")
    assert REGISTRY.value("xla_entry_flops", entry="prim_chain@k64.n14") == rec["flops"]
    block = costs.device_costs_block()
    jblock = jcosts.device_costs_block()
    assert set(block) == set(jblock) == {"schema", "entries", "peaks"}
    assert block["schema"] == jcosts.SCHEMA_VERSION
    assert list(block["entries"]) == ["prim_chain@k64.n14"]
    assert block["peaks"]["gpu"]["card"] == costs.PEAK_CARD
    assert block["peaks"]["gpu"]["bytes_per_s"] == 3.35e12


def test_float64_record_uses_the_float64_rate(monkeypatch):
    costs.record_launch("relax_dense_sweep", ("B8", "m10", "float64"),
                        lambda: held_karp_kernels._sweep_costs(8, 10, 8, "float64"), "cpu")
    rec = costs.get("relax_dense_sweep@B8.m10.float64")
    assert rec["peak_flops_per_s"] == 34e12
    monkeypatch.setenv("TSP_PEAK_BYTES_PER_S", "1e12")
    assert costs.backend_peaks("gpu")["bytes_per_s"] == 1e12
    monkeypatch.setenv("TSP_PEAK_BYTES_PER_S", "nonsense")
    assert costs.backend_peaks("gpu")["bytes_per_s"] == 3.35e12


def test_plain_versions_on_the_cpu_record_nothing():
    n, k = 14, 16
    dbar = torch.rand(n, n)
    prim_kernels.prim_chain(dbar, _unvis(k, n, 1), n)
    g = torch.rand(2, 5, 4, dtype=torch.float64)
    held_karp_kernels.relax_minplus(g, torch.rand(2, 4, 4, dtype=torch.float64))
    assert costs.device_costs_block()["entries"] == {}
    costs.reset_for_testing()
    assert costs.get("prim_chain@k64.n14") is None
