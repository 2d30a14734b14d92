"""``--trace`` of the port on the CPU: ``utils.profiling.device_trace`` and
the ``bnb_step`` profiler ranges of ``obs.tracing``.

- a capture writes a Chrome/Perfetto trace that parses as JSON and holds
  the captured CPU work; None is a no-op that writes nothing;
- the B&B loops wrap every expansion step in a ``bnb_step#<i>`` range, but
  only while a capture runs: no range, no capture;
- the pipeline CLI's ``--trace DIR`` writes ``DIR/trace.json`` and still
  prints the final line.
"""

import io
import json
from contextlib import redirect_stdout

import torch

from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.obs import tracing
from tsp_mpi_reduction_tpu_torch.utils import cli, profiling, tsplib


def _events(trace_dir):
    with open(trace_dir / profiling.TRACE_FILE) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_writes_a_parseable_trace(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        assert profiling.trace_active()
        with torch.profiler.record_function("port_work"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert not profiling.trace_active()
    names = {e.get("name") for e in _events(tmp_path)}
    assert "port_work" in names


def test_none_is_a_no_op(tmp_path):
    with profiling.device_trace(None):
        assert not profiling.trace_active()
        assert tracing.step_annotation_factory() is tracing._null_annotation
    assert list(tmp_path.iterdir()) == []


def _steps(kw, trace_dir=None):
    d = tsplib.embedded("ulysses16").distance_matrix()
    with profiling.device_trace(trace_dir and str(trace_dir), device="cpu"):
        res = tbb.solve(d, capacity=1 << 14, k=16, max_iters=6, bound="min-out", ils_rounds=0,
                        device="cpu", **kw)
    return res


def test_bnb_step_ranges_only_during_a_capture(tmp_path, monkeypatch):
    for loop in (False, True):
        out = tmp_path / f"loop{int(loop)}"
        res = _steps(dict(device_loop=loop, inner_steps=2), out)
        steps = [e["name"] for e in _events(out) if e.get("name", "").startswith("bnb_step#")]
        assert len(steps) == res.steps_run > 0
        assert steps[0] == "bnb_step#0"
    # untraced: every step gets the shared null context, and a profiler
    # that device_trace did not start sees no step range
    seen = []
    monkeypatch.setattr(tracing, "_null_annotation", lambda step: seen.append(step) or tracing._NULL_CTX)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _steps(dict(device_loop=False, inner_steps=2))
    assert seen == list(range(res.steps_run)) and res.steps_run > 0
    assert not any(e.key.startswith("bnb_step") for e in prof.key_averages())


def test_cli_trace(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["5", "4", "100", "100", "--backend=cpu", f"--trace={tmp_path / 't'}"]) == 0
    assert buf.getvalue().strip().splitlines()[-1].startswith("TSP ran in ")
    assert any(e.get("ph") == "X" for e in _events(tmp_path / "t"))
