"""The port's lint against the JAX package's lint on the rules both carry
unchanged (R5, R6, R9, R13).

- the JAX package's own fixtures for those rules (copied here as strings)
  give the same ``(path, line, rule, scope)`` list through both lints;
- so do the port's ``serve/`` and ``fleet/``;
- the JAX lint's R5/R6/R9/R13 over the whole port find nothing (the
  waivers the port's copies had dropped are back, and the three tools
  write their JSON atomically).
"""

import pathlib
import textwrap

import pytest

from tsp_mpi_reduction_tpu.analysis import graftflow as jax_flow
from tsp_mpi_reduction_tpu.analysis import graftlint as jax_lint
from tsp_mpi_reduction_tpu_torch.analysis import graftflow as port_flow
from tsp_mpi_reduction_tpu_torch.analysis import graftlint as port_lint

pytestmark = pytest.mark.lint

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsp_mpi_reduction_tpu_torch"
SHARED = {"R5", "R6", "R13"}
FLOW_SHARED = {"R9"}


def key(vs):
    return sorted((v.path, v.line, v.rule, v.scope) for v in vs)


# the JAX package's fixtures (tests/test_graftlint.py), verbatim
LINT_FIXTURES = {
    "r5_state_dropping_return": """
        class Store:
            def flush(self, rows, cap):
                self.chunks = []
                merged = rows + ["extra"]
                take = min(len(merged), cap)
                if take == 0:
                    return None
                self.chunks.append(merged[:take])
                return merged
    """,
    "r5_state_respilled": """
        class Store:
            def flush(self, rows, cap):
                self.chunks = []
                merged = rows + ["extra"]
                take = min(len(merged), cap)
                if take == 0:
                    self.chunks.append(merged)
                    return None
                self.chunks.append(merged[:take])
                return merged
    """,
    "r5_prefix_partition_bug": """
        import numpy as np

        class _Reservoir:
            def _partition(self, extra, inc_cost, capacity):
                chunks = self.chunks if extra is None else self.chunks + [extra]
                self.chunks = []
                chunks = [c for c in chunks if c.shape[0]]
                merged = np.concatenate(chunks)
                m = merged.shape[0]
                take = min(m, capacity // 2)
                if take == 0:
                    return None
                self.chunks.append(merged[take:])
                return merged[:take]
    """,
    "r6_open": """
        import json

        def publish(path, obj):
            with open(path, "w") as f:
                json.dump(obj, f)
    """,
    "r6_savez": """
        import numpy as np

        def snapshot(path, frontier):
            np.savez_compressed(path, nodes=frontier)
    """,
    "r6_atomic_publish": """
        import json, os

        def publish(path, obj):
            part = path + ".part"
            with open(part, "w") as f:
                json.dump(obj, f)
            os.replace(part, path)
    """,
    "r6_in_memory_buffer": """
        import io
        import numpy as np

        def to_bytes(arr):
            buf = io.BytesIO()
            np.savez_compressed(buf, arr=arr)
            return buf.getvalue()
    """,
    "r6_temp_paths_and_reads": """
        import tempfile

        def scratch(tmp_path, p):
            with open(tmp_path, "w") as f:
                f.write("x")
            with open(p) as f:
                return f.read()
    """,
    "r6_module_level": """
        with open("results.json", "w") as f:
            f.write("{}")
    """,
    "r6_module_level_disabled": """
        with open("results.json", "w") as f:  # graftlint: disable=R6
            f.write("{}")
    """,
    "r6_token_bounded_temp": """
        import numpy as np

        def sweep(state):
            for attempt in range(3):
                np.savez_compressed(f"run_{attempt}.npz", **state)
        f = open(template_out, 'w')
    """,
    "r13_fstring": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def record(user):
            REGISTRY.inc("requests_total", who=f"user-{user}")
    """,
    "r13_loop_variable": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def record(items):
            for item in items:
                REGISTRY.inc("seen_total", kind=item)
    """,
    "r13_per_request": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def handle(request, req):
            REGISTRY.observe("latency_seconds", 0.1, rid=request["id"])
            REGISTRY.set_gauge("g", 1.0, src=str(req.get("src")))
    """,
    "r13_bounded": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        TIER = "bnb"

        def fold(entry, outcome):
            REGISTRY.inc("outcomes_total", entry=entry, outcome=outcome)
            REGISTRY.inc("answers_total", tier=TIER)
            REGISTRY.observe("seconds", 1.5, phase="compile")
            REGISTRY.inc("bytes_total", 4096, direction="to_host")
            for seam in ("a", "b"):
                OTHER.fire(seam=seam)
    """,
    "r13_range_labels": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def fold(balance, num_ranks):
            for r in range(num_ranks):
                REGISTRY.inc("bnb_rank_nodes_total", balance[r], rank=r)
                REGISTRY.set_gauge("bnb_rank_occupancy", 1.0, rank=str(r))
            for i, _w in enumerate(range(8)):
                REGISTRY.inc("windows_total", idx=i)
    """,
    "r13_rebind_strips": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def fold(requests):
            for r in range(4):
                for r in requests:
                    REGISTRY.inc("seen_total", rank=r)
                REGISTRY.inc("after_total", rank=r)
    """,
    "r13_data_sized_range": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def record(requests, q):
            for i in range(len(requests)):
                REGISTRY.inc("seen_total", idx=i)
            for j in range(q.qsize()):
                REGISTRY.inc("queued_total", idx=j)
    """,
    "r13_disabled": """
        from tsp_mpi_reduction_tpu.obs.metrics import REGISTRY

        def record(request):
            REGISTRY.inc("x_total", rid=request["id"])  # graftlint: disable=R13
    """,
}

# the JAX package's fixtures (tests/test_graftflow.py), verbatim
FLOW_FIXTURES = {
    "r9_racy": """
        import threading

        class Sched:
            def __init__(self):
                self._lock = threading.Lock()
                self.flushes = 0
                self._thread = threading.Thread(target=self._worker)
                self._thread.start()

            def _worker(self):
                with self._lock:
                    self.flushes += 1

            def stats(self):
                return {"flushes": self.flushes}
    """,
    "r9_dict_entry": """
        import threading

        class Ladder:
            def __init__(self):
                self._lock = threading.Lock()
                self.counts = {}
                threading.Thread(target=self._answer).start()

            def _answer(self):
                with self._lock:
                    self.counts["bnb"] = self.counts.get("bnb", 0) + 1

            def stats(self):
                return dict(self.counts)
    """,
    "r9_mutator": """
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []
                threading.Thread(target=self._drain).start()

            def _drain(self):
                with self._lock:
                    self.items.append(1)

            def peek(self):
                return len(self.items)
    """,
    "r9_double_checked": """
        import threading

        class Sink:
            def __init__(self):
                self._lock = threading.Lock()
                self.fh = None
                threading.Thread(target=self.emit).start()

            def configure(self, fh):
                with self._lock:
                    self.fh = fh

            def emit(self):
                if self.fh is None:
                    return
                with self._lock:
                    if self.fh is None:
                        return
                    self.fh.write("x")
    """,
    "r9_locked_helper_mixed": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
                threading.Thread(target=self._worker).start()

            def _worker(self):
                with self._lock:
                    self._bump()

            def poke(self):
                self._bump()

            def _bump(self):
                self.n += 1

            def set(self):
                with self._lock:
                    self.n = 5
    """,
    "r9_cross_object": """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        class Ladder:
            def __init__(self):
                self._lock = threading.Lock()
                self.tiers = {}

            def answer(self):
                with self._lock:
                    self.tiers["bnb"] = self.tiers.get("bnb", 0) + 1

        class Service:
            def __init__(self):
                self.ladder = Ladder()

            def handle(self, req):
                self.ladder.answer()

            def stats(self):
                return dict(self.ladder.tiers)

        def run(svc: Service, pool: ThreadPoolExecutor, reqs):
            for r in reqs:
                pool.submit(svc.handle, r)
    """,
}


@pytest.mark.parametrize("name", sorted(LINT_FIXTURES))
def test_shared_rules_agree_on_the_jax_fixtures(name):
    src = textwrap.dedent(LINT_FIXTURES[name])
    want = jax_lint.lint_text(src, "fixture.py", rules=SHARED)
    got = port_lint.lint_text(src, "fixture.py", rules=SHARED)
    assert key(got) == key(want)
    assert [v.message for v in got] == [v.message for v in want]


@pytest.mark.parametrize("name", sorted(FLOW_FIXTURES))
def test_r9_agrees_on_the_jax_fixtures(name):
    src = textwrap.dedent(FLOW_FIXTURES[name])
    want = jax_flow.flow_text(src, "fixture.py", rules=FLOW_SHARED)
    got = port_flow.flow_text(src, "fixture.py", rules=FLOW_SHARED)
    assert key(got) == key(want)


def test_the_fixtures_exercise_every_shared_rule():
    fired = set()
    for src in LINT_FIXTURES.values():
        fired |= {v.rule for v in port_lint.lint_text(textwrap.dedent(src), "f.py", rules=SHARED)}
    for src in FLOW_FIXTURES.values():
        fired |= {v.rule for v in port_flow.flow_text(textwrap.dedent(src), "f.py", rules=FLOW_SHARED)}
    assert fired == SHARED | FLOW_SHARED


@pytest.mark.parametrize("sub", ["serve", "fleet"])
def test_shared_rules_agree_on_the_ports_serve_and_fleet(sub):
    paths = [PORT / sub]
    for rules, jax_fn, port_fn in ((SHARED, jax_lint.lint_paths, port_lint.lint_paths),
                                   (FLOW_SHARED, jax_flow.flow_paths, port_flow.flow_paths)):
        want = jax_fn(paths, ROOT, rules=rules)
        got = port_fn(paths, ROOT, rules=rules)
        assert key(got) == key(want)
    # both see the restored waiver: the live response stream is no finding
    waived = []
    for f in sorted((PORT / sub).rglob("*.py")):
        rel = f.relative_to(ROOT).as_posix()
        port_lint.lint_text(f.read_text(), rel, rules={"R6"}, waived=waived)
    assert [v.scope for v in waived] == ["serve_cli" if sub == "serve" else "fleet_cli"]


def test_the_jax_lint_finds_nothing_in_the_port():
    lint = jax_lint.lint_paths([PORT], ROOT, rules=SHARED)
    flow = jax_flow.flow_paths([PORT], ROOT, rules=FLOW_SHARED)
    assert lint + flow == [], [v.render() for v in lint + flow]
