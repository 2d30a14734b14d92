"""The port's dataflow lint (``tsp_mpi_reduction_tpu_torch.analysis.graftflow``).

- R9 (lock discipline) as in the JAX package, on its fixtures' shapes;
- R10, a pointer that outlives its tensor: ``.data_ptr()`` of a temporary
  and a pointer used after its tensor's binding was rebound or deleted,
  quiet on names and views (the kernel wrappers);
- R11, a hand-kernel launch whose stream is not read from
  ``current_stream`` at the call, quiet on the four wrappers;
- R12, a collective that only some ranks reach, quiet on
  ``solve_sharded``'s rank-0 ILS followed by a broadcast every rank
  reaches;
- the shared disable grammar, and the port's surface has no flow finding.
"""

import pathlib
import textwrap

import pytest

from tsp_mpi_reduction_tpu_torch.analysis import graftflow
from tsp_mpi_reduction_tpu_torch.analysis.graftflow import flow_project, flow_text

pytestmark = pytest.mark.lint

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsp_mpi_reduction_tpu_torch"


def flow(src, **kw):
    return flow_text(textwrap.dedent(src), "fixture.py", **kw)


def rules_of(violations):
    return sorted({v.rule for v in violations})


@pytest.fixture(scope="module")
def port_flow():
    """Every flow finding over the port's surface, computed once."""
    return graftflow.flow_paths([PORT, ROOT / "chip_smoke.py"], ROOT)


# -- R9 -------------------------------------------------------------------------

R9_RACY = """
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
"""


def test_r9_fires_on_unlocked_read_in_threaded_class():
    vs = flow(R9_RACY)
    assert rules_of(vs) == ["R9"] and vs[0].scope == "Sched.stats"


def test_r9_quiet_under_the_lock_and_without_threads():
    assert flow(R9_RACY.replace('return {"flushes": self.flushes}',
                                'with self._lock:\n                return {"flushes": self.flushes}')) == []
    assert flow(R9_RACY.replace("self._thread.start()", "pass").replace(
        "self._thread = threading.Thread(target=self._worker)", "pass")) == []


def test_r9_disable_comment():
    src = R9_RACY.replace('return {"flushes": self.flushes}',
                          'return {"flushes": self.flushes}  # graftlint: disable=R9')
    assert flow(src) == []


# -- R10 ------------------------------------------------------------------------


@pytest.mark.parametrize("arg", ["x.contiguous().data_ptr()", "x.to(torch.float32).data_ptr()",
                                 "x.float().data_ptr()", "x.clone()[1:].data_ptr()",
                                 "torch.empty(4, device=x.device).data_ptr()"])
def test_r10_fires_on_a_temporarys_pointer(arg):
    src = f"""
        import torch

        def launch(lib, x):
            lib.k({arg}, x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    """
    vs = flow(src, rules={"R10"})
    assert [(v.rule, v.scope) for v in vs] == [("R10", "launch")], arg


def test_r10_fires_on_a_pointer_used_after_its_tensor_was_rebound():
    vs = flow("""
        import torch

        def launch(lib, x, flag):
            p = x.data_ptr()
            if flag:
                x = x.float()
            lib.k(p, torch.cuda.current_stream(x.device).cuda_stream)
            del x
    """, rules={"R10"})
    assert rules_of(vs) == ["R10"] and "rebound or deleted" in vs[0].message


def test_r10_quiet_on_names_views_and_fresh_pointers():
    assert flow("""
        import torch

        def launch(lib, x, highs, hoff, p0):
            xc = x.contiguous()
            p = xc.data_ptr()
            lib.k(p, highs[hoff[p0]:].data_ptr(), x.view(-1).t().data_ptr(),
                  torch.cuda.current_stream(x.device).cuda_stream)
            p = x.data_ptr()
            x = None
            p = 0
            return p
    """, rules={"R10"}) == []


def test_r10_r11_quiet_on_the_four_kernel_wrappers(port_flow):
    wrappers = ("ops/held_karp_kernels.py", "ops/prim_kernels.py", "ops/expand_kernels.py")
    assert not [v for v in port_flow if v.path.endswith(wrappers)]
    src = (PORT / "ops" / "held_karp_kernels.py").read_text()
    assert "highs[hoff[p]:].data_ptr()" in src
    assert src.count("torch.cuda.current_stream(") == 2


# -- R11 ------------------------------------------------------------------------


def test_r11_fires_on_a_literal_or_import_time_stream():
    vs = flow("""
        import torch

        _STREAM = torch.cuda.current_stream().cuda_stream

        def a(lib, x):
            lib.k(x.data_ptr(), x.numel(), 0)

        def b(lib, x):
            lib.k(x.data_ptr(), x.numel(), _STREAM)

        def c(lib, x, s):
            lib.floor_launch(4, 8, None)
            lib.k(x.data_ptr(), s)
    """, rules={"R11"})
    assert [(v.scope, v.line) for v in vs] == [("a", 7), ("b", 10), ("c", 13), ("c", 14)]
    assert "legacy default stream" in vs[0].message and "cached at import" in vs[1].message


def test_r11_quiet_on_current_stream_at_the_call():
    assert flow("""
        import torch

        def a(lib, x):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            for p in range(3):
                lib.k(x.data_ptr(), p, stream)
            lib.floor_launch(4, 8, torch.cuda.current_stream().cuda_stream)
            _costs.record_launch("k", (), None, x.device)
    """, rules={"R11"}) == []


# -- R12 ------------------------------------------------------------------------


def test_r12_fires_on_a_one_sided_collective():
    vs = flow("""
        def step(ranks, x, d):
            if ranks.is_root:
                x = ranks.broadcast(x)
            y = ranks.agree(True) if ranks.rank == 0 else False
            return x, y

        def gather(ranks, x):
            if not ranks.is_root:
                return None
            return ranks.all_gather(x)

        def procs(self, x):
            if self.rank == 0:
                self._dist.barrier()
            import torch.distributed as dist
            if dist.get_rank() == 0:
                dist.all_reduce(x)
            return x
    """, rules={"R12"})
    assert [(v.scope, v.line) for v in vs] == [("step", 4), ("step", 5), ("gather", 11),
                                                ("procs", 15), ("procs", 18)]


def test_r12_quiet_when_every_rank_reaches_the_collective():
    assert flow("""
        def seed(ranks, d):
            mine = ils(d) if ranks.is_root else zeros(d)
            tour = ranks.broadcast(mine)
            faulted = False
            if ranks.is_root:
                faulted = fire()
            if ranks.agree(faulted):
                tour = None
            if ranks.is_root:
                out = ranks.gather_objects(tour)
            else:
                out = ranks.gather_objects(None)
            x = t.gather(-1, idx) if ranks.is_root else t.scatter(0, idx, v)
            return tour, out, x
    """, rules={"R12"}) == []


def test_r12_kinds_come_from_the_meshs_own_tuple():
    mesh = 'KINDS = ("all_gather", "shuffle")\n'
    use = "def f(ranks, x):\n    if ranks.is_root:\n        ranks.shuffle(x)\n        ranks.broadcast(x)\n"
    vs = flow_project({"pkg/parallel/mesh.py": mesh, "pkg/m.py": use}, rules={"R12"})
    assert [v.code for v in vs] == ["ranks.shuffle(x)"]


def test_r12_quiet_on_the_ports_sharded_solve(port_flow):
    src = (PORT / "models" / "branch_bound.py").read_text()
    assert "if ranks.is_root else np.zeros(n + 1, np.int32)" in src
    assert "ranks.broadcast(torch.as_tensor(mine))" in src
    assert not [v for v in port_flow if v.rule == "R12"]


# -- the surface ------------------------------------------------------------------


def test_the_ports_surface_has_no_flow_finding(port_flow):
    assert port_flow == [], "\n".join(v.render() for v in port_flow)
