"""The port's per-node lint (``tsp_mpi_reduction_tpu_torch.analysis.graftlint``).

- every rule R1-R8 and R13 fires on its torch/CUDA hazard and stays quiet
  on the sanctioned form, with the port's own code as the fixture where a
  site exists (the device loop's count read, the merge's ``inf`` fill, the
  fold loop, the sliced write-back, ``Frontier(fr.nodes, ..)``, the CUDA
  graph capture of ``tools/kernel_times.py``);
- the framework carried from the JAX package: the disable grammar, hot
  markers, the line-free baseline (round trip, stale and dead entries), the
  CLI's exit codes, ``--json`` and SARIF;
- the repo surface is clean modulo the committed baseline, whose entry
  count never grows;
- importing the lint loads neither torch nor jax nor the JAX package;
- the port's sweep refuses with exit 2 before it resolves a device when
  the gate reports new findings.
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from tsp_mpi_reduction_tpu_torch.analysis import graftlint
from tsp_mpi_reduction_tpu_torch.analysis import __main__ as cli

pytestmark = pytest.mark.lint

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsp_mpi_reduction_tpu_torch"
#: the committed baseline's entry count: it may shrink, never grow
BASELINE_ENTRIES = 0


def lint(src, **kw):
    return graftlint.lint_text(textwrap.dedent(src), "fixture.py", **kw)


def rules_of(violations):
    return sorted({v.rule for v in violations})


def lint_port_file(rel, rules=None):
    """(violations, waived) of one port file, as the CLI sees it."""
    waived = []
    vs = graftlint.lint_text((ROOT / rel).read_text(), rel, rules=rules, waived=waived)
    return vs, waived


def line_of(rel, needle):
    lines = (ROOT / rel).read_text().splitlines()
    hits = [i + 1 for i, ln in enumerate(lines) if needle in ln]
    assert len(hits) == 1, (rel, needle, hits)
    return hits[0]


@pytest.fixture(scope="module")
def surface():
    """The default surface linted once for the module: (new, accepted,
    waived, stale, dead)."""
    waived = []
    targets = [p for p in cli._DEFAULT_TARGETS if p.exists()]
    vs = cli.run_analyses(targets, set(cli.ALL_RULES), waived)
    baseline = graftlint.load_baseline(cli._DEFAULT_BASELINE)
    res = graftlint.apply_baseline(vs, baseline)
    dead = graftlint.find_dead_scopes(baseline, cli._REPO_ROOT)
    return res, waived, dead, baseline


# -- R1: host pulls in hot contexts ---------------------------------------------


R1_LOOP = """
    import torch

    def run(fr, steps):
        total = torch.zeros((), device=fr.nodes.device)
        for _ in range(steps):
            total = total + fr.count
            if int(fr.count) == 0:
                break
        return total
"""


def test_r1_fires_on_scalar_read_in_a_loop():
    vs = lint(R1_LOOP, rules={"R1"})
    assert rules_of(vs) == ["R1"] and vs[0].scope == "run" and "int()" in vs[0].message


@pytest.mark.parametrize("expr", ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
                                  "x.to('cpu')", "np.asarray(x)", "float(x)", "bool(x)",
                                  "torch.nonzero(x)", "x.nonzero()", "torch.where(x)",
                                  "x.unique()", "x[x > 0]", "x.repeat_interleave(r)"])
def test_r1_each_pull_form_fires_in_a_loop(expr):
    src = f"""
        import numpy as np
        import torch

        def f(n):
            x = torch.arange(n, device="cuda")
            r = torch.ones(n, dtype=torch.long, device="cuda")
            for _ in range(3):
                y = {expr}
            return y
    """
    assert rules_of(lint(src, rules={"R1"})) == ["R1"], expr


def test_r1_quiet_outside_hot_contexts_and_on_host_data():
    assert lint("""
        import numpy as np
        import torch

        def setup(fr, rows):
            cnt = int(fr.count)                # once, not in a loop
            for r in rows:
                np.asarray(r)                  # host data
            x = torch.from_numpy(rows)         # a host tensor
            for _ in range(3):
                x.numpy()
            y = torch.arange(4, device="cuda")
            for _ in range(3):
                y.repeat_interleave(2, output_size=8)
            return cnt
    """, rules={"R1"}) == []


def test_r1_hot_marker_and_default_hot_paths():
    src = """
        def {name}(fr):  {marker}
            return int(fr.count)
    """
    assert lint(src.format(name="helper", marker=""), rules={"R1"}) == []
    assert rules_of(lint(src.format(name="helper", marker="# graftlint: hot"), rules={"R1"})) == ["R1"]
    assert rules_of(lint(src.format(name="_guarded_expand_steps", marker=""), rules={"R1"})) == ["R1"]


def test_r1_the_device_loops_count_read_is_a_waived_finding():
    """The port's own site: the B&B loops read the step's counters once a
    run of inner_steps steps by design, so R1 names that read and the
    waiver carries why; the per-step count reads are gone."""
    rel = "tsp_mpi_reduction_tpu_torch/models/branch_bound.py"
    vs, waived = lint_port_file(rel, rules={"R1"})
    assert vs == []
    sites = {(v.scope, v.code) for v in waived}
    assert ("_read_counters", "return ctr.tolist()") in sites
    assert not any(s in ("_guarded_expand_steps", "_expand_loop", "_pop_stage", "_search_step")
                   for s, _ in sites)


# -- R2: uploads --------------------------------------------------------------


def test_r2_fires_on_the_merges_inf_fill():
    """The merge's old inf fill, a host constant uploaded every merge, is
    an R2 finding; the port now fills with a Python scalar, and its merge
    and fold have no R2 finding left."""
    vs = lint("""
        import torch

        def _merge_from_sc(t1, t2, sc):
            dev = sc.device
            return torch.where(t1.ids > 0, sc, torch.tensor(float("inf"), dtype=sc.dtype, device=dev))
    """, rules={"R2"})
    assert [(v.rule, v.scope) for v in vs] == [("R2", "_merge_from_sc")]
    rel = "tsp_mpi_reduction_tpu_torch/ops/merge.py"
    vs, waived = lint_port_file(rel, rules={"R2"})
    assert vs == [] and waived == []
    assert 'torch.where(valid, sc, float("inf"))' in (ROOT / rel).read_text()


def test_r2_fires_on_a_round_trip_reupload():
    vs = lint("""
        import torch

        def exchange(fr):
            host = fr.nodes.cpu().numpy()
            host[:4] = 0
            return torch.from_numpy(host).to(fr.nodes.device)
    """, rules={"R2"})
    assert rules_of(vs) == ["R2"] and "pulled from the device" in vs[0].message


def test_r2_quiet_on_the_sliced_write_back():
    """``fr.nodes[:take].copy_(torch.from_numpy(keep))``: only the kept
    prefix goes up. The port's refill/exchange write it through
    ``perf.donation.set_rows_donated``, which does exactly that copy."""
    rel = "tsp_mpi_reduction_tpu_torch/models/branch_bound.py"
    vs, waived = lint_port_file(rel, rules={"R2"})
    lines = [i + 1 for i, ln in enumerate((ROOT / rel).read_text().splitlines())
             if "_donation.set_rows_donated(fr.nodes, torch.from_numpy(keep))" in ln]
    assert len(lines) == 2
    assert "nodes[: rows.shape[0]].copy_(rows)" in (PORT / "perf" / "donation.py").read_text()
    assert not {v.line for v in vs + waived} & set(lines)
    assert lint("""
        import torch

        def refill(fr, keep, take):
            fr.nodes[:take].copy_(torch.from_numpy(keep))
            fr.nodes[:take] = torch.from_numpy(keep).to(fr.nodes.device)
            return fr
    """, rules={"R2"}) == []


# -- R3: implicit Tensor.__bool__ -----------------------------------------------


@pytest.mark.parametrize("test", ["if (fr.count > 0):\n        pass",
                                  "while fr.overflow:\n        break",
                                  "assert fr.count >= 0",
                                  "y = 1 if fr.overflow else 0",
                                  "y = fr.overflow and 1",
                                  "if not (fr.count == 0):\n        pass"])
def test_r3_fires_on_implicit_bool(test):
    src = f"def f(fr):\n    {test}\n"
    assert rules_of(graftlint.lint_text(src, "f.py", rules={"R3"})) == ["R3"], test


def test_r3_quiet_on_explicit_reads_and_host_values():
    assert lint("""
        def f(fr, res, lam=None):
            if int(fr.count) > 0 and bool(fr.overflow):
                pass
            if res.cost == 3.0 or lam is None:
                pass
            if fr.nodes.shape[0] > 4 and fr.nodes.device.type == "cuda":
                pass
    """, rules={"R3"}) == []


# -- R4: launches in a Python loop of a hot function ------------------------------


def test_r4_fires_on_the_fold_loop():
    """The fold's old Python loop of merges is an R4 finding. The port's
    fold replays a captured step on CUDA; its eager loop (the CPU, and
    ``TSP_COMPILE_CACHE=off``) is the one R4 site left in the file, waived
    inline with its reason."""
    vs = lint("""
        import torch

        def fold_tours(tours: torch.Tensor, costs: torch.Tensor, dist: torch.Tensor):
            b, l = tours.shape
            acc = make_padded(tours[0], l, costs[0], b * (l - 1) + 1)
            length = torch.tensor(l, dtype=torch.int32, device=tours.device)
            for i in range(1, b):
                acc = merge_tours(acc, PaddedTour(tours[i], length, costs[i]), dist)
            return acc.ids, acc.length, acc.cost
    """, rules={"R4"})
    assert [(v.scope, v.code) for v in vs] == [("fold_tours", "for i in range(1, b):")]
    rel = "tsp_mpi_reduction_tpu_torch/ops/merge.py"
    vs, waived = lint_port_file(rel, rules={"R4"})
    assert vs == []
    assert [(v.scope, v.line) for v in waived] == [("_fold_eager", line_of(rel, "for _ in range(merges):"))]


def test_r4_once_per_loop_and_quiet_on_host_loops():
    vs = lint("""
        import torch

        def _expand_loop(fr, steps, rows):
            for r in rows:
                print(r)
            while steps:
                fr = torch.where(fr.nodes > 0, fr.nodes, 0)
                fr = fr + 1
                steps -= 1
            return fr
    """, rules={"R4"})
    assert [v.line for v in vs] == [7]
    assert lint("""
        import torch

        def cold(x):
            for _ in range(3):
                x = torch.relu(x)
            return x
    """, rules={"R4"}) == []


# -- R14: indexing by a 0-d device tensor ----------------------------------------------


#: the pop stage's completion bookkeeping before it was repaired: four
#: indexings by 0-d device tensors, each a read of the index
R14_OLD_POP = """
    import torch

    def pop(comp_total: torch.Tensor, p_pathw: torch.Tensor, p_depth: torch.Tensor, n, unpack):
        best_flat = comp_total.argmin()
        best_total = comp_total[best_flat]
        bi, bc = best_flat // n, (best_flat % n).to(torch.int32)
        best_path = unpack(p_pathw[bi], n).clone()
        best_path[torch.clamp(p_depth[bi], max=n - 1).long()] = bc
        return best_total, best_path
"""


def test_r14_fires_on_the_old_pop_stage():
    vs = lint(R14_OLD_POP, rules={"R14"})
    assert [(v.rule, v.code) for v in vs] == [
        ("R14", "best_total = comp_total[best_flat]"),
        ("R14", "best_path = unpack(p_pathw[bi], n).clone()"),
        ("R14", "best_path[torch.clamp(p_depth[bi], max=n - 1).long()] = bc"),
        ("R14", "best_path[torch.clamp(p_depth[bi], max=n - 1).long()] = bc"),
    ]
    assert "write" in vs[2].message and "read" in vs[3].message
    assert all(v.scope == "pop" for v in vs)


def test_r14_fires_on_a_reduction_index_and_its_arithmetic():
    vs = lint("""
        import torch

        def prim(d: torch.Tensor, cand: torch.Tensor, closest: torch.Tensor, m):
            u = cand.argmin()
            a = d[u]
            b = closest[u + 1]
            c = cand[torch.argmax(cand)]
            w = d[0, u]
            return a, b, c, w
    """, rules={"R14"})
    assert [v.line for v in vs] == [6, 7, 8, 9]


def test_r14_stays_quiet_on_device_indices_and_host_indices():
    assert lint("""
        import torch

        def fine(x: torch.Tensor, rows: torch.Tensor, n):
            i = x.argmin(dim=1)              # one index a row: a [k] tensor
            j = torch.argmax(x, 1)
            flat = x.reshape(-1).argmin().view(1)   # a 1-element index tensor
            a = x[i] + x[j] + x[0] + x[n - 1] + x[:, 2]
            b = x.reshape(-1).gather(0, flat)[0]
            c = rows.index_select(0, flat)
            out = torch.zeros(n, dtype=torch.int32)
            out.scatter_(0, flat, 1)
            s = int(x.sum())                 # an explicit read: R1's business
            return a, b, c, out, rows[s]
    """, rules={"R14"}) == []


def test_r14_finds_nothing_in_the_repaired_pop_stage_and_prim():
    """The pop stage (each rank's best completion by its ``[L, 1]`` index)
    and the device ascent's Prim gather by index tensors; no 0-d-indexed
    read is left in the port."""
    for rel in ("tsp_mpi_reduction_tpu_torch/models/branch_bound.py",
                "tsp_mpi_reduction_tpu_torch/ops/one_tree.py"):
        vs, waived = lint_port_file(rel, rules={"R14"})
        assert vs == [] and waived == []
    src = (ROOT / "tsp_mpi_reduction_tpu_torch/models/branch_bound.py").read_text()
    assert "best_total = comp_total.gather(1, best_flat)[:, 0]" in src
    assert "_pop_stage" in graftlint.DEFAULT_HOT_PATHS and "_search_step" in graftlint.DEFAULT_HOT_PATHS


# -- R5 / R6 / R13: carried unchanged -----------------------------------------------


def test_r5_fires_and_the_reservoir_waiver_holds():
    vs = lint("""
        class Store:
            def flush(self, rows, cap):
                self.chunks = []
                merged = rows + ["extra"]
                take = min(len(merged), cap)
                if take == 0:
                    return None
                self.chunks.append(merged[:take])
                return merged
    """)
    assert rules_of(vs) == ["R5"]
    vs, waived = lint_port_file("tsp_mpi_reduction_tpu_torch/models/branch_bound.py", rules={"R5"})
    assert vs == [] and [v.scope for v in waived] == ["_Reservoir._partition"]


def test_r6_fires_on_torch_save_and_bare_open_and_quiet_on_atomic():
    vs = lint("""
        import torch

        def save(obj, path):
            torch.save(obj, path)
            with open(path + ".json", "w") as f:
                f.write("{}")
    """, rules={"R6"})
    assert [v.rule for v in vs] == ["R6", "R6"]
    assert lint("""
        import io, os, torch

        def save(obj, path):
            buf = io.BytesIO()
            torch.save(obj, buf)
            torch.save(obj, path + ".tmp")
            os.replace(path + ".tmp", path)
    """, rules={"R6"}) == []


def test_r6_the_tools_write_atomically():
    for tool in ("kernel_times", "kernel_variants", "step_profile"):
        vs, waived = lint_port_file(f"tsp_mpi_reduction_tpu_torch/tools/{tool}.py", rules={"R6"})
        assert vs == [] and waived == [], tool


def test_r13_fires_on_fstring_label_and_quiet_on_bounded():
    assert rules_of(lint("""
        from ..obs.metrics import REGISTRY as _REGISTRY

        def record(user, items):
            _REGISTRY.inc("requests_total", who=f"user-{user}")
    """, rules={"R13"})) == ["R13"]
    assert lint("""
        from ..obs.metrics import REGISTRY as _REGISTRY

        def record(n):
            for r in range(n):
                _REGISTRY.set_gauge("rank_nodes", 1.0, rank=str(r))
            _REGISTRY.inc("answers_total", tier="bnb")
    """, rules={"R13"}) == []


# -- R7: the frontier's in-place contract -----------------------------------------


@pytest.mark.parametrize("body", [
    "return Frontier(torch.cat([fr.nodes, fr.nodes]), fr.count, fr.overflow)",
    "return Frontier(fr.nodes.clone(), fr.count, fr.overflow)",
    "nodes = fr.nodes.to(torch.int64)\n    return Frontier(nodes, fr.count, fr.overflow)",
    "return Frontier(nodes=torch.where(fr.nodes > 0, fr.nodes, 0), count=fr.count, overflow=fr.overflow)",
])
def test_r7_fires_on_a_fresh_frontier_buffer(body):
    src = f"import torch\n\ndef step(fr: Frontier, k):\n    {body}\n"
    assert rules_of(graftlint.lint_text(src, "f.py", rules={"R7"})) == ["R7"], body


def test_r7_fires_on_rebinding_the_buffer_param():
    assert rules_of(lint("""
        import torch

        def grow(nodes, rows):
            nodes = torch.cat([nodes, rows])
            return nodes
    """, rules={"R7"})) == ["R7"]


def test_r7_quiet_on_in_place_frontiers():
    assert lint("""
        import torch

        def step(fr, keep, take):
            fr.nodes[:take].copy_(keep)
            return Frontier(fr.nodes, torch.tensor(take), fr.overflow)

        def build(rows):
            return Frontier(torch.zeros(rows), 0, False)   # no frontier in
    """, rules={"R7"}) == []
    vs, waived = lint_port_file("tsp_mpi_reduction_tpu_torch/models/branch_bound.py", rules={"R7"})
    assert vs == [] and waived == []


# -- R8: recording inside a CUDA-graph capture ---------------------------------------


def test_r8_fires_inside_a_capture():
    vs = lint("""
        import torch
        from ..obs import tracing as _tracing
        from ..obs.metrics import REGISTRY

        def capture(fn, g):
            with torch.cuda.graph(g):
                fn()
                REGISTRY.inc("launches_total")

        def body(x):
            _tracing.span("step")
            return x

        graphed = torch.cuda.make_graphed_callables(body, (torch.zeros(2),))
    """, rules={"R8"})
    assert [(v.scope, v.rule) for v in vs] == [("capture", "R8"), ("body", "R8")]


def test_r8_quiet_on_the_kernel_times_capture():
    vs, waived = lint_port_file("tsp_mpi_reduction_tpu_torch/tools/kernel_times.py", rules={"R8"})
    assert vs == [] and waived == []
    assert "with torch.cuda.graph(graph):" in (PORT / "tools" / "kernel_times.py").read_text()
    assert lint("""
        import torch
        from ..obs.metrics import REGISTRY

        def capture(fn, g):
            with torch.cuda.graph(g):
                fn()
            g.replay()
            REGISTRY.inc("replays_total")
    """, rules={"R8"}) == []


# -- the framework ----------------------------------------------------------------


def test_disable_grammar_line_line_above_def_line_and_bare():
    base = "def f(fr):\n    for _ in range(2):\n        {pre}x = int(fr.count){post}\n"
    assert len(graftlint.lint_text(base.format(pre="", post=""), "f.py", rules={"R1"})) == 1
    for pre, post in (("", "  # graftlint: disable=R1"), ("", "  # why  # graftlint: disable=R4,R1"),
                      ("# graftlint: disable=R1\n        ", ""), ("", "  # graftlint: disable")):
        waived = []
        assert graftlint.lint_text(base.format(pre=pre, post=post), "f.py", rules={"R1"},
                                   waived=waived) == [], (pre, post)
        assert [v.rule for v in waived] == ["R1"]
    src = "def f(fr):  # graftlint: disable=R1\n    for _ in range(2):\n        x = int(fr.count)\n"
    assert graftlint.lint_text(src, "f.py", rules={"R1"}) == []
    other = "def f(fr):\n    for _ in range(2):\n        x = int(fr.count)  # graftlint: disable=R2\n"
    assert len(graftlint.lint_text(other, "f.py", rules={"R1"})) == 1


def test_hot_lines_follow_the_lints_rules():
    src = textwrap.dedent("""
        def cold(x):
            y = x
            for i in range(3):
                y = y + i
            while y:
                y -= 1
            return y

        def fold_tours(a):
            return a

        def marked(a):  # graftlint: hot
            f = lambda: a
            return f
    """)
    hot = graftlint.hot_lines(src)
    lines = src.splitlines()
    assert {lines[i - 1].strip() for i in hot} == {"y = y + i", "while y:", "y -= 1", "return a",
                                                   "f = lambda: a", "return f"}


def test_baseline_round_trip_is_line_free(tmp_path):
    src = textwrap.dedent(R1_LOOP)
    vs = graftlint.lint_text(src, "m.py", rules={"R1"})
    path = tmp_path / "b.json"
    graftlint.write_baseline(path, vs)
    base = graftlint.load_baseline(path)
    assert base == {vs[0].fingerprint: 1} and "::R1::run::" in vs[0].fingerprint
    shifted = graftlint.lint_text("\n\n\n" + src, "m.py", rules={"R1"})
    assert shifted[0].line == vs[0].line + 3
    res = graftlint.apply_baseline(shifted, base)
    assert res.new == [] and len(res.accepted) == 1 and res.stale == []
    res = graftlint.apply_baseline(shifted + shifted, base)  # surplus counts as new
    assert len(res.new) == 1
    assert graftlint.apply_baseline([], base).stale == [vs[0].fingerprint]


def test_dead_scopes_are_reported(tmp_path):
    (tmp_path / "m.py").write_text("def kept():\n    pass\n")
    base = {"m.py::R1::kept::x": 1, "m.py::R1::gone::x": 1, "missing.py::R1::f::x": 1, "bad": 1}
    assert graftlint.find_dead_scopes(base, tmp_path) == sorted(
        ["m.py::R1::gone::x", "missing.py::R1::f::x", "bad"])


def test_cli_exit_codes_json_and_sarif(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(R1_LOOP))
    empty = tmp_path / "empty.json"
    assert cli.main([str(bad), f"--baseline={empty}"]) == 1
    assert "R1 [run]" in capsys.readouterr().out
    assert cli.main([str(bad), "--rules=R6", f"--baseline={empty}"]) == 0
    capsys.readouterr()
    assert cli.main([str(tmp_path / "nope.py")]) == 2
    assert cli.main(["--rules=R99"]) == 2
    capsys.readouterr()
    sarif = tmp_path / "out.sarif"
    assert cli.main([str(bad), "--json", f"--sarif={sarif}", f"--baseline={empty}"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["new"] == 1 and rep["per_rule"]["R1"] == {"new": 1, "baselined": 0, "waived": 0}
    assert set(rep["per_rule"]) == set(cli.ALL_RULES)
    doc = json.loads(sarif.read_text())
    assert doc["version"] == "2.1.0" and doc["$schema"].endswith("sarif-schema-2.1.0.json")
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftlint-torch"
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == sorted(cli.ALL_RULES)
    (res,) = run["results"]
    assert res["ruleId"] == "R1" and res["locations"][0]["physicalLocation"]["region"]["startLine"] == 8
    assert res["partialFingerprints"]["graftlint/v1"].endswith("if int(fr.count) == 0:")


def test_cli_write_baseline_refusals(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(R1_LOOP))
    assert cli.main([str(bad), "--write-baseline"]) == 2  # partial surface into the default file
    assert cli.main([str(bad), "--write-baseline", "--json", f"--baseline={tmp_path / 'b.json'}"]) == 2
    out = tmp_path / "b.json"
    assert cli.main([str(bad), "--write-baseline", f"--baseline={out}"]) == 0
    assert cli.main([str(bad), f"--baseline={out}", "--quiet"]) == 0
    assert "0 new, 1 baselined" in capsys.readouterr().out


# -- the repo gate ---------------------------------------------------------------


def test_repo_surface_is_clean_modulo_the_baseline(surface):
    res, _, dead, _ = surface
    assert res.new == [], "\n".join(v.render() for v in res.new)
    assert res.stale == [] and dead == []


def test_baseline_never_grows_and_names_its_levers(surface):
    res, waived, _, baseline = surface
    assert len(baseline) == sum(baseline.values()) <= BASELINE_ENTRIES
    # the merge fold's two entries left with the graph store (its inf fill
    # is a Python scalar and its merges are graph replays on CUDA), the
    # B&B step's two with the predicated step and its graph, and the ILS
    # polish's one with the predicated sweep step and its graph
    assert res.accepted == []
    comment = json.loads(cli._DEFAULT_BASELINE.read_text())["comment"]
    assert "'The ILS polish' left it last" in comment
    assert "'The merge fold' left the baseline" in comment
    assert "'The B&B expansion step' left the baseline" in comment
    # every inline waiver is a suppressed finding, never a blanket one
    assert all(v.rule in cli.ALL_RULES for v in waived)


def test_the_cli_exits_0_on_the_tree_and_no_baseline_reports_exactly_the_entries(surface, capsys):
    res, _, _, baseline = surface
    assert cli.main(["--quiet"]) == 0
    # an empty baseline: without it the tree is as clean as with it
    assert cli.main(["--no-baseline", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert rep["new"] == len(baseline) == len(res.accepted) == 0


def test_importing_the_lint_loads_no_torch_or_jax():
    code = ("import sys, json; import tsp_mpi_reduction_tpu_torch.analysis.__main__; "
            "import tsp_mpi_reduction_tpu_torch.analysis.sarif; "
            "print(json.dumps([m for m in ('torch', 'jax', 'tsp_mpi_reduction_tpu', 'numpy') "
            "if m in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert json.loads(out.stdout) == []


def test_sweep_refuses_on_new_findings_before_resolving_a_device(monkeypatch, tmp_path, capsys):
    from tsp_mpi_reduction_tpu_torch.tools import sweep
    from tsp_mpi_reduction_tpu_torch.utils import backend

    seen = {}
    monkeypatch.setattr(cli, "main", lambda argv: seen.setdefault("argv", argv) and 1)

    def no_device(*a, **k):
        raise AssertionError("resolve_device ran before the lint gate")

    monkeypatch.setattr(backend, "resolve_device", no_device)
    out = tmp_path / "q.csv"
    assert sweep.main(["--quick", "--backend=cpu", f"--out={out}"]) == 2
    assert seen["argv"] == ["--quiet"] and not out.exists()
    assert "fix or baseline them first" in capsys.readouterr().err
