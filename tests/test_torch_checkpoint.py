"""Port parity of the checkpoint store and the B&B checkpoint, resume and
sliced-solve paths, on the CPU, against the JAX package.

- the TSPCKPT1 store: one package's images read by the other, rotation,
  and the fallback past a torn newest file;
- the snapshot payload: the port's equals the JAX package's key for key
  (dtype, shape and value) for the same state;
- snapshots cross packages in both directions: a resume from either
  package's snapshot equals the JAX package's own resume on nodes,
  iterations, cost, tour, both lower bounds and every spill counter;
- the refusals (another instance, another bound, a sharded snapshot, the
  old mask layout); the certified LB monotone across chunks; the save
  cadence under the device loop; a resume with a larger k; ``solve_slice``
  and ``ResumeHandle``; a torn ``ckpt.write`` recovered from the rotation.

Instances are integer metrics made with numpy from a seed, so every value
compared is exact (integers, and float32 values on the integer grid).
Each package's fault registry and health counters are its own; the
port's are configured and read through the port's modules.
"""

import io

import numpy as np
import pytest
import torch

from tsp_mpi_reduction_tpu.models import branch_bound as jbb
from tsp_mpi_reduction_tpu.perf import compile_cache as jcompile_cache
from tsp_mpi_reduction_tpu.resilience import checkpoint as jck
from tsp_mpi_reduction_tpu_torch.models import branch_bound as tbb
from tsp_mpi_reduction_tpu_torch.resilience import checkpoint as tck
from tsp_mpi_reduction_tpu_torch.resilience import faults as tfaults
from tsp_mpi_reduction_tpu_torch.resilience.health import HEALTH as THEALTH


@pytest.fixture(autouse=True)
def _jax_aot_off(monkeypatch):
    """The JAX oracle takes its jit path. Once ``compile_cache.enable()``
    has run in this process (an earlier test's serve CLI does), its
    solves would load whatever executables the shared AOT store holds,
    some compiled for an 8-device mesh."""
    monkeypatch.setattr(jcompile_cache, "_enabled_dir", None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_d(n, seed):
    """Integer metric: rounded Euclidean distances of seeded random points."""
    xy = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    return np.rint(np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1)) * 10)


SPILL_FIELDS = ("spill_rounds", "spill_events", "spill_full_merges", "spill_bytes_to_host",
                "spill_bytes_to_device")


def _fields(res):
    return (res.cost, res.proven_optimal, res.nodes_expanded, res.iterations, res.lower_bound,
            res.lower_bound_raw, tuple(int(x) for x in res.tour),
            *(getattr(res, f) for f in SPILL_FIELDS))


def _payload(path):
    """The arrays of a snapshot file (the store's payload, unpacked)."""
    _header, blob, _src, _fb = jck.read_with_fallback(path)
    with np.load(io.BytesIO(blob)) as z:
        return {key: z[key] for key in z.files}


def _assert_same_payload(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


#: the host loop that spills (tests/test_bnb.py's spill round trip) and the
#: device loop that compacts and spills (capacity at 4*k*(n-1))
HOST = (random_d(12, 22), dict(capacity=256, k=8, inner_steps=1, bound="min-out", mst_prune=False,
                               node_ascent=0, device_loop=False), 40)
DEVICE = (random_d(13, 1), dict(capacity=384, k=8, bound="min-out", mst_prune=False, node_ascent=0,
                                ils_rounds=0, device_loop=True), 1000)


# --------------------------------------------------------------------------- the store


def test_store_images_cross_packages_and_rotate(tmp_path):
    """Each package reads the other's images; the image bytes of one
    payload are the same; rotation keeps TSP_CKPT_KEEP snapshots, newest
    first, in both."""
    for writer, reader in ((tck, jck), (jck, tck)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.npz")
        for i in range(5):
            writer.write_atomic(path, f"snap-{i}".encode(), fingerprint="ab12",
                                extra_header={"frontier_layout": 2})
        assert reader.rotation_paths(path) == writer.rotation_paths(path)
        chain = [open(p, "rb").read() for p in reader.rotation_paths(path)]
        assert [reader.unpack(b)[1] for b in chain] == [b"snap-4", b"snap-3", b"snap-2"]
        header, payload, src, fallbacks = reader.read_with_fallback(path)
        assert (payload, src, fallbacks) == (b"snap-4", path, 0)
        assert header["fingerprint"] == "ab12" and header["frontier_layout"] == 2
    extra = {"frontier_layout": 2}
    assert tck.pack(b"xyz", "ab12", extra) == jck.pack(b"xyz", "ab12", extra)
    d = random_d(11, 4)
    assert tck.instance_fingerprint(d) == jck.instance_fingerprint(d)


def test_store_falls_back_past_a_torn_file(tmp_path):
    """A torn newest snapshot is skipped for the previous one, and the
    port's HEALTH counts the fallback."""
    path = str(tmp_path / "torn.npz")
    tck.write_atomic(path, b"first-snapshot", fingerprint="ab12")
    tck.write_atomic(path, b"second-snapshot", fingerprint="ab12")
    with open(path, "r+b") as f:
        f.truncate(len(open(path, "rb").read()) - 3)
    before = THEALTH.get("fallback_restores")
    _h, payload, src, fallbacks = tck.read_with_fallback(path)
    assert (payload, src, fallbacks) == (b"first-snapshot", path + ".1", 1)
    assert THEALTH.get("fallback_restores") == before + 1
    assert jck.read_with_fallback(path)[1:] == (b"first-snapshot", path + ".1", 1)
    with pytest.raises(tck.CheckpointError):
        tck.unpack(open(path, "rb").read())


# --------------------------------------------------------------------------- payload, resume


@pytest.mark.parametrize("case", [HOST, DEVICE], ids=["host-loop", "device-loop"])
def test_snapshots_cross_packages_both_ways(case, tmp_path):
    """Chunk 1 in each package writes a snapshot; the two payloads are
    equal key for key. Then each snapshot is resumed by both packages to
    the proof: the port's resume of the JAX snapshot equals the JAX
    package's own, and the JAX package's resume of the port's snapshot
    equals the port's own."""
    d, kw, first = case
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want1 = jbb.solve(d, max_iters=first, checkpoint_path=jpath, **kw)
    got1 = tbb.solve(d, max_iters=first, checkpoint_path=tpath, device="cpu", **kw)
    assert not got1.proven_optimal and got1.spill_rounds > 0
    assert _fields(got1) == _fields(want1)
    payload = _payload(tpath)
    _assert_same_payload(payload, _payload(jpath))
    assert "res_path" in payload and payload["lb_certified"] == got1.lower_bound
    header = tck.read_header(tpath)
    assert header["fingerprint"] == tck.instance_fingerprint(d) and header["frontier_layout"] == 2

    rest = dict(max_iters=2_000_000, **kw)
    jax_own = jbb.solve(d, resume_from=jpath, **rest)
    port_of_jax = tbb.solve(d, resume_from=jpath, device="cpu", **rest)
    assert port_of_jax.proven_optimal
    assert _fields(port_of_jax) == _fields(jax_own)
    port_own = tbb.solve(d, resume_from=tpath, device="cpu", **rest)
    jax_of_port = jbb.solve(d, resume_from=tpath, **rest)
    assert _fields(jax_of_port) == _fields(port_own) == _fields(jax_own)


def test_restore_rebuilds_the_packed_buffer(tmp_path):
    """restore() returns the same packed rows, count, overflow, incumbent,
    reservoir rows and certified floor as the JAX restore()."""
    d, kw, first = HOST
    path = str(tmp_path / "r.npz")
    jbb.solve(d, max_iters=first, checkpoint_path=path, **kw)
    want = jbb.restore(path, expect_d=d, expect_bound="min-out")
    got = tbb.restore(path, expect_d=d, expect_bound="min-out", device="cpu")
    np.testing.assert_array_equal(got[0].nodes.numpy(), np.asarray(want[0].nodes))
    assert int(got[0].count) == int(want[0].count) and bool(got[0].overflow) == bool(want[0].overflow)
    assert got[1].dtype == torch.float32 and float(got[1]) == float(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(np.concatenate(got[3].chunks), np.concatenate(want[3].chunks))
    assert got[4] == want[4]


def _other_snapshot(kind, d, tmp_path):
    """A snapshot that a resume of ``d`` under min-out must refuse."""
    path = str(tmp_path / f"{kind}.npz")
    if kind == "instance":
        jbb.solve(random_d(12, 99), max_iters=3, checkpoint_path=path, **HOST[1])
    elif kind == "bound":
        jbb.solve(d, max_iters=3, checkpoint_path=path, **dict(HOST[1], bound="one-tree"))
    elif kind == "ranks":
        fr, inc, tour, rv, _ = jbb.restore(_ours(d, tmp_path))
        jbb.save(path, fr, inc, tour, d=d, bound="min-out", reservoir=rv, num_ranks=4)
    elif kind == "mask-layout":
        z = _payload(_ours(d, tmp_path))
        z["mask"] = z["mask"][:, 0]
        tck.write_atomic(path, tck.npz_bytes(**z), fingerprint=tck.instance_fingerprint(d))
    return path


def _ours(d, tmp_path):
    path = str(tmp_path / "ours.npz")
    tbb.solve(d, max_iters=3, checkpoint_path=path, device="cpu", **HOST[1])
    return path


@pytest.mark.parametrize(
    "kind,match",
    [("instance", "different instance"), ("bound", "bound='one-tree'"), ("ranks", "4 ranks"),
     ("mask-layout", "pre-multi-word mask layout")],
)
def test_restore_refuses_what_the_jax_package_refuses(kind, match, tmp_path):
    d = HOST[0]
    path = _other_snapshot(kind, d, tmp_path)
    with pytest.raises(ValueError, match=match):
        jbb.restore(path, expect_d=d, expect_bound="min-out")
    with pytest.raises(ValueError, match=match):
        tbb.restore(path, expect_d=d, expect_bound="min-out", device="cpu")
    with pytest.raises(ValueError, match=match):
        tbb.solve(d, resume_from=path, device="cpu", **HOST[1])


def test_payload_after_an_overflow_keeps_only_the_floor():
    """With the overflow flag set the open set no longer covers the
    search: lb_certified is the caller's floor, in both packages."""
    d, kw, first = HOST
    fr = tbb.make_root_frontier(12, 256, np.zeros(12), device="cpu", pad_rows=96)
    fr = tbb.Frontier(fr.nodes, fr.count, torch.tensor(True))
    tour = np.arange(13, dtype=np.int32) % 12
    got = tbb._ckpt_payload(fr, torch.tensor(500.0), torch.as_tensor(tour), d=d, bound="min-out",
                            lb_floor=123.0)
    jfr = jbb.Frontier(fr.nodes.numpy(), fr.count.numpy(), np.asarray(True))
    want = jbb._ckpt_payload(jfr, np.float32(500.0), tour, d=d, bound="min-out", lb_floor=123.0)
    _assert_same_payload(got, {key: np.asarray(v) for key, v in want.items()})
    assert float(got["lb_certified"]) == 123.0


# --------------------------------------------------------------------------- chunked campaigns


def test_certified_lb_monotone_across_chunks(tmp_path):
    """tests/test_bnb.py's monotone-LB campaign, chunk for chunk equal to
    the JAX package's: every chunk's certified LB is at least the last
    one's and at least its own raw LB; the snapshot carries the floor."""
    d = random_d(12, 33)
    kw = dict(capacity=1 << 13, k=8, inner_steps=1, bound="min-out", mst_prune=False,
              node_ascent=0, device_loop=False, max_iters=3)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = jbb.solve(d, checkpoint_path=jpath, **kw)
    got = tbb.solve(d, checkpoint_path=tpath, device="cpu", **kw)
    assert _fields(got) == _fields(want) and not got.proven_optimal
    prev = got.lower_bound
    for _ in range(4):
        want = jbb.solve(d, resume_from=jpath, checkpoint_path=jpath, **kw)
        got = tbb.solve(d, resume_from=tpath, checkpoint_path=tpath, device="cpu", **kw)
        assert _fields(got) == _fields(want)
        assert prev <= got.lower_bound <= got.cost and got.lower_bound >= got.lower_bound_raw
        prev = got.lower_bound
    assert tbb.restore(tpath, expect_d=d, expect_bound="min-out", device="cpu")[4] == got.lower_bound


def _save_log(module, monkeypatch):
    """Record (count, reservoir rows, incumbent) at every save() call."""
    calls = []
    real = module.save

    def spy(path, fr, inc_cost, inc_tour, **kw):
        rv = kw.get("reservoir")
        calls.append((int(fr.count), len(rv) if rv is not None else 0, float(inc_cost)))
        return real(path, fr, inc_cost, inc_tour, **kw)

    monkeypatch.setattr(module, "save", spy)
    return calls


@pytest.mark.parametrize(
    "d,kw",
    [
        # tests/test_bnb.py's cadence run: many small device-loop runs
        (random_d(12, 5), dict(capacity=512, k=8, bound="min-out", mst_prune=False,
                               max_iters=400, checkpoint_every=16)),
        # the re-sort across checkpoint-capped runs (6 steps < period 4's reach)
        (np.rint(random_d(16, 3) / 10), dict(capacity=1 << 14, k=32, bound="min-out",
                                             mst_prune=False, max_iters=40, reorder_every=4,
                                             checkpoint_every=6)),
    ],
    ids=["cadence-16", "reorder-4-every-6"],
)
def test_device_loop_save_cadence_matches_jax(d, kw, monkeypatch, tmp_path):
    """Under the device loop the runs stop at the save step, so the saves
    fall where the JAX package's fall: the same number of saves, each
    with the same count, reservoir size and incumbent, and the same
    search."""
    want_calls = _save_log(jbb, monkeypatch)
    got_calls = _save_log(tbb, monkeypatch)
    want = jbb.solve(d, device_loop=True, checkpoint_path=str(tmp_path / "j.npz"), **kw)
    got = tbb.solve(d, device_loop=True, checkpoint_path=str(tmp_path / "t.npz"), device="cpu", **kw)
    assert _fields(got) == _fields(want)
    assert got_calls == want_calls
    periodic = len(got_calls) - (0 if got.proven_optimal else 1)
    assert periodic >= got.iterations // kw["checkpoint_every"] - 1 >= 2


@pytest.mark.parametrize("args", [(100, 50, None), (100, 50, 7), (5, 50, 16), (10, 10**9, 0)])
def test_dispatch_budget_checkpoint_cap_matches_jax(args):
    assert tbb._dispatch_budget(*args) == jbb._dispatch_budget(*args, 0.0, None, 5000)


@pytest.mark.parametrize("k1,iters,k2,in_band", [(8, 60, 32, False), (16, 20, 36, True)],
                         ids=["test_bnb-k8-to-32", "overhang-k16-to-36"])
def test_resume_with_a_larger_k_sheds_the_overhang(k1, iters, k2, in_band, tmp_path):
    """tests/test_bnb.py's k mismatch (k = 8 resumed at 32), and a resume
    whose larger k claims so many push-padding rows that the restored count
    lies inside the smaller logical capacity's spill band: the first
    exchange sheds the overhang. Either resume equals the JAX package's."""
    d = random_d(12, 23)
    kw = dict(capacity=1024, inner_steps=1, bound="min-out", mst_prune=False)
    path = str(tmp_path / "k.npz")
    first = tbb.solve(d, k=k1, max_iters=iters, checkpoint_path=path, device="cpu", **kw)
    assert not first.proven_optimal and first.spill_rounds == 0
    fr = tbb.restore(path, device="cpu")[0]
    capacity = fr.nodes.shape[0] - k2 * 12
    assert (int(fr.count) > capacity - tbb._spill_headroom(capacity, 1, k2, 12)) == in_band
    want = jbb.solve(d, k=k2, max_iters=2_000_000, resume_from=path, **kw)
    got = tbb.solve(d, k=k2, max_iters=2_000_000, resume_from=path, device="cpu", **kw)
    assert got.proven_optimal and got.spill_rounds > 0
    assert _fields(got) == _fields(want)


# --------------------------------------------------------------------------- sliced solves

#: tests/test_serve_preempt.py's proof instance, cut into max_iters slices
SLICE_D = random_d(12, 33)
SLICE_KW = dict(capacity=256, k=8, inner_steps=1, bound="min-out", mst_prune=False, node_ascent=0,
                device_loop=False, max_iters=400)


def _slice_to_proof(module, path, **extra):
    res, handle = module.solve_slice(SLICE_D, 600.0, checkpoint_path=path, **SLICE_KW, **extra)
    slices = 1
    while handle is not None:
        assert slices < 100, "sliced solve failed to converge"
        res, handle = module.solve_slice(SLICE_D, 600.0, handle, **SLICE_KW, **extra)
        slices += 1
    return res, slices


def test_solve_slice_equals_the_uninterrupted_solve(tmp_path):
    """A proof cut into max_iters slices ends at the uninterrupted proof's
    cost, certified LB and tour, and slice for slice as the JAX
    package's sliced proof."""
    ref = tbb.solve(SLICE_D, device="cpu", **dict(SLICE_KW, max_iters=2_000_000))
    got, slices = _slice_to_proof(tbb, str(tmp_path / "t.npz"), device="cpu")
    want, want_slices = _slice_to_proof(jbb, str(tmp_path / "j.npz"))
    assert slices >= 2 and ref.proven_optimal and got.proven_optimal
    assert (got.cost, got.lower_bound) == (ref.cost, ref.lower_bound)
    assert np.array_equal(got.tour, ref.tour)
    assert slices == want_slices and _fields(got) == _fields(want)


def test_solve_slice_handle_reports_progress(tmp_path):
    res, handle = tbb.solve_slice(SLICE_D, 600.0, checkpoint_path=str(tmp_path / "h.npz"),
                                  device="cpu", **SLICE_KW)
    assert handle.slices == 1 and handle.elapsed_s > 0
    assert handle.first_lower_bound == res.root_lower_bound
    assert handle.incumbent == res.cost and handle.lower_bound == res.lower_bound
    assert 0.0 <= handle.gap_progress() <= 1.0
    _, h2 = tbb.solve_slice(SLICE_D, 600.0, handle, device="cpu", **SLICE_KW)
    assert h2.slices == 2 and h2.elapsed_s > handle.elapsed_s
    assert h2.first_lower_bound == handle.first_lower_bound
    assert h2.gap_progress() >= handle.gap_progress()
    with pytest.raises(ValueError, match="checkpoint_path"):
        tbb.solve_slice(SLICE_D, 1.0, device="cpu", **SLICE_KW)
    span_zero = tbb.ResumeHandle("p", 1, 0.0, incumbent=5.0, lower_bound=5.0, first_lower_bound=5.0)
    assert span_zero.gap_progress() == jbb.ResumeHandle(*vars(span_zero).values()).gap_progress() == 0.0


@pytest.mark.chaos
def test_solve_slice_survives_a_torn_checkpoint_write(tmp_path):
    """ckpt.write:truncate mid-proof (the port's own fault registry): the
    slice whose publish is torn dies with FaultInjected, the retry resumes
    from the newest valid snapshot (the port's fallback_restores counts
    it), and the proof still lands on the uninterrupted one."""
    ref = tbb.solve(SLICE_D, device="cpu", **dict(SLICE_KW, max_iters=2_000_000))
    path = str(tmp_path / "torn.npz")
    before = THEALTH.snapshot()
    tfaults.configure("ckpt.write:truncate,nth=3,seed=5")
    try:
        res = handle = None
        crashes = 0
        for _ in range(100):
            try:
                res, handle = tbb.solve_slice(SLICE_D, 600.0, handle, checkpoint_path=path,
                                              device="cpu", **SLICE_KW)
            except tfaults.FaultInjected:
                crashes += 1
                continue
            if handle is None:
                break
        hits = tfaults.registry().hits("ckpt.write")
    finally:
        tfaults.clear()
    assert hits > 0 and crashes == 1
    assert res.proven_optimal and (res.cost, res.lower_bound) == (ref.cost, ref.lower_bound)
    assert np.array_equal(res.tour, ref.tour)
    after = THEALTH.snapshot()
    assert after["fallback_restores"] > before["fallback_restores"]
    assert after["faults_injected"].get("ckpt.write", 0) > before["faults_injected"].get("ckpt.write", 0)
