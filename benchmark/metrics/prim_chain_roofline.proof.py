"""``prim_chain``'s share of its roofline over the traced proofs, in
percent: the least device time the launches need (``benchmark/counts``:
the bytes each launch's lanes and cities fix) over their summed device
time in the trace. Each B&B step launches one chain without lam and one a
node ascent step with it."""

from benchmark import counts


def read(run):
    launches, secs = run.trace.kernel("prim_chain") if run.trace else (0, 0.0)
    if not launches or secs <= 0:
        return None
    solver = dict(run.cell.config["solver"], **run.cell.traffic["solver"])
    lanes = solver["k"] * solver.get("ranks", 1)
    n = run.cell.config["instance"]["dimension"]
    per_step = counts.bnb_step_prim_bytes(lanes, n, solver["node_ascent"])
    nbytes = launches * per_step / (1 + solver["node_ascent"])
    return 100.0 * counts.bound_s(nbytes, 0.0) / secs
