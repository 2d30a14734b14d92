"""``push_rows``' share of its roofline over the traced proofs, in
percent: the bytes each launch's shape fixes (the parent rows and their
destinations; the pushed rows, which depend on the data, are not counted)
over the launches' summed device time in the trace."""

from benchmark import counts


def read(run):
    launches, secs = run.trace.kernel("push_rows") if run.trace else (0, 0.0)
    if not launches or secs <= 0:
        return None
    solver = dict(run.cell.config["solver"], **run.cell.traffic["solver"])
    parents = solver["k"] * solver.get("ranks", 1)
    n = run.cell.config["instance"]["dimension"]
    nbytes, _ = counts.push_rows_counts(parents, n, counts.frontier_cols(n), 0)
    return 100.0 * counts.bound_s(launches * nbytes, 0.0) / secs
