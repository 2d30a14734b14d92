"""``relax_dense_sweep``'s share of its roofline over the traced runs, in
percent: the dense Held-Karp DP of every block of a run (``benchmark/counts``),
once a traced run, over the kernel's summed device time in the trace."""

from benchmark import counts


def read(run):
    launches, secs = run.trace.kernel("relax_dense_sweep") if run.trace else (0, 0.0)
    if not launches or secs <= 0 or not run.trace.calls:
        return None
    dep = run.cell.config["deployment"]
    elt = 8 if dep["dtype"] == "float64" else 4
    nbytes, ops = counts.relax_dense_counts(dep["num_blocks"], dep["cities_per_block"] - 1, elt)
    return 100.0 * run.trace.calls * counts.bound_s(nbytes, ops, dep["dtype"]) / secs
