"""Mean milliseconds of a run's Held-Karp phase (the program's
``PhaseTimer`` phase ``solve``, which ends in a synchronize)."""


def read(run):
    v = [a["phase_s"]["solve"] for a in run.answers if "solve" in a.get("phase_s", {})]
    return 1e3 * sum(v) / len(v) if v else None
