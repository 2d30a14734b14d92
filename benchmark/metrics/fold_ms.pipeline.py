"""Mean milliseconds of a run's sequential fold (the program's
``PhaseTimer`` phase ``merge_fold``, which ends in a synchronize)."""


def read(run):
    v = [a["phase_s"]["merge_fold"] for a in run.answers if "merge_fold" in a.get("phase_s", {})]
    return 1e3 * sum(v) / len(v) if v else None
