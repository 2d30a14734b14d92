"""Mean milliseconds a proof spends in its ILS incumbent (``BnBResult.ils_seconds``,
which ends in the tour's read to the host)."""


def read(run):
    v = [a["ils_s"] for a in run.answers if "ils_s" in a]
    return 1e3 * sum(v) / len(v) if v else None
