"""Mean milliseconds a proof spends in its root bound setup
(``BnBResult.ascent_seconds``: the float64 host ascent, then the bound
tables' uploads)."""


def read(run):
    v = [a["ascent_s"] for a in run.answers if "ascent_s" in a]
    return 1e3 * sum(v) / len(v) if v else None
