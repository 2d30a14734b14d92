"""The window's milliseconds over the pipeline runs completed in it: the
reference program's own wall-clock line, per run."""


def read(run):
    return 1e3 * run.seconds / len(run.answers) if run.answers else None
