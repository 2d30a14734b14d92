"""The window's milliseconds over the proofs completed in it: what a
solver user waits per new instance, bound setup and incumbent included."""


def read(run):
    return 1e3 * run.seconds / len(run.answers) if run.answers else None
