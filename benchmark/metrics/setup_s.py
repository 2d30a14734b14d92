"""Process start to the first timed call: imports, the CUDA context, the
kernels' build or load, the inputs, and the warm-up call with its graph
captures."""


def read(run):
    return run.setup_s
