"""Set-up time: from the process's start to the window's, every rank's
set-up included (imports, the CUDA context, kernels built or loaded,
weights, inputs, warm-up)."""

MERGE = "max"


def read(run):
    return run.setup_s
