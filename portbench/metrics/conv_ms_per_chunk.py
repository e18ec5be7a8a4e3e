"""Device ms per chunk of the kernels launched inside a convolution op
(cuDNN's kernels of the encoder and the head, their bias adds)."""

MERGE = "max"


def read(run):
    if run.trace is None or not run.work.get("chunks"):
        return None
    t = run.trace.sum_s(run.trace.under("convolution"))
    return 1e3 * t / run.work["chunks"] if t else None
