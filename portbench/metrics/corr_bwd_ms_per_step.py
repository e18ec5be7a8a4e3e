"""Device ms per training step of the kernels launched inside the span
``corr_bwd`` (``models/motion_cnn.py::_CorrInputBf16.backward``: the
bf16 correlation's gradient, shift by shift), over the window's steps;
on several ranks the largest."""

from portbench.metrics import _spans

MERGE = "max"


def read(run):
    if (run.trace is None or not run.work.get("steps")
            or not _spans.opened(run.trace, "corr_bwd")):
        return None
    t = run.trace.sum_s(run.trace.under(_spans.PREFIX + "corr_bwd"))
    return 1e3 * t / run.work["steps"]
