"""Device ms per training step of the kernels launched inside the span
``render`` (``train/loop.py::render_batch``: the pose algebra and B2's
render warp), over the window's steps; on several ranks the largest."""

from portbench.metrics import _spans

MERGE = "max"


def read(run):
    if (run.trace is None or not run.work.get("steps")
            or not _spans.opened(run.trace, "render")):
        return None
    t = run.trace.sum_s(run.trace.under(_spans.PREFIX + "render"))
    return 1e3 * t / run.work["steps"]
