"""Device ms per training step of the kernels launched inside the span
``bf16_round`` (``models/motion_cnn.py``: the bf16 rounding passes of
GELU, the conv's bias add, the casts to f32 and GroupNorm's normalize,
forward and backward), over the window's steps; on several ranks the
largest."""

from portbench.metrics import _spans

MERGE = "max"


def read(run):
    if (run.trace is None or not run.work.get("steps")
            or not _spans.opened(run.trace, "bf16_round")):
        return None
    t = run.trace.sum_s(run.trace.under(_spans.PREFIX + "bf16_round"))
    return 1e3 * t / run.work["steps"]
