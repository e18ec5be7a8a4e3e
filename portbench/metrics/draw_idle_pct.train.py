"""Share of the traced window in which a span ``draw`` was open and no
device operation but NCCL's ran, in %: the card's idle time while the
host drew the batch. It is the part of ``device_idle_pct.train`` spent in
the draws, so never above it. On several ranks the largest."""

from portbench.metrics import _spans

MERGE = "max"


def read(run):
    if run.trace is None:
        return None
    draws = _spans.opened(run.trace, "draw")
    if not draws:
        return None
    idle = _spans.length_ns(draws) - _spans.overlap_ns(
        draws, _spans.compute_busy(run.trace))
    return 100.0 * idle / 1e9 / run.trace.window_s
