"""Host ms per training step inside the span ``draw``
(``train/loop.py::draw_batch``: the batch's random draws and their upload
to the card), clipped to the traced window, over the window's steps; on
several ranks the largest."""

from portbench.metrics import _spans

MERGE = "max"


def read(run):
    if run.trace is None or not run.work.get("steps"):
        return None
    draws = _spans.opened(run.trace, "draw")
    if not draws:
        return None
    return _spans.length_ns(draws) / 1e6 / run.work["steps"]
