"""The stream driver's own ``h2d`` stage (``pipeline/overlap.py``: the
copy into the pinned staging ring and the upload's enqueue), host ms per
chunk, from the ``StageTimer`` the benchmark passes in."""

MERGE = "max"


def read(run):
    stage = run.stages.get("h2d")
    return stage["mean_ms"] if stage else None
