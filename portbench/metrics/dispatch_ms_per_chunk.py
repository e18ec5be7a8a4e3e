"""The stream driver's own ``dispatch`` stage (``pipeline/overlap.py``:
queuing one chunk's step on the card), host ms per chunk, from the
``StageTimer`` the benchmark passes in."""

MERGE = "max"


def read(run):
    stage = run.stages.get("dispatch")
    return stage["mean_ms"] if stage else None
