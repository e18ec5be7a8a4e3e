"""Stabilized frames the writer received, over the whole window."""

MERGE = "min"


def read(run):
    return run.work["frames"] / run.window_s
