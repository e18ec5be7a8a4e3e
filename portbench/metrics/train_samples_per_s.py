"""Clips whose update completed (global batch times steps), over the
whole window; on several ranks the slowest rank's window."""

MERGE = "min"


def read(run):
    return run.work["samples"] / run.window_s
