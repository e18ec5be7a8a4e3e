"""Share of the traced window, on the host clock, in which no operation
ran on any stream of the card, in %."""

MERGE = "max"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.compute_busy_s() / run.trace.window_s)
