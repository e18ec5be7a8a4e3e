"""Share of the traced window, on the host clock, in which no operation
but NCCL's ran on any stream of the rank's card, in %; on several ranks
the largest. An NCCL kernel waits for its peers, so it is not counted as
work here (``nccl_pct.train`` counts it)."""

MERGE = "max"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.compute_busy_s() / run.trace.window_s)
