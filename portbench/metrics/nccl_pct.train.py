"""Share of the traced window in which an NCCL kernel ran on the rank's
card, in %; on several ranks the largest."""

from portbench.tracing import is_nccl

MERGE = "max"


def read(run):
    if run.trace is None or run.world < 2:
        return None
    t = run.trace.union_s(lambda name, kind, link: is_nccl(name))
    return 100.0 * t / run.trace.window_s
