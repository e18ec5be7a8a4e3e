"""The program's spans in a ``tracing.Trace``: host ops named
``dvsg.<name>`` (``dvsg_tpu_torch/utils/metrics.py::span``), which the
program opens only while a profiler runs. A trace of a program without
them has none, and the readers of this module's callers then read
nothing."""

from portbench.tracing import is_nccl

PREFIX = "dvsg."


def union(intervals) -> list:
    """The sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length_ns(intervals: list) -> int:
    return sum(e - s for s, e in intervals)


def overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two unions."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def opened(trace, name: str) -> list:
    """The union of the spans ``dvsg.<name>`` of every thread, clipped to
    the traced window ([] where none falls in it)."""
    full, lo, hi = PREFIX + name, trace.t0_ns, trace.t1_ns
    return union((max(s, lo), min(e, hi))
                 for _, ops, _ in trace.threads.values()
                 for s, e, op in ops
                 if op == full and min(e, hi) > max(s, lo))


def compute_busy(trace) -> list:
    """The union of the device operations but NCCL's kernels (the busy
    time of ``device_idle_pct``)."""
    return union((s, e) for s, e, name, kind, link in trace.device
                 if not is_nccl(name))
