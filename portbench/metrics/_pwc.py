"""The roofline share of a pwc span's kernels, for the metrics that read
one."""

from portbench.metrics import _spans, _work


def roofline(run, span: str, bytes_of) -> float | None:
    """``bytes_of(model, pairs)`` over the window's pairs (T (N - 1) a
    chunk) at the HBM peak, over the device time of the kernels launched
    inside ``dvsg.<span>``, in %; None without a trace or the span."""
    if (run.trace is None or not run.work.get("chunks")
            or not _spans.opened(run.trace, span)):
        return None
    t = run.trace.sum_s(run.trace.under(_spans.PREFIX + span))
    if not t:
        return None
    pairs = (run.work["chunks"] * run.work["chunk_frames"]
             * (run.model["window"] - 1))
    need = bytes_of(run.model, pairs) / _work.PEAKS["hbm_bytes_per_s"]
    return 100.0 * need / t
