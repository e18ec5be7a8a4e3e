"""B2 and B3, the f32 warps of a training step
(``csrc/warp_bilinear.cu``: the render's, the loss warp's forward and
backward): the least time their bytes need at the card's HBM bandwidth,
over their summed device time, in %."""

from portbench.metrics import _work

MERGE = "mean"


def _warp(name, kind, link):
    return kind == "kernel" and "warp_f32" in name


def read(run):
    if run.trace is None:
        return None
    t = run.trace.sum_s(_warp)
    if not t:
        return None
    need = run.work["steps"] * _work.train_warp_bytes(
        run.model, run.work["rank_batch"]) / _work.PEAKS["hbm_bytes_per_s"]
    return 100.0 * need / t
