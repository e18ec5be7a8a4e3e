"""B1, the uint8 offsets warp (``csrc/warp_u8_offsets.cu``): the least
time its bytes need at the card's HBM bandwidth, over its device time,
in %. Each launch warps one chunk."""

from portbench.metrics import _work

MERGE = "mean"


def _b1(name, kind, link):
    return kind == "kernel" and "warp_u8_offsets" in name


def read(run):
    if run.trace is None:
        return None
    t = run.trace.sum_s(_b1)
    if not t:
        return None
    w = run.work
    per = _work.b1_bytes(w["chunk_frames"], w["height"], w["width"],
                         run.model["channels"], *run.model["grid_size"])
    need = run.trace.count(_b1) * per / _work.PEAKS["hbm_bytes_per_s"]
    return 100.0 * need / t
