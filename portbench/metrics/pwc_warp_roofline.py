"""The pwc arch's feature warps (the span ``pwc_warp``,
``models/motion_cnn.py::feature_warp``): the least time their function's
bytes need at the card's HBM bandwidth (``_pwc_work.warp_bytes``: the
features and the flow in, the warped features out, per level and pair),
over the device time of the kernels launched inside the span, in %."""

from portbench.metrics import _pwc, _pwc_work

MERGE = "mean"


def read(run):
    return _pwc.roofline(run, "pwc_warp", _pwc_work.warp_bytes)
