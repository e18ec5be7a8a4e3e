"""The pwc arch's cost volumes (the span ``pwc_corr``,
``models/motion_cnn.py::MotionEstimator.pwc_flow``): the least time their
function's bytes need at the card's HBM bandwidth (``_pwc_work.
corr_bytes``: both levels' features in, the volume out, per level and
pair), over the device time of the kernels launched inside the span,
in %."""

from portbench.metrics import _pwc, _pwc_work

MERGE = "mean"


def read(run):
    return _pwc.roofline(run, "pwc_corr", _pwc_work.corr_bytes)
