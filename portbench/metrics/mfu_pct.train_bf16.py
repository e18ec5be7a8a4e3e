"""Model FLOPs of the window's bf16 training steps, each part at the peak
of the precision it runs in (``_bf16.step_flops``: the trunk's
convolutions at the dense bf16 peak, the rest at the float32 peak, TF32
off): the least time the steps need over the traced window, in %."""

from portbench.metrics import _bf16, _work

MERGE = "mean"


def read(run):
    if run.trace is None:
        return None
    split = _bf16.step_flops(run.model, run.work["batch"])
    need = (split["bf16"] / _bf16.FLOPS_BF16
            + split["f32"] / _work.PEAKS["flops_f32"])
    return 100.0 * run.work["steps"] * need / run.world / run.trace.window_s
