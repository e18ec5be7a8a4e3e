"""Model FLOPs of the window's training steps (draws, render, loss
forward and backward at the global batch: ``_work.train_step_flops``)
over the traced window and the float32 peak of every card of the cell
(TF32 is off), in %."""

from portbench.metrics import _work

MERGE = "mean"


def read(run):
    if run.trace is None:
        return None
    flops = run.work["steps"] * _work.train_step_flops(run.model,
                                                       run.work["batch"])
    peak = _work.PEAKS["flops_f32"] * run.world
    return 100.0 * flops / run.trace.window_s / peak
