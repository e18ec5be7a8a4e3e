"""Model FLOPs of the window's chunks (resize, encoder, head, offsets'
upsample: ``_work.chunk_flops``) over the traced window and the card's
float32 peak (TF32 is off), in %."""

from portbench.metrics import _work

MERGE = "mean"


def read(run):
    if run.trace is None:
        return None
    w = run.work
    flops = w["chunks"] * _work.chunk_flops(run.model, w["chunk_frames"],
                                            w["height"], w["width"])
    return 100.0 * flops / run.trace.window_s / _work.PEAKS["flops_f32"]
