"""Model FLOPs of the window's chunks with the pwc arch (resize, pyramid,
PWC-Net's decoder, head, offsets' upsample: ``_pwc_work.chunk_flops``)
over the traced window and the card's float32 peak (TF32 is off), in %."""

from portbench.metrics import _pwc_work, _work

MERGE = "mean"


def read(run):
    if run.trace is None or run.model.get("arch") != "pwc":
        return None
    w = run.work
    flops = w["chunks"] * _pwc_work.chunk_flops(run.model, w["chunk_frames"],
                                                w["height"], w["width"])
    return 100.0 * flops / run.trace.window_s / _work.PEAKS["flops_f32"]
