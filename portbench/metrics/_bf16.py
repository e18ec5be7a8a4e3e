"""The work of a training step whose trunk computes in bf16, split by the
precision each part runs in, and the card's dense bf16 peak.

The trunk's convolutions (the encoder's: forward, input gradient but the
stem's, weight gradient) run on cuDNN's bf16 tensor cores with f32
accumulation; the rest of what ``_work.train_step_flops`` counts (the
stills' resizes, the render's poses and grids, the heads forward and
backward, the offsets' upsample and its gradient) runs in float32.
"""

from __future__ import annotations

from portbench.metrics import _work

# NVIDIA H100 SXM data sheet: 1,979 TFLOP/s of bf16 with sparsity; the
# dense rate is half of it, at the 700 W power limit.
FLOPS_BF16 = 989e12


def step_flops(model: dict, batch: int, steps_per_clip: int = 2,
               octaves=(4, 8, 16, 64)) -> dict:
    """{"bf16": the trunk's convolutions, "f32": the rest} of one step of
    ``batch`` clips of window + steps_per_clip - 1 frames."""
    mh, mw = model["model_size"]
    gh, gw = model["grid_size"]
    c = model["channels"]
    s = steps_per_clip
    clip = model["window"] + s - 1
    convs, feats = _work._encoder_convs(model)
    enc = sum(_work._conv(cv) for cv in convs)
    heads = sum(_work._conv(cv) for cv in _work._head_convs(model, feats))
    stills = sum(_work.resize_flops(batch, r, r, mh, mw, c) for r in octaves)
    render = (2 * 27 * batch * s + 2 * 9 * gh * gw * batch * s
              + 2 * 9 * mh * mw * batch * (clip + s))
    upsample = _work.resize_flops(batch * s, gh, gw, mh, mw, 2)
    return {"bf16": batch * clip * (3 * enc - _work._conv(convs[0])),
            "f32": stills + render + 3 * batch * s * heads + 2 * upsample}
