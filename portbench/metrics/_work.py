"""Operations and bytes of the port's work, from its shapes alone.

FLOPs count what ``torch.utils.flop_counter.FlopCounterMode`` counts:
convolutions (forward, and in training the input and weight gradients)
and matrix products, at 2 per multiply-add; elementwise work, norms,
activations, the correlation volume and the warps are not counted. Bytes
count each input a kernel reads once and each output it writes once.

``model`` is the configuration file's ``model`` dict.
"""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(__file__), "_peaks.json")) as _f:
    PEAKS = json.load(_f)


def _same_out(n: int, s: int) -> int:
    return -(-n // s)


def _encoder_convs(model: dict):
    """(cin, cout, k, h_out, w_out) of each encoder conv, in order."""
    mh, mw = model["model_size"]
    gh, gw = model["grid_size"]
    feats = model["base_features"]
    convs = [(model["channels"], feats, 7, mh, mw)]
    h, w = mh, mw
    while (h, w) != (gh, gw):
        nxt = min(feats * 2, 256)
        h, w = _same_out(h, 2), _same_out(w, 2)
        convs.append((feats, nxt, 3, h, w))
        convs += [(nxt, nxt, 3, h, w)] * (2 * model["blocks_per_level"])
        feats = nxt
    return convs, feats


def _head_convs(model: dict, feats: int):
    gh, gw = model["grid_size"]
    n_corr = (model["window"] - 1) * (2 * model["corr_radius"] + 1) ** 2
    return [(n_corr + feats, 128, 3, gh, gw), (128, 128, 3, gh, gw),
            (128, 2, 3, gh, gw)]


def _conv(c):
    cin, cout, k, h, w = c
    return 2 * cin * cout * k * k * h * w


def encoder_flops(model: dict, frames: int) -> int:
    return frames * sum(_conv(c) for c in _encoder_convs(model)[0])


def head_flops(model: dict, windows: int) -> int:
    feats = _encoder_convs(model)[1]
    return windows * sum(_conv(c) for c in _head_convs(model, feats))


def resize_flops(frames: int, h: int, w: int, oh: int, ow: int,
                 c: int) -> int:
    """The two matrix products of a separable resize, rows first."""
    return frames * (2 * oh * h * w * c + 2 * ow * w * oh * c)


def chunk_flops(model: dict, t: int, h: int, w: int) -> int:
    """One stabilized chunk of ``t`` frames of h x w: the resize to the
    model's input, the encoder over the t + N - 1 frames of the sequence,
    the head over the t windows, the offsets' upsample to the frame."""
    mh, mw = model["model_size"]
    gh, gw = model["grid_size"]
    return (resize_flops(t, h, w, mh, mw, model["channels"])
            + encoder_flops(model, t + model["window"] - 1)
            + head_flops(model, t)
            + resize_flops(t, gh, gw, h, w, 2))


def train_step_flops(model: dict, batch: int, steps_per_clip: int = 2,
                     octaves=(4, 8, 16, 64)) -> int:
    """One training step of ``batch`` clips of window + steps_per_clip - 1
    frames: drawing the stills, rendering the clips, the loss forward,
    its backward (every conv's weight gradient, and its input gradient
    where the input needs one: not the stem's), the offsets' upsample and
    its gradient."""
    mh, mw = model["model_size"]
    gh, gw = model["grid_size"]
    c = model["channels"]
    n = model["window"]
    s = steps_per_clip
    clip = n + s - 1
    convs, feats = _encoder_convs(model)
    heads = _head_convs(model, feats)
    stills = sum(resize_flops(batch, r, r, mh, mw, c) for r in octaves)
    render = (2 * 27 * batch * s                      # the target poses
              + 2 * 9 * gh * gw * batch * s           # the target offsets
              + 2 * 9 * mh * mw * batch * (clip + s))  # the warp grids
    enc = sum(_conv(cv) for cv in convs)
    fwd = batch * clip * enc + batch * s * sum(_conv(cv) for cv in heads)
    bwd = (batch * clip * (2 * enc - _conv(convs[0]))
           + 2 * batch * s * sum(_conv(cv) for cv in heads))
    upsample = resize_flops(batch * s, gh, gw, mh, mw, 2)
    return stills + render + fwd + bwd + 2 * upsample


def b1_bytes(b: int, h: int, w: int, c: int, gh: int, gw: int) -> int:
    """The uint8 offsets warp as a function: frames in, their coarse
    (b, gh, gw, 2) f32 offsets in, frames out."""
    return 2 * b * h * w * c + 4 * b * gh * gw * 2


def warp_f32_bytes(b: int, h: int, w: int, c: int, ho: int, wo: int) -> int:
    """The f32 warp (the render's, and the loss warp's forward): frames and
    grids in, frames out."""
    return 4 * (b * h * w * c + b * ho * wo * 2 + b * ho * wo * c)


def warp_grad_bytes(b: int, h: int, w: int, c: int, ho: int, wo: int
                    ) -> int:
    """The loss warp's backward: the output's gradient, the frames and the
    grids in, the grids' gradient out."""
    return 4 * (b * ho * wo * c + b * h * w * c + 2 * b * ho * wo * 2)


def train_warp_bytes(model: dict, batch: int, steps_per_clip: int = 2
                     ) -> int:
    """Bytes of one training step's three warps: the render's over every
    clip frame and target, the loss warp's forward and backward over the
    batch's last frames."""
    mh, mw = model["model_size"]
    c = model["channels"]
    s = steps_per_clip
    clip = model["window"] + s - 1
    return (warp_f32_bytes(batch * (clip + s), mh, mw, c, mh, mw)
            + warp_f32_bytes(batch * s, mh, mw, c, mh, mw)
            + warp_grad_bytes(batch * s, mh, mw, c, mh, mw))
