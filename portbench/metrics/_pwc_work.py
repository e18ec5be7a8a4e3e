"""Operations and bytes of a stabilized chunk with the ``pwc`` arch
(PWC-Net as the motion estimator, ``reference/pwc.py``), from its shapes
alone, as ``_work.py`` counts the corr arch's.

FLOPs are what ``FlopCounterMode`` counts: convolutions (a transposed one
at its input's size) and matrix products at 2 per multiply-add. The cost
volumes' and the feature warps' bytes are their function's: each input
read once, each output written once, in float32.

``model`` is the configuration file's ``model`` dict.
"""

from __future__ import annotations

from portbench.metrics import _work

WIDTHS = (16, 32, 64, 96, 128, 196)
DENSE = (128, 128, 96, 64, 32)
CONTEXT = (128, 128, 128, 96, 64, 32)
HEAD_LEVEL = 4


def _size(model: dict, level: int) -> tuple:
    mh, mw = model["model_size"]
    return mh >> level, mw >> level


def encoder_flops(model: dict, frames: int) -> int:
    """The six-level pyramid of ``frames`` frames."""
    total, cin = 0, model["channels"]
    for level, width in enumerate(WIDTHS, 1):
        h, w = _size(model, level)
        total += 2 * 9 * h * w * width * (cin + 2 * width)
        cin = width
    return frames * total


def decoder_flops(model: dict, pairs: int) -> int:
    """The estimators of levels 6..2 and the context network, per pair:
    the dense convs, the flow's prediction, the two transposed convs above
    level 2 (at their input's size)."""
    nd = (2 * model["corr_radius"] + 1) ** 2
    total = 0
    for level in range(6, 1, -1):
        h, w = _size(model, level)
        cin = nd if level == 6 else nd + WIDTHS[level - 1] + 4
        for width in DENSE:
            total += 2 * 9 * h * w * cin * width
            cin += width
        total += 2 * 9 * h * w * cin * 2
        if level > 2:
            total += 2 * 16 * h * w * (2 * 2 + cin * 2)
    h, w = _size(model, 2)
    for width in CONTEXT:
        total += 2 * 9 * h * w * cin * width
        cin = width
    total += 2 * 9 * h * w * cin * 2
    return pairs * total


def head_flops(model: dict, windows: int) -> int:
    gh, gw = model["grid_size"]
    cin = 2 * (model["window"] - 1) + WIDTHS[HEAD_LEVEL - 1]
    return windows * 2 * 9 * gh * gw * (cin * 128 + 128 * 128 + 128 * 2)


def chunk_flops(model: dict, t: int, h: int, w: int) -> int:
    """One stabilized chunk of ``t`` frames of h x w: the resize to the
    model's input, the pyramid of the t + N - 1 frames of the sequence,
    the decoder over the t (N - 1) pairs of the t windows, the head over
    the t windows, the offsets' upsample to the frame."""
    mh, mw = model["model_size"]
    gh, gw = model["grid_size"]
    n = model["window"]
    return (_work.resize_flops(t, h, w, mh, mw, model["channels"])
            + encoder_flops(model, t + n - 1)
            + decoder_flops(model, t * (n - 1))
            + head_flops(model, t)
            + _work.resize_flops(t, gh, gw, h, w, 2))


def corr_bytes(model: dict, pairs: int) -> int:
    """The cost volumes of levels 6..2: both levels' features in, the
    (2r + 1)^2-channel volume out, per pair."""
    nd = (2 * model["corr_radius"] + 1) ** 2
    return pairs * sum(4 * _size(model, lv)[0] * _size(model, lv)[1]
                       * (2 * WIDTHS[lv - 1] + nd) for lv in range(2, 7))


def warp_bytes(model: dict, pairs: int) -> int:
    """The feature warps of levels 5..2: the features and the 2-channel
    flow in, the warped features out, per pair."""
    return pairs * sum(4 * _size(model, lv)[0] * _size(model, lv)[1]
                       * (2 * WIDTHS[lv - 1] + 2) for lv in range(2, 6))
